// fxp_mlp_fleet: E stacked fixed-point MLPs, every layer, in one launch.
//
// Replaces the Pallas kernel
// repro/kernels/fxp_model.py::fxp_mlp_fleet_pallas (body _mlp_fleet_kernel),
// which grids over (model blocks, batch blocks): with one shared schedule it
// batches the MXU dot over the model axis, and with per-model schedules (a
// calibrated fleet) it takes one model per grid step and picks the model's
// static branch with lax.switch.
//
// Here the grid is (blocks per model, E) and blockIdx.y picks the model.
// Each block runs exactly the single-model megakernel's body
// (fxp_mlp_body.cuh) on its model's slices of the stacked operands, so slot
// e equals model e's own fxp_mlp_model launch bit for bit and models never
// mix.  The schedules are data, not code: the per-model epilogue rows sit in
// an (E, L, kEpilogueFields) int64 table in device memory (an E x L table of
// Epilogues would outgrow the kernel parameters), and the body reads its
// model's row at run time.  Heterogeneous schedules therefore cost nothing.
// Shared memory per block is the single model's, independent of E.
//
// Bound on the H100: as for the single model (bytes on paper; the layer
// epilogue and mma.sync's int8 rate on the card).  8- and 16-bit
// containers run on the int8 tensor cores (16-bit operands split into high
// and low bytes, four MMAs recombined exactly mod 2^32); the card's block
// slots are shared out over the E models, and each persistent block stages
// its model's weights once and its warp groups walk that model's 16-row
// tiles.  Model e's
// input slice starts at e.M.K0 elements, which need not be 16-byte aligned
// (M 3089, K0 561 at 16 bits: 2e mod 16): the body copies each tile from
// the 16-byte boundary below it.  The 32-bit container keeps the CUDA-core
// body, one block per 32 rows per model.  `bm` picks the block as in
// fxp_mlp_model.cu (the tuner's choice; 0 today's rule); every model of
// the fleet runs it.
#include "fxp_mlp_body.cuh"

namespace {

constexpr int kMaxLayers = fxp::kMlpMaxLayers;
constexpr int kThreads = fxp::kMlpThreads;
constexpr int kMaxModels = 65535;  // gridDim.y

struct FleetParams {
  const void* w[kMaxLayers];  // (E, K_l, K_{l+1}) row-major
  const void* b[kMaxLayers];  // (E, K_{l+1})
  fxp::MlpShape shape;
  fxp::MlpPlan plan;  // tensor-core body only
};

// Model e's slices of the stacked operands and its schedule row.
template <typename T>
struct FleetModel {
  const FleetParams& p;
  const long long* __restrict__ epis;
  size_t e;

  __device__ __forceinline__ fxp::MlpLayer<T> operator()(int l) const {
    const size_t K = p.shape.dims[l], N = p.shape.dims[l + 1];
    return fxp::MlpLayer<T>{static_cast<const T*>(p.w[l]) + e * K * N,
                            static_cast<const T*>(p.b[l]) + e * N};
  }
  __device__ __forceinline__ fxp::Epilogue epilogue(int l) const {
    return fxp::epilogue_from(
        epis + (e * p.shape.n_layers + l) * fxp::kEpilogueFields);
  }
};

template <typename T>
__global__ void __launch_bounds__(fxp::kMlpMaxGroups * kThreads)
fxp_mlp_fleet_mma_kernel(const T* __restrict__ x, T* __restrict__ out, int M,
                         const FleetParams p,
                         const long long* __restrict__ epis) {
  const FleetModel<T> m{p, epis, blockIdx.y};
  const int L = p.shape.n_layers;
  fxp::mlp_mma_block<T>(
      x + m.e * M * (size_t)p.shape.dims[0],
      out + m.e * M * (size_t)p.shape.dims[L], M, p.shape, p.plan,
      blockIdx.x, gridDim.x, m, [&](int l) { return m.epilogue(l); });
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
fxp_mlp_fleet_cuda_core_kernel(const int32_t* __restrict__ x,
                               int32_t* __restrict__ out, int M,
                               const FleetParams p,
                               const long long* __restrict__ epis) {
  const FleetModel<int32_t> m{p, epis, blockIdx.y};
  const int L = p.shape.n_layers;
  fxp::mlp_block_cuda_cores<int32_t, BM>(
      x + m.e * M * (size_t)p.shape.dims[0],
      out + m.e * M * (size_t)p.shape.dims[L], M, blockIdx.x * BM,
      p.shape, m, [&](int l) { return m.epilogue(l); });
}

// bm: 0, or 16 x the warp groups of a block, which the plan must lay out.
template <typename T>
int launch_mma(const void* x, void* out, int M, int E, FleetParams& p,
               const long long* epis, int bm, cudaStream_t stream) {
  const int cap = bm / fxp::kMmaBM;
  if (bm % fxp::kMmaBM || cap < 0 || cap > fxp::kMlpMaxGroups ||
      !fxp::mlp_plan(p.shape, (int)sizeof(T), &p.plan,
                     cap ? cap : fxp::kMlpMaxGroups) ||
      (cap && p.plan.groups != cap))
    return (int)cudaErrorInvalidValue;
  auto kernel = fxp_mlp_fleet_mma_kernel<T>;
  const int threads = p.plan.groups * kThreads;
  int slots = 0;
  const cudaError_t err =
      fxp::launch_slots(kernel, threads, p.plan.total, &slots);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M + fxp::kMmaBM - 1) / fxp::kMmaBM;
  const dim3 grid(
      fxp::mlp_blocks_per_model(tiles, slots, p.plan.groups, E), E);
  kernel<<<grid, threads, p.plan.total, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), M, p, epis);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_cuda_cores_bm(const void* x, void* out, int M, int E,
                         const FleetParams& p, const long long* epis,
                         cudaStream_t stream) {
  const size_t smem = fxp::mlp_smem_bytes<int32_t>(p.shape, BM);
  cudaError_t err = cudaFuncSetAttribute(
      fxp_mlp_fleet_cuda_core_kernel<BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, E);
  fxp_mlp_fleet_cuda_core_kernel<BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), M, p, epis);
  return (int)cudaGetLastError();
}

// bm: the rows of a block, 16, 32 or 64 (0: fxp::kMlpBM).
int launch_cuda_cores(const void* x, void* out, int M, int E,
                      const FleetParams& p, const long long* epis, int bm,
                      cudaStream_t stream) {
  switch (bm == 0 ? fxp::kMlpBM : bm) {
    case 16: return launch_cuda_cores_bm<16>(x, out, M, E, p, epis, stream);
    case 32: return launch_cuda_cores_bm<32>(x, out, M, E, p, epis, stream);
    case 64: return launch_cuda_cores_bm<64>(x, out, M, E, p, epis, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (E, M, dims[0]); ws[l]: (E, dims[l], dims[l+1]); bs[l]: (E, dims[l+1]);
// out: (E, M, dims[n_layers]); every tensor contiguous in the `bits`-wide
// container, x 16-byte aligned.  `epis` is a DEVICE pointer to E x n_layers
// rows of fxp::kEpilogueFields int64 values (model-major); `bm` the
// tuner's block (0 today's).  Launches on the calling thread's current
// device.  Returns the CUDA error code of the launch (0 on success).
extern "C" int fxp_mlp_fleet_launch(const void* x, void* out, int M, int E,
                                    int n_layers, const int* dims,
                                    const void* const* ws,
                                    const void* const* bs,
                                    const long long* epis, int bits, int bm,
                                    void* stream) {
  FleetParams p;
  if (M <= 0 || E <= 0 || E > kMaxModels ||
      !fxp::mlp_shape_from(dims, n_layers, &p.shape))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_layers; ++l) {
    p.w[l] = ws[l];
    p.b[l] = bs[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8: return launch_mma<int8_t>(x, out, M, E, p, epis, bm, s);
    case 16: return launch_mma<int16_t>(x, out, M, E, p, epis, bm, s);
    case 32: return launch_cuda_cores(x, out, M, E, p, epis, bm, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
