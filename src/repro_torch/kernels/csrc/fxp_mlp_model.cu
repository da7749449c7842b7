// fxp_mlp_model: the whole fixed-point MLP forward pass in one launch.
//
// Replaces the Pallas megakernel
// repro/kernels/fxp_model.py::fxp_mlp_model_pallas (body _mlp_kernel).  The
// TPU kernel grids over batch blocks with every layer's weights resident in
// VMEM and runs each layer's int32 dot on the MXU.  Here a block runs every
// layer on its batch rows (fxp_mlp_body.cuh, shared with the fleet kernel);
// the per-layer schedule travels by value in the kernel parameters.
//
// Bound on the H100 and what the design does about it:
// * 8- and 16-bit containers: the int8 tensor cores (mma.sync.m16n8k32),
//   16-bit operands split into a signed high and an unsigned low byte, four
//   MMAs recombined exactly mod 2^32.  At 4 int8 MMAs per 16-bit product
//   the dot of 561->64->6 at 3089 rows needs ~0.45 us at 1,979 Top/s, its
//   input ~1.04 us at 3.35 TB/s: bytes-bound on paper; on the card the
//   layer epilogue and mma.sync's int8 rate come first (PERF.md).
//   Persistent blocks of up to three warp groups stage the weights once,
//   walk 16-row tiles (194 at 3089 rows, spread over all 132 SMs) and copy
//   the next tile with cp.async while the current one runs its layers.
// * 32-bit container: int32 multiply-adds on the CUDA cores (the first
//   port's body), one block per 32 rows (16 or 64: the tuner's choice).
// The block-size tuner (kernels/tune.py) passes `bm`: at 8 and 16 bits the
// rows of a block's warp groups (16, 32 or 48: a cap of 1, 2 or 3 groups
// on mlp_plan, which must lay out that many), at 32 bits the instance's
// rows; 0 is today's rule (as many groups as fit; 32 rows).
#include "fxp_mlp_body.cuh"

namespace {

constexpr int kMaxLayers = fxp::kMlpMaxLayers;
constexpr int kThreads = fxp::kMlpThreads;

struct MlpParams {
  const void* w[kMaxLayers];  // (K_l, K_{l+1}) row-major
  const void* b[kMaxLayers];  // (K_{l+1},)
  fxp::MlpShape shape;
  fxp::MlpPlan plan;  // tensor-core body only
  fxp::Epilogue epi[kMaxLayers];
};

template <typename T>
__device__ __forceinline__ fxp::MlpLayer<T> layer_of(const MlpParams& p,
                                                     int l) {
  return fxp::MlpLayer<T>{static_cast<const T*>(p.w[l]),
                          static_cast<const T*>(p.b[l])};
}

template <typename T>
__global__ void __launch_bounds__(fxp::kMlpMaxGroups * kThreads)
fxp_mlp_model_mma_kernel(const T* __restrict__ x, T* __restrict__ out, int M,
                         const MlpParams p) {
  fxp::mlp_mma_block<T>(
      x, out, M, p.shape, p.plan, blockIdx.x, gridDim.x,
      [&](int l) { return layer_of<T>(p, l); },
      [&](int l) { return p.epi[l]; });
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
fxp_mlp_model_cuda_core_kernel(const int32_t* __restrict__ x,
                               int32_t* __restrict__ out, int M,
                               const MlpParams p) {
  fxp::mlp_block_cuda_cores<int32_t, BM>(
      x, out, M, blockIdx.x * BM, p.shape,
      [&](int l) { return layer_of<int32_t>(p, l); },
      [&](int l) { return p.epi[l]; });
}

// bm: 0, or 16 x the warp groups of a block, which the plan must lay out.
template <typename T>
int launch_mma(const void* x, void* out, int M, MlpParams& p, int bm,
               cudaStream_t stream) {
  const int cap = bm / fxp::kMmaBM;
  if (bm % fxp::kMmaBM || cap < 0 || cap > fxp::kMlpMaxGroups ||
      !fxp::mlp_plan(p.shape, (int)sizeof(T), &p.plan,
                     cap ? cap : fxp::kMlpMaxGroups) ||
      (cap && p.plan.groups != cap))
    return (int)cudaErrorInvalidValue;
  auto kernel = fxp_mlp_model_mma_kernel<T>;
  const int threads = p.plan.groups * kThreads;
  int slots = 0;
  const cudaError_t err =
      fxp::launch_slots(kernel, threads, p.plan.total, &slots);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M + fxp::kMmaBM - 1) / fxp::kMmaBM;
  const int grid =
      fxp::mlp_blocks_per_model(tiles, slots, p.plan.groups, 1);
  kernel<<<grid, threads, p.plan.total, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), M, p);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_cuda_cores_bm(const void* x, void* out, int M, const MlpParams& p,
                         cudaStream_t stream) {
  const size_t smem = fxp::mlp_smem_bytes<int32_t>(p.shape, BM);
  cudaError_t err = cudaFuncSetAttribute(
      fxp_mlp_model_cuda_core_kernel<BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (M + BM - 1) / BM;
  fxp_mlp_model_cuda_core_kernel<BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), M, p);
  return (int)cudaGetLastError();
}

// bm: the rows of a block, 16, 32 or 64 (0: fxp::kMlpBM).
int launch_cuda_cores(const void* x, void* out, int M, const MlpParams& p,
                      int bm, cudaStream_t stream) {
  switch (bm == 0 ? fxp::kMlpBM : bm) {
    case 16: return launch_cuda_cores_bm<16>(x, out, M, p, stream);
    case 32: return launch_cuda_cores_bm<32>(x, out, M, p, stream);
    case 64: return launch_cuda_cores_bm<64>(x, out, M, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (M, dims[0]); ws[l]: (dims[l], dims[l+1]); bs[l]: (dims[l+1],);
// out: (M, dims[n_layers]); every tensor contiguous in the `bits`-wide
// container, x 16-byte aligned.  `epis` holds n_layers rows of
// fxp::kEpilogueFields int64 values; `bm` the tuner's block (see the top of
// this file; 0 today's).  Launches on the calling thread's current device.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int fxp_mlp_model_launch(const void* x, void* out, int M,
                                    int n_layers, const int* dims,
                                    const void* const* ws,
                                    const void* const* bs,
                                    const long long* epis, int bits, int bm,
                                    void* stream) {
  MlpParams p;
  if (M <= 0 || !fxp::mlp_shape_from(dims, n_layers, &p.shape))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_layers; ++l) {
    p.w[l] = ws[l];
    p.b[l] = bs[l];
    p.epi[l] = fxp::epilogue_from(epis + (size_t)l * fxp::kEpilogueFields);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8: return launch_mma<int8_t>(x, out, M, p, bm, s);
    case 16: return launch_mma<int16_t>(x, out, M, p, bm, s);
    case 32: return launch_cuda_cores(x, out, M, p, bm, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
