// fxp_mlp_fleet: E stacked fixed-point MLPs, every layer, in one launch.
//
// Replaces the Pallas kernel
// repro/kernels/fxp_model.py::fxp_mlp_fleet_pallas (body _mlp_fleet_kernel),
// which grids over (model blocks, batch blocks): with one shared schedule it
// batches the MXU dot over the model axis, and with per-model schedules (a
// calibrated fleet) it takes one model per grid step and picks the model's
// static branch with lax.switch.
//
// Here the grid is (ceil(M / kBM), E) and blockIdx.y picks the model.  Each
// block runs exactly the single-model megakernel's body (fxp_mlp_body.cuh)
// on its model's slices of the stacked operands, so slot e equals model e's
// own fxp_mlp_model launch bit for bit and models never mix.  The schedules
// are data, not code: the per-model epilogue rows sit in an (E, L,
// kEpilogueFields) int64 table in device memory (an E x L table of
// Epilogues would outgrow the kernel parameters), and the body reads its
// model's row at run time.  Heterogeneous schedules therefore cost nothing,
// and no model-block restriction applies.  Shared memory per block is the
// single model's (two kBM x widest-layer buffers), independent of E.
//
// Bound on the H100: integer multiply-adds on the CUDA cores for the 16- and
// 32-bit containers, as for the single model; the E models give E times the
// blocks, which fills the card at batches where one model cannot.
#include "fxp_mlp_body.cuh"

namespace {

constexpr int kMaxLayers = fxp::kMlpMaxLayers;
constexpr int kBM = fxp::kMlpBM, kThreads = fxp::kMlpThreads;
constexpr int kMaxModels = 65535;  // gridDim.y

struct FleetParams {
  const void* w[kMaxLayers];  // (E, K_l, K_{l+1}) row-major
  const void* b[kMaxLayers];  // (E, K_{l+1})
  fxp::MlpShape shape;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fxp_mlp_fleet_kernel(const T* __restrict__ x, T* __restrict__ out, int M,
                     const FleetParams p,
                     const long long* __restrict__ epis) {
  const size_t e = blockIdx.y;
  const int L = p.shape.n_layers;
  const T* xe = x + e * M * (size_t)p.shape.dims[0];
  T* oute = out + e * M * (size_t)p.shape.dims[L];
  fxp::mlp_block<T>(
      xe, oute, M, blockIdx.x * kBM, p.shape,
      [&](int l) {
        const size_t K = p.shape.dims[l], N = p.shape.dims[l + 1];
        return fxp::MlpLayer<T>{static_cast<const T*>(p.w[l]) + e * K * N,
                                static_cast<const T*>(p.b[l]) + e * N};
      },
      [&](int l) {
        return fxp::epilogue_from(epis + (e * L + l) * fxp::kEpilogueFields);
      });
}

template <typename T>
int launch(const void* x, void* out, int M, int E, const FleetParams& p,
           const long long* epis, cudaStream_t stream) {
  const size_t smem = fxp::mlp_smem_bytes<T>(p.shape);
  auto kernel = fxp_mlp_fleet_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kBM - 1) / kBM, E);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                           static_cast<T*>(out), M, p, epis);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (E, M, dims[0]); ws[l]: (E, dims[l], dims[l+1]); bs[l]: (E, dims[l+1]);
// out: (E, M, dims[n_layers]); every tensor contiguous in the `bits`-wide
// container.  `epis` is a DEVICE pointer to E x n_layers rows of
// fxp::kEpilogueFields int64 values (model-major).  Launches on the calling
// thread's current device.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int fxp_mlp_fleet_launch(const void* x, void* out, int M, int E,
                                    int n_layers, const int* dims,
                                    const void* const* ws,
                                    const void* const* bs,
                                    const long long* epis, int bits,
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
    case 8: return launch<int8_t>(x, out, M, E, p, epis, s);
    case 16: return launch<int16_t>(x, out, M, E, p, epis, s);
    case 32: return launch<int32_t>(x, out, M, E, p, epis, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
