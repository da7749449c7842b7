// fxp_mlp_model: the whole fixed-point MLP forward pass in one launch.
//
// Replaces the Pallas megakernel
// repro/kernels/fxp_model.py::fxp_mlp_model_pallas (body _mlp_kernel).  The
// TPU kernel grids over batch blocks with every layer's weights resident in
// VMEM.  A Hopper block has 227 KB of shared memory, not megabytes, so here
// the activations, not the weights, live in shared memory: each block owns
// kBM batch rows and runs every layer on them (fxp_mlp_body.cuh, shared with
// the fleet kernel).  The per-layer schedule travels by value as a struct
// array in the kernel parameters.
//
// Bound on the H100: integer multiply-adds on the CUDA cores for the 16- and
// 32-bit containers (no integer tensor-core path for them).  Each thread
// computes kTM rows of one output column so one weight load feeds kTM
// multiply-adds; the activations are shared-memory broadcasts.  Simple and
// exact first: no tensor cores for 8-bit, no cp.async staging.
#include "fxp_mlp_body.cuh"

namespace {

constexpr int kMaxLayers = fxp::kMlpMaxLayers;
constexpr int kBM = fxp::kMlpBM, kThreads = fxp::kMlpThreads;

struct MlpParams {
  const void* w[kMaxLayers];  // (K_l, K_{l+1}) row-major
  const void* b[kMaxLayers];  // (K_{l+1},)
  fxp::MlpShape shape;
  fxp::Epilogue epi[kMaxLayers];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fxp_mlp_model_kernel(const T* __restrict__ x, T* __restrict__ out, int M,
                     const MlpParams p) {
  fxp::mlp_block<T>(
      x, out, M, blockIdx.x * kBM, p.shape,
      [&](int l) {
        return fxp::MlpLayer<T>{static_cast<const T*>(p.w[l]),
                                static_cast<const T*>(p.b[l])};
      },
      [&](int l) { return p.epi[l]; });
}

template <typename T>
int launch(const void* x, void* out, int M, const MlpParams& p,
           cudaStream_t stream) {
  const size_t smem = fxp::mlp_smem_bytes<T>(p.shape);
  auto kernel = fxp_mlp_model_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (M + kBM - 1) / kBM;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                           static_cast<T*>(out), M, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, dims[0]); ws[l]: (dims[l], dims[l+1]); bs[l]: (dims[l+1],);
// out: (M, dims[n_layers]); every tensor contiguous in the `bits`-wide
// container.  `epis` holds n_layers rows of fxp::kEpilogueFields int64
// values.  Launches on the calling thread's current device.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int fxp_mlp_model_launch(const void* x, void* out, int M,
                                    int n_layers, const int* dims,
                                    const void* const* ws,
                                    const void* const* bs,
                                    const long long* epis, int bits,
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
    case 8: return launch<int8_t>(x, out, M, p, s);
    case 16: return launch<int16_t>(x, out, M, p, s);
    case 32: return launch<int32_t>(x, out, M, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
