// fxp_mlp_model: the whole fixed-point MLP forward pass in one launch.
//
// Replaces the Pallas megakernel
// repro/kernels/fxp_model.py::fxp_mlp_model_pallas (body _mlp_kernel).  The
// TPU kernel grids over batch blocks with every layer's weights resident in
// VMEM.  A Hopper block has 227 KB of shared memory, not megabytes, so here
// the activations, not the weights, live in shared memory: each block owns
// kBM batch rows, stages them once, and ping-pongs them between two
// shared-memory buffers in the container type while it runs every layer.
// Weights are read from global memory; they are KB-scale and stay resident
// in L1/L2 across the blocks.  Per layer and per output, the int32
// accumulator wraps at 32 bits (uint32_t arithmetic) and the shared epilogue
// (fxp_common.cuh) requantizes, adds the bias, applies the activation and
// narrows to the container.  The per-layer schedule travels by value as a
// struct array in the kernel parameters.  Rows past the ragged batch edge
// compute on zeros and are never stored.
//
// Bound on the H100: integer multiply-adds on the CUDA cores for the 16- and
// 32-bit containers (no integer tensor-core path for them).  Each thread
// computes kTM rows of one output column so one weight load feeds kTM
// multiply-adds; the activations are shared-memory broadcasts.  Simple and
// exact first: no tensor cores for 8-bit, no cp.async staging.
#include "fxp_common.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kBM = 32, kTM = 4, kThreads = 256;

struct MlpParams {
  const void* w[kMaxLayers];  // (K_l, K_{l+1}) row-major
  const void* b[kMaxLayers];  // (K_{l+1},)
  int dims[kMaxLayers + 1];
  int n_layers;
  int stride;  // row stride of the shared-memory buffers: the widest layer
  fxp::Epilogue epi[kMaxLayers];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fxp_mlp_model_kernel(const T* __restrict__ x, T* __restrict__ out, int M,
                     const MlpParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* hin = reinterpret_cast<T*>(smem);
  T* hout = hin + kBM * p.stride;
  const int row0 = blockIdx.x * kBM;
  const int rows = min(kBM, M - row0);

  const int k0 = p.dims[0];
  for (int i = threadIdx.x; i < kBM * k0; i += kThreads) {
    const int r = i / k0, c = i - r * k0;
    hin[r * p.stride + c] = (r < rows) ? x[(size_t)(row0 + r) * k0 + c] : T(0);
  }
  __syncthreads();

  for (int l = 0; l < p.n_layers; ++l) {
    const int K = p.dims[l], N = p.dims[l + 1];
    const T* __restrict__ W = static_cast<const T*>(p.w[l]);
    const T* __restrict__ B = static_cast<const T*>(p.b[l]);
    const fxp::Epilogue& e = p.epi[l];
    const bool last = l == p.n_layers - 1;
    for (int item = threadIdx.x; item < (kBM / kTM) * N; item += kThreads) {
      const int g = item / N, n = item - g * N;
      const T* h = hin + g * kTM * p.stride;
      uint32_t acc[kTM];
#pragma unroll
      for (int t = 0; t < kTM; ++t) acc[t] = 0u;
      for (int k = 0; k < K; ++k) {
        const uint32_t w = (uint32_t)(int32_t)W[(size_t)k * N + n];
#pragma unroll
        for (int t = 0; t < kTM; ++t)
          acc[t] += (uint32_t)(int32_t)h[t * p.stride + k] * w;  // mod 2^32
      }
      const int32_t bias = (int32_t)B[n];
#pragma unroll
      for (int t = 0; t < kTM; ++t) {
        const int r = g * kTM + t;
        const T v = (T)fxp::layer_epilogue(acc[t], bias, e);
        if (!last) {
          hout[r * p.stride + n] = v;
        } else if (r < rows) {
          out[(size_t)(row0 + r) * N + n] = v;
        }
      }
    }
    __syncthreads();  // layer l+1 reads every column layer l wrote
    T* tmp = hin;
    hin = hout;
    hout = tmp;
  }
}

template <typename T>
int launch(const void* x, void* out, int M, const MlpParams& p,
           cudaStream_t stream) {
  const size_t smem = 2 * (size_t)kBM * p.stride * sizeof(T);
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
  if (M <= 0 || n_layers < 1 || n_layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  MlpParams p;
  p.n_layers = n_layers;
  p.stride = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] <= 0) return (int)cudaErrorInvalidValue;
    p.dims[l] = dims[l];
    p.stride = dims[l] > p.stride ? dims[l] : p.stride;
  }
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

