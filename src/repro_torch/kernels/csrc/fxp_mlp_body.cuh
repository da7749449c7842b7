// The body of the MLP megakernel: one block runs every layer of one model for
// kBM batch rows.  Shared by fxp_mlp_model.cu (one model, grid over batch
// blocks) and fxp_mlp_fleet.cu (E stacked models, grid over batch blocks x
// models), so that slot e of a fleet launch computes exactly what model e's
// own launch computes.
//
// The block stages its rows once and ping-pongs the activations between two
// shared-memory buffers in the container type while it runs every layer.
// Weights are read from global memory; they are KB-scale and stay resident
// in L1/L2 across the blocks.  Per layer and per output, the int32
// accumulator wraps at 32 bits (uint32_t arithmetic) and the shared epilogue
// (fxp_common.cuh) requantizes, adds the bias, applies the activation and
// narrows to the container.  Rows past the ragged batch edge compute on
// zeros and are never stored.  Each thread computes kTM rows of one output
// column so one weight load feeds kTM multiply-adds; the activations are
// shared-memory broadcasts.
#pragma once

#include "fxp_common.cuh"

namespace fxp {

constexpr int kMlpMaxLayers = 8;
constexpr int kMlpBM = 32, kMlpTM = 4, kMlpThreads = 256;

struct MlpShape {
  int dims[kMlpMaxLayers + 1];
  int n_layers;
  int stride;  // row stride of the shared-memory buffers: the widest layer
};

// One layer of the block's model: weights (K, N) row-major and bias (N,).
template <typename T>
struct MlpLayer {
  const T* w;
  const T* b;
};

// Shared memory one block needs: two kBM x stride buffers of T.
template <typename T>
inline size_t mlp_smem_bytes(const MlpShape& s) {
  return 2 * (size_t)kMlpBM * s.stride * sizeof(T);
}

// Fills the host-side shape from the layer widths; false if a width is not
// positive or the layer count is out of range.
inline bool mlp_shape_from(const int* dims, int n_layers, MlpShape* s) {
  if (n_layers < 1 || n_layers > kMlpMaxLayers) return false;
  s->n_layers = n_layers;
  s->stride = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] <= 0) return false;
    s->dims[l] = dims[l];
    s->stride = dims[l] > s->stride ? dims[l] : s->stride;
  }
  return true;
}

// x: (M, dims[0]) and out: (M, dims[n_layers]) of this block's model;
// layer(l) returns that model's MlpLayer<T> for layer l, epilogue(l) its
// Epilogue.  The epilogue is fetched after each output's dot product, not
// before, so that its 21 fields are not held in registers across the K
// loop (96 -> 74 registers in the single-model kernel).  The block owns
// rows row0 .. row0 + kMlpBM - 1.  Every thread of the block must call it.
template <typename T, typename LayerFn, typename EpilogueFn>
__device__ __forceinline__ void mlp_block(const T* __restrict__ x,
                                          T* __restrict__ out, int M,
                                          int row0, const MlpShape& s,
                                          LayerFn layer,
                                          EpilogueFn epilogue) {
  extern __shared__ __align__(16) unsigned char mlp_smem[];
  T* hin = reinterpret_cast<T*>(mlp_smem);
  T* hout = hin + kMlpBM * s.stride;
  const int rows = min(kMlpBM, M - row0);

  const int k0 = s.dims[0];
  for (int i = threadIdx.x; i < kMlpBM * k0; i += kMlpThreads) {
    const int r = i / k0, c = i - r * k0;
    hin[r * s.stride + c] =
        (r < rows) ? x[(size_t)(row0 + r) * k0 + c] : T(0);
  }
  __syncthreads();

  for (int l = 0; l < s.n_layers; ++l) {
    const int K = s.dims[l], N = s.dims[l + 1];
    const MlpLayer<T> L = layer(l);
    const T* __restrict__ W = L.w;
    const T* __restrict__ B = L.b;
    const bool last = l == s.n_layers - 1;
    for (int item = threadIdx.x; item < (kMlpBM / kMlpTM) * N;
         item += kMlpThreads) {
      const int g = item / N, n = item - g * N;
      const T* h = hin + g * kMlpTM * s.stride;
      uint32_t acc[kMlpTM];
#pragma unroll
      for (int t = 0; t < kMlpTM; ++t) acc[t] = 0u;
      for (int k = 0; k < K; ++k) {
        const uint32_t w = (uint32_t)(int32_t)W[(size_t)k * N + n];
#pragma unroll
        for (int t = 0; t < kMlpTM; ++t)
          acc[t] += (uint32_t)(int32_t)h[t * s.stride + k] * w;  // mod 2^32
      }
      const int32_t bias = (int32_t)B[n];
      // A compiler barrier: the epilogue's loads (a row of a device table in
      // the fleet kernel) stay here and are not hoisted out of the item
      // loop, where their 21 fields would be live across the K loop and
      // starve it of registers.
      asm volatile("" ::: "memory");
      const Epilogue e = epilogue(l);
#pragma unroll
      for (int t = 0; t < kMlpTM; ++t) {
        const int r = g * kMlpTM + t;
        const T v = (T)layer_epilogue(acc[t], bias, e);
        if (!last) {
          hout[r * s.stride + n] = v;
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

}  // namespace fxp
