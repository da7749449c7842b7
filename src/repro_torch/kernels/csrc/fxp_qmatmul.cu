// fxp_qmatmul: the fixed-point matmul rshift_round_saturate(A @ B, m) in one
// launch, the first stage of the kernel SVM's per-layer route.
//
// Replaces the Pallas kernel
// repro/kernels/fxp_qmatmul.py::fxp_qmatmul_pallas (body _kernel), whose
// grid walks K sequentially into an int32 VMEM accumulator.  Here each block
// owns one 32x32 output tile and runs the tile loop shared with fxp_layer
// (fxp_tile.cuh): operand tiles staged through shared memory, one uint32_t
// accumulator per output that wraps at 32 bits like the TPU's int32
// accumulator, then one rounded shift by m and saturation into the
// container.  Ragged M, N and K edges are masked here.
//
// Bound on the H100: integer multiply-adds on the CUDA cores at the SVM's
// shape ((M, 561) x (561, 300): 2*M*561*300 operations against
// (M*(561 + 300) + 561*300) container elements moved), since tensor-core
// integer MMA takes only 8-bit operands.  Simple and exact first: no
// double-buffering and no tensor cores for the 8-bit container.
#include "fxp_tile.cuh"

namespace {

using fxp::kBM;
using fxp::kBN;
using fxp::kTM;

template <typename T>
__global__ void __launch_bounds__(fxp::kTileThreads)
fxp_qmatmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   T* __restrict__ out, int M, int K, int N, int shift,
                   int32_t qmin, int32_t qmax) {
  __shared__ fxp::TileSmem s;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  uint32_t acc[kTM];
  fxp::tile_dot<T>(a, b, M, K, N, row0, col0, s, acc);

  const int c = col0 + threadIdx.x % kBN;
  if (c >= N) return;
  const int rg = threadIdx.x / kBN;
#pragma unroll
  for (int t = 0; t < kTM; ++t) {
    const int r = row0 + rg * kTM + t;
    if (r < M)
      out[(size_t)r * N + c] =
          (T)fxp::requant((int64_t)fxp::u2s32(acc[t]), shift, qmin, qmax);
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int M, int K, int N,
           int shift, int32_t qmin, int32_t qmax, cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  fxp_qmatmul_kernel<T><<<grid, fxp::kTileThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      M, K, N, shift, qmin, qmax);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (M, K), b: (K, N), out: (M, N), all contiguous in the `bits`-wide
// container; out = saturate(round_shift(a @ b, shift)) into
// [-2^(bits-1), 2^(bits-1) - 1].  Returns the CUDA error code of the launch.
extern "C" int fxp_qmatmul_launch(const void* a, const void* b, void* out,
                                  int M, int K, int N, int bits, int shift,
                                  void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || shift < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8: return launch<int8_t>(a, b, out, M, K, N, shift, -128, 127, s);
    case 16:
      return launch<int16_t>(a, b, out, M, K, N, shift, -32768, 32767, s);
    case 32:
      return launch<int32_t>(a, b, out, M, K, N, shift, INT32_MIN, INT32_MAX,
                             s);
    default: return (int)cudaErrorInvalidValue;
  }
}
