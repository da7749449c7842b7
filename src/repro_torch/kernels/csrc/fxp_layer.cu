// fxp_layer: the fused fixed-point layer act(qadd(requantize(A @ B), bias))
// in one launch.
//
// Replaces the Pallas kernel repro/kernels/fxp_layer.py::fxp_layer_pallas.
// That kernel walks a sequential K grid axis with an int32 accumulator held
// in VMEM; here each block owns one 32x32 output tile and walks K in a loop,
// staging 32x32 tiles of A and B through shared memory.  Each thread keeps
// four int32 accumulators (four rows of one column) in registers and wraps
// them at 32 bits through uint32_t, as the TPU's int32 accumulator does.
// The last step runs the shared epilogue (fxp_common.cuh) on the tile and
// stores it in the output container.  Ragged M, N and K edges are masked
// here (zero-filled loads, guarded stores), so the host pads nothing.
//
// Bound on the H100: integer multiply-adds on the CUDA cores (tensor-core
// integer MMA takes only 8-bit operands, and the 16- and 32-bit containers
// are the paper's formats); at the logistic shape (N = 6) the bytes of A
// dominate instead.  This first version is simple and exact: no
// double-buffering, no tensor cores, a 32-wide N tile even for N = 6.
#include "fxp_common.cuh"

namespace {

constexpr int kBM = 32, kBN = 32, kBK = 32, kTM = 4, kThreads = 256;
static_assert(kThreads == kBN * (kBM / kTM), "one thread per (row group, column)");

template <typename T>
__global__ void __launch_bounds__(kThreads)
fxp_layer_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const T* __restrict__ bias, T* __restrict__ out, int M, int K,
                 int N, const fxp::Epilogue e) {
  __shared__ int32_t As[kBM][kBK + 1];
  __shared__ int32_t Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int col = tid % kBN;
  const int rg = tid / kBN;  // warp w owns rows w*kTM .. w*kTM+3
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;

  uint32_t acc[kTM];
#pragma unroll
  for (int t = 0; t < kTM; ++t) acc[t] = 0u;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gr = row0 + r, gc = k0 + c;
      As[r][c] = (gr < M && gc < K) ? (int32_t)a[(size_t)gr * K + gc] : 0;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? (int32_t)b[(size_t)gr * N + gc] : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const uint32_t bv = (uint32_t)Bs[kk][col];
#pragma unroll
      for (int t = 0; t < kTM; ++t)
        acc[t] += (uint32_t)As[rg * kTM + t][kk] * bv;  // wraps mod 2^32
    }
    __syncthreads();
  }

  const int c = col0 + col;
  if (c >= N) return;
  const int32_t bb = (int32_t)bias[c];
#pragma unroll
  for (int t = 0; t < kTM; ++t) {
    const int r = row0 + rg * kTM + t;
    if (r < M) out[(size_t)r * N + c] = (T)fxp::layer_epilogue(acc[t], bb, e);
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* bias, void* out, int M,
           int K, int N, const fxp::Epilogue& e, cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  fxp_layer_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(bias), static_cast<T*>(out), M, K, N, e);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (M, K), b: (K, N), bias: (N,), out: (M, N), all contiguous in the
// `bits`-wide container; `epi` holds fxp::kEpilogueFields int64 values.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int fxp_layer_launch(const void* a, const void* b, const void* bias,
                                void* out, int M, int K, int N, int bits,
                                const long long* epi, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const fxp::Epilogue e = fxp::epilogue_from(epi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8: return launch<int8_t>(a, b, bias, out, M, K, N, e, s);
    case 16: return launch<int16_t>(a, b, bias, out, M, K, N, e, s);
    case 32: return launch<int32_t>(a, b, bias, out, M, K, N, e, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
