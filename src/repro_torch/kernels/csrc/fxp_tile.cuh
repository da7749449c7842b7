// The integer tile loop shared by fxp_qmatmul and fxp_layer's wide route
// (N > 32, or a K x N whose weights do not fit the narrow kernel's shared
// memory; fxp_layer.cu).
//
// One block of kTileThreads threads owns a kBM x kBN output tile of A @ B
// and walks K in kBK-wide steps, staging both operand tiles through shared
// memory as int32 (zero-filled past the ragged M, N and K edges).  Thread t
// computes column t % kBN for the kTM rows (t / kBN) * kTM ... + kTM - 1,
// with one uint32_t accumulator per row that wraps at 32 bits, as the TPU
// kernels' int32 accumulator does.  This replaces the sequential K grid axis
// of the Pallas kernels, whose accumulator lives in VMEM scratch.  B is a
// (K, N) row-major matrix; both operand loads are coalesced along the
// stored rows.
#pragma once

#include "fxp_common.cuh"

namespace fxp {

constexpr int kBM = 32, kBN = 32, kBK = 32, kTM = 4, kTileThreads = 256;
static_assert(kTileThreads == kBN * (kBM / kTM),
              "one thread per (row group, column)");

struct TileSmem {
  int32_t a[kBM][kBK + 1];
  int32_t b[kBK][kBN + 1];
};

// acc[t] = sum_k A[row0 + (tid / kBN) * kTM + t][k] * B[k][col0 + tid % kBN]
// modulo 2^32.  Every thread of the block must call it (it synchronizes).
template <typename T>
__device__ __forceinline__ void tile_dot(const T* __restrict__ a,
                                         const T* __restrict__ b, int M, int K,
                                         int N, int row0, int col0,
                                         TileSmem& s, uint32_t (&acc)[kTM]) {
  const int tid = threadIdx.x;
  const int col = tid % kBN;
  const int rg = tid / kBN;
#pragma unroll
  for (int t = 0; t < kTM; ++t) acc[t] = 0u;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kTileThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gr = row0 + r, gc = k0 + c;
      s.a[r][c] = (gr < M && gc < K) ? (int32_t)a[(size_t)gr * K + gc] : 0;
    }
    for (int i = tid; i < kBK * kBN; i += kTileThreads) {
      const int kk = i / kBN, n = i % kBN;  // neighbouring threads walk n
      const int gk = k0 + kk, gn = col0 + n;
      s.b[kk][n] = (gk < K && gn < N) ? (int32_t)b[(size_t)gk * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const uint32_t bv = (uint32_t)s.b[kk][col];
#pragma unroll
      for (int t = 0; t < kTM; ++t)
        acc[t] += (uint32_t)s.a[rg * kTM + t][kk] * bv;  // wraps mod 2^32
    }
    __syncthreads();
  }
}

}  // namespace fxp
