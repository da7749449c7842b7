// The body of the kernel-SVM megakernel: one block computes the whole
// decision function of one model for kBM batch rows.  Shared by
// fxp_svm_model.cu (one model, grid over batch blocks) and fxp_svm_fleet.cu
// (E stacked models, grid over batch blocks x models), so that slot e of a
// fleet launch computes exactly what model e's own launch computes:
//
//   dot = requantize(x . sv^T, m)                      (int32 accumulator)
//   poly: k = qpow_int(qadd(qmul(dot, g), c0), degree)
//   rbf:  k = qexp(-qmul(qadd(qsub(|x|^2, 2 dot), |sv|^2), g))
//   out = qadd(requantize(k . dual, dec_shift), intercept)
//
// The kernel values, not the support vectors, live in shared memory: the
// block fills a (kBM, S) int32 tile of k, one kBN-column chunk of support
// vectors at a time through the tile loop shared with fxp_layer
// (fxp_tile.cuh, B read transposed from the (S, F) support-vector matrix).
// The squared norms of the rbf kernel are summed in int64 at every width
// (the reference's jnp.sum promotes), one warp per vector.  The decision
// stage then reads the k tile from shared memory and the duals through
// L1/L2, with an int32-wrapping accumulator and the shared epilogue.  Rows
// past the ragged batch edge compute on zeros and are never stored.
#pragma once

#include "fxp_tile.cuh"

namespace fxp {

constexpr int kSvmPoly = 0, kSvmRbf = 1;

struct SvmParams {
  Epilogue ek;  // kernel domain: fmt, shift = m
  Epilogue eo;  // decision: out_fmt, shift = dec_shift, no activation
  int kind, degree;
  int32_t qgamma, qcoef0;
};

// One model's row of the fleet's parameter table: the two epilogues, then
// degree, q(gamma) and q(coef0) (kernels/fxp_model.py::svm_fleet_table).
constexpr int kSvmFields = 2 * kEpilogueFields + 3;

FXP_HOST_DEVICE SvmParams svm_params_from(const long long* row, int kind) {
  SvmParams p;
  p.ek = epilogue_from(row);
  p.eo = epilogue_from(row + kEpilogueFields);
  p.kind = kind;
  p.degree = (int)row[2 * kEpilogueFields];
  p.qgamma = (int32_t)row[2 * kEpilogueFields + 1];
  p.qcoef0 = (int32_t)row[2 * kEpilogueFields + 2];
  return p;
}

// Dynamic shared memory of one block: the (kBM, S) kernel values and the
// S + kBM squared norms, int32.
inline size_t svm_smem_bytes(int S) {
  return ((size_t)kBM * S + S + kBM) * sizeof(int32_t);
}

// x: (M, F), sv: (S, F), dual: (S, C), icept: (C,), out: (M, C) of this
// block's model; the block owns rows row0 .. row0 + kBM - 1.  Every thread
// of the block must call it.
template <typename T>
__device__ __forceinline__ void svm_block(const T* __restrict__ x,
                                          const T* __restrict__ sv,
                                          const T* __restrict__ dual,
                                          const T* __restrict__ icept,
                                          T* __restrict__ out, int M, int F,
                                          int S, int C, int row0,
                                          const SvmParams& p) {
  extern __shared__ __align__(16) int32_t svm_smem[];
  int32_t* kv = svm_smem;        // (kBM, S) kernel values
  int32_t* sv2 = kv + kBM * S;   // (S,)   rbf: |sv|^2
  int32_t* x2 = sv2 + S;         // (kBM,) rbf: |x|^2
  __shared__ TileSmem s;
  const Epilogue& ek = p.ek;

  if (p.kind == kSvmRbf) {
    // One warp per vector (the block's rows, then every support vector);
    // lanes walk the features, the int64 sum wraps through unsigned math.
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (int v = warp; v < kBM + S; v += kTileThreads / 32) {
      const bool is_x = v < kBM;
      const int r = is_x ? row0 + v : v - kBM;
      unsigned long long acc = 0;
      if (!is_x || r < M) {
        const T* vec = (is_x ? x : sv) + (size_t)r * F;
        for (int k = lane; k < F; k += 32) {
          const int64_t q = (int64_t)vec[k];
          acc += (unsigned long long)(q * q);
        }
      }
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, o);
      if (lane == 0) (is_x ? x2[v] : sv2[r]) = sumsq_shift(acc, ek);
    }
    __syncthreads();
  }

  const int col = threadIdx.x % kBN, rg = threadIdx.x / kBN;
  for (int col0 = 0; col0 < S; col0 += kBN) {
    uint32_t acc[kTM];
    tile_dot<T, true>(x, sv, M, F, S, row0, col0, s, acc);
    const int j = col0 + col;
    if (j >= S) continue;
#pragma unroll
    for (int t = 0; t < kTM; ++t) {
      const int r = rg * kTM + t;
      const int32_t dot =
          requant((int64_t)u2s32(acc[t]), ek.shift, ek.qmin, ek.qmax);
      int32_t k;
      if (p.kind == kSvmPoly) {
        k = qpow_int(qadd(qmul(dot, p.qgamma, ek), p.qcoef0, ek), p.degree,
                     ek);
      } else {
        const int32_t d2 =
            qadd(qsub(x2[r], qadd(dot, dot, ek), ek), sv2[j], ek);
        k = qexp(qneg(qmul(d2, p.qgamma, ek), ek), ek);
      }
      kv[r * S + j] = k;
    }
  }
  __syncthreads();

  for (int item = threadIdx.x; item < kBM * C; item += kTileThreads) {
    const int r = item / C, c = item - r * C;
    if (row0 + r >= M) continue;
    const int32_t* krow = kv + r * S;
    uint32_t acc = 0u;
    for (int j = 0; j < S; ++j)
      acc += (uint32_t)krow[j] * (uint32_t)(int32_t)dual[(size_t)j * C + c];
    out[(size_t)(row0 + r) * C + c] =
        (T)layer_epilogue(acc, (int32_t)icept[c], p.eo);
  }
}

}  // namespace fxp
