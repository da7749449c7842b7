// fxp_svm_model: the whole fixed-point kernel-SVM decision function in one
// launch.
//
// Replaces the Pallas megakernel
// repro/kernels/fxp_model.py::fxp_svm_model_pallas (body _svm_kernel, via
// _svm_forward), which keeps every support vector and dual coefficient
// resident in VMEM and computes, per batch block:
//
//   dot = requantize(x . sv^T, m)                      (int32 accumulator)
//   poly: k = qpow_int(qadd(qmul(dot, g), c0), degree)
//   rbf:  k = qexp(-qmul(qadd(qsub(|x|^2, 2 dot), |sv|^2), g))
//   out = qadd(requantize(k . dual, dec_shift), intercept)
//
// A Hopper block has 227 KB of shared memory, not VMEM's megabytes, so here
// the kernel values, not the support vectors, live in shared memory: each
// block owns kBM = 32 batch rows and fills a (32, S) int32 tile of k (38 KB
// at S = 300), one 32-column chunk of support vectors at a time through the
// tile loop shared with fxp_layer (fxp_tile.cuh, B read transposed from the
// (S, F) support-vector matrix).  The squared norms of the rbf kernel are
// summed in int64 at every width (the reference's jnp.sum promotes), one
// warp per vector.  The decision stage then reads the k tile from shared
// memory and the duals through L1/L2, with an int32-wrapping accumulator and
// the shared epilogue.  Support vectors and duals are KB-scale and stay in
// L2 across blocks.  Rows past the ragged batch edge compute on zeros and
// are never stored.
//
// Bound on the H100: integer multiply-adds on the CUDA cores for the 16- and
// 32-bit containers (2 * M * (F * S + S * C) operations); the 8-bit
// container's bound is set by bytes at the tensor cores' int8 rate.  Simple
// and exact first: no tensor cores, no double-buffering, and each block
// restages its x tile once per 32-column chunk of support vectors.
#include "fxp_tile.cuh"

namespace {

using fxp::kBM;
using fxp::kBN;
using fxp::kTM;
constexpr int kPoly = 0, kRbf = 1;

struct SvmParams {
  fxp::Epilogue ek;  // kernel domain: fmt, shift = m
  fxp::Epilogue eo;  // decision: out_fmt, shift = dec_shift, no activation
  int kind, degree;
  int32_t qgamma, qcoef0;
};

template <typename T>
__global__ void __launch_bounds__(fxp::kTileThreads)
fxp_svm_model_kernel(const T* __restrict__ x, const T* __restrict__ sv,
                     const T* __restrict__ dual, const T* __restrict__ icept,
                     T* __restrict__ out, int M, int F, int S, int C,
                     const SvmParams p) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* kv = smem;            // (kBM, S) kernel values
  int32_t* sv2 = kv + kBM * S;   // (S,)   rbf: |sv|^2
  int32_t* x2 = sv2 + S;         // (kBM,) rbf: |x|^2
  __shared__ fxp::TileSmem s;
  const fxp::Epilogue& ek = p.ek;
  const int row0 = blockIdx.x * kBM;

  if (p.kind == kRbf) {
    // One warp per vector (the block's rows, then every support vector);
    // lanes walk the features, the int64 sum wraps through unsigned math.
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (int v = warp; v < kBM + S; v += fxp::kTileThreads / 32) {
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
      if (lane == 0) (is_x ? x2[v] : sv2[r]) = fxp::sumsq_shift(acc, ek);
    }
    __syncthreads();
  }

  const int col = threadIdx.x % kBN, rg = threadIdx.x / kBN;
  for (int col0 = 0; col0 < S; col0 += kBN) {
    uint32_t acc[kTM];
    fxp::tile_dot<T, true>(x, sv, M, F, S, row0, col0, s, acc);
    const int j = col0 + col;
    if (j >= S) continue;
#pragma unroll
    for (int t = 0; t < kTM; ++t) {
      const int r = rg * kTM + t;
      const int32_t dot =
          fxp::requant((int64_t)fxp::u2s32(acc[t]), ek.shift, ek.qmin, ek.qmax);
      int32_t k;
      if (p.kind == kPoly) {
        k = fxp::qpow_int(
            fxp::qadd(fxp::qmul(dot, p.qgamma, ek), p.qcoef0, ek), p.degree,
            ek);
      } else {
        const int32_t d2 = fxp::qadd(
            fxp::qsub(x2[r], fxp::qadd(dot, dot, ek), ek), sv2[j], ek);
        k = fxp::qexp(fxp::qneg(fxp::qmul(d2, p.qgamma, ek), ek), ek);
      }
      kv[r * S + j] = k;
    }
  }
  __syncthreads();

  for (int item = threadIdx.x; item < kBM * C; item += fxp::kTileThreads) {
    const int r = item / C, c = item - r * C;
    if (row0 + r >= M) continue;
    const int32_t* krow = kv + r * S;
    uint32_t acc = 0u;
    for (int j = 0; j < S; ++j)
      acc += (uint32_t)krow[j] * (uint32_t)(int32_t)dual[(size_t)j * C + c];
    out[(size_t)(row0 + r) * C + c] =
        (T)fxp::layer_epilogue(acc, (int32_t)icept[c], p.eo);
  }
}

template <typename T>
int launch(const void* x, const void* sv, const void* dual, const void* icept,
           void* out, int M, int F, int S, int C, const SvmParams& p,
           cudaStream_t stream) {
  const size_t smem = ((size_t)kBM * S + S + kBM) * sizeof(int32_t);
  auto kernel = fxp_svm_model_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (M + kBM - 1) / kBM;
  kernel<<<grid, fxp::kTileThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(sv),
      static_cast<const T*>(dual), static_cast<const T*>(icept),
      static_cast<T*>(out), M, F, S, C, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, F), sv: (S, F), dual: (S, C), icept: (C,), out: (M, C), every
// tensor contiguous in the `bits`-wide container.  `epi_k` and `epi_out`
// hold fxp::kEpilogueFields int64 values each: the kernel-domain format
// (shift = its m) and the decision stage (shift = dec_shift, out format).
// kind: 0 poly, 1 rbf.  Launches on the calling thread's current device.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int fxp_svm_model_launch(const void* x, const void* sv,
                                    const void* dual, const void* icept,
                                    void* out, int M, int F, int S, int C,
                                    int bits, const long long* epi_k,
                                    const long long* epi_out, int kind,
                                    int qgamma, int qcoef0, int degree,
                                    void* stream) {
  if (M <= 0 || F <= 0 || S <= 0 || C <= 0 || degree < 0 ||
      (kind != kPoly && kind != kRbf))
    return (int)cudaErrorInvalidValue;
  SvmParams p;
  p.ek = fxp::epilogue_from(epi_k);
  p.eo = fxp::epilogue_from(epi_out);
  p.kind = kind;
  p.degree = degree;
  p.qgamma = qgamma;
  p.qcoef0 = qcoef0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8: return launch<int8_t>(x, sv, dual, icept, out, M, F, S, C, p, s);
    case 16: return launch<int16_t>(x, sv, dual, icept, out, M, F, S, C, p, s);
    case 32: return launch<int32_t>(x, sv, dual, icept, out, M, F, S, C, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
