// fxp_svm_fleet: E stacked fixed-point kernel SVMs in one launch.
//
// Replaces the Pallas kernel
// repro/kernels/fxp_model.py::fxp_svm_fleet_pallas (body _svm_fleet_kernel,
// via _svm_forward_batched), which grids over (model blocks, batch blocks):
// with one shared parameter set it batches the dots over the model axis,
// and with per-model (fmt, out_fmt, q(gamma), q(coef0), degree, dec_shift)
// it takes one model per grid step and picks its static branch with
// lax.switch.
//
// Here every model runs the single-model kernel's cluster body
// (fxp_svm_body.cuh): the grid is (G x ceil(M / 32), E) in clusters of G
// blocks along x (svm_plan: G = min(8, ceil(S / 64))), and blockIdx.y picks
// the model.  A cluster owns 32 rows of one model and splits its support
// vectors; the blocks' uint32 partials of the decision meet in distributed
// shared memory, exact mod 2^32 for any G.  Each block copies its model's
// SvmParams from an (E, kSvmFields) int64 table in device memory into
// shared memory once, and offsets x, sv, dual, icept and out by e, so slot
// e computes exactly what model e's own fxp_svm_model launch computes, bit
// for bit.  The kernel kind (poly or rbf) and the container width are
// shared by the fleet; everything else may differ per model.  Shared memory
// per block is the single model's.  `bm` picks the cluster's rows (16, 32
// or 64; 0: 32), the block-size tuner's choice, as in fxp_svm_model.cu;
// every model of the fleet runs it.
//
// Bound on the H100: integer multiply-adds on the CUDA cores for the 16- and
// 32-bit containers, 2 * E * M * (F * S + S * C) operations.  At path D's
// fleet (4 D5 rbf SVMs at fxp32: F = 8, S = 300, C = 10, 3298 rows) the
// first version ran one block per 32 rows and model (416 blocks, under one
// wave), its stages in series: norms, ten 32-column tile-loop chunks with
// 3/4 of each staged tile zeros, 40 kernel values a thread, then a decision
// walk of all 300 vectors in one dependent chain a thread.  The cluster
// body spreads the 300 vectors over 5 blocks (520 x 4 blocks of 128
// threads): each block walks 64 vectors in 4x4 micro-tiles, stops its dot
// at F (one 8-feature step at F = 8), runs the kernel values as a pass of
// their own and the decision in four chains.  What sets the pace now is the
// fxp32 rbf algebra (the 64-bit qexp) and each block's chain of global loads
// and barriers (PERF.md, Findings; tools/svm_ablation.py times each phase).
#include "fxp_svm_body.cuh"

namespace {

constexpr int kMaxModels = 65535;  // gridDim.y

template <typename T, int R>
__global__ void __launch_bounds__(fxp::SvmTile<R>::kThreads,
                                  fxp::SvmTile<R>::kMinBlocks)
fxp_svm_fleet_kernel(const T* __restrict__ x, const T* __restrict__ sv,
                     const T* __restrict__ dual, const T* __restrict__ icept,
                     T* __restrict__ out, int M, int F, int S, int C,
                     int n_chunks, int cap, int kind,
                     const long long* __restrict__ params) {
  __shared__ fxp::SvmParams p;
  const size_t e = blockIdx.y;
  if (threadIdx.x == 0)
    p = fxp::svm_params_from(params + e * fxp::kSvmFields, kind);
  __syncthreads();
  fxp::svm_cluster_body<T, R>(x + e * M * F, sv + e * S * F, dual + e * S * C,
                           icept + e * C, out + e * M * C, M, F, S, C,
                           n_chunks, cap, p);
}

template <typename T, int R>
int launch_rows(const void* x, const void* sv, const void* dual,
                const void* icept, void* out, int M, int F, int S, int C,
                int E, int kind, const long long* params,
                cudaStream_t stream) {
  fxp::SvmPlan plan;
  if (!fxp::svm_plan(S, &plan, R)) return (int)cudaErrorInvalidValue;
  return (int)fxp::svm_cluster_launch<R>(
      fxp_svm_fleet_kernel<T, R>, plan, M, E, stream,
      static_cast<const T*>(x), static_cast<const T*>(sv),
      static_cast<const T*>(dual), static_cast<const T*>(icept),
      static_cast<T*>(out), M, F, S, C, plan.n_chunks, plan.cap, kind,
      params);
}

template <typename T>
int launch(const void* x, const void* sv, const void* dual, const void* icept,
           void* out, int M, int F, int S, int C, int E, int kind,
           const long long* params, int bm, cudaStream_t stream) {
  switch (bm == 0 ? fxp::kSvmRows : bm) {
    case 16:
      return launch_rows<T, 16>(x, sv, dual, icept, out, M, F, S, C, E, kind,
                                params, stream);
    case 32:
      return launch_rows<T, 32>(x, sv, dual, icept, out, M, F, S, C, E, kind,
                                params, stream);
    case 64:
      return launch_rows<T, 64>(x, sv, dual, icept, out, M, F, S, C, E, kind,
                                params, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (E, M, F), sv: (E, S, F), dual: (E, S, C), icept: (E, C),
// out: (E, M, C), every tensor contiguous in the `bits`-wide container.
// `params` is a DEVICE pointer to E rows of fxp::kSvmFields int64 values
// (fxp::svm_params_from).  kind: 0 poly, 1 rbf; bm: the cluster's rows (0:
// today's 32).  Launches on the calling thread's current device.  Returns
// the CUDA error code of the launch (0 on success).
extern "C" int fxp_svm_fleet_launch(const void* x, const void* sv,
                                    const void* dual, const void* icept,
                                    void* out, int M, int F, int S, int C,
                                    int E, int bits, int kind,
                                    const long long* params, int bm,
                                    void* stream) {
  if (M <= 0 || F <= 0 || S <= 0 || C <= 0 || E <= 0 || E > kMaxModels ||
      (kind != fxp::kSvmPoly && kind != fxp::kSvmRbf))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8:
      return launch<int8_t>(x, sv, dual, icept, out, M, F, S, C, E, kind,
                            params, bm, s);
    case 16:
      return launch<int16_t>(x, sv, dual, icept, out, M, F, S, C, E, kind,
                             params, bm, s);
    case 32:
      return launch<int32_t>(x, sv, dual, icept, out, M, F, S, C, E, kind,
                             params, bm, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
