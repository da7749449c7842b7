// fxp_svm_model: the whole fixed-point kernel-SVM decision function in one
// launch.
//
// Replaces the Pallas megakernel
// repro/kernels/fxp_model.py::fxp_svm_model_pallas (body _svm_kernel, via
// _svm_forward), which keeps every support vector and dual coefficient
// resident in VMEM.  Here a thread block cluster per 32 batch rows splits
// the support vectors over its blocks and sums their uint32 partials of the
// decision through distributed shared memory: the body, its bound on the
// H100 and what its design does about it are in fxp_svm_body.cuh, which the
// fleet kernel (fxp_svm_fleet.cu) runs too, so that a fleet slot equals its
// model's own launch bit for bit.  This file passes the one model's
// SvmParams by value in the kernel parameters.  `bm` picks the cluster's
// rows, 16, 32 or 64 (an instance each; 0: kSvmRows = 32), the block-size
// tuner's choice (kernels/tune.py); every instance computes the same bits.
#include "fxp_svm_body.cuh"

namespace {

template <typename T, int R>
__global__ void __launch_bounds__(fxp::SvmTile<R>::kThreads,
                                  fxp::SvmTile<R>::kMinBlocks)
fxp_svm_model_kernel(const T* __restrict__ x, const T* __restrict__ sv,
                     const T* __restrict__ dual, const T* __restrict__ icept,
                     T* __restrict__ out, int M, int F, int S, int C,
                     int n_chunks, int cap, const fxp::SvmParams p) {
  fxp::svm_cluster_body<T, R>(x, sv, dual, icept, out, M, F, S, C, n_chunks,
                              cap, p);
}

template <typename T, int R>
int launch_rows(const void* x, const void* sv, const void* dual,
                const void* icept, void* out, int M, int F, int S, int C,
                const fxp::SvmParams& p, cudaStream_t stream) {
  fxp::SvmPlan plan;
  if (!fxp::svm_plan(S, &plan, R)) return (int)cudaErrorInvalidValue;
  return (int)fxp::svm_cluster_launch<R>(
      fxp_svm_model_kernel<T, R>, plan, M, 1, stream,
      static_cast<const T*>(x), static_cast<const T*>(sv),
      static_cast<const T*>(dual), static_cast<const T*>(icept),
      static_cast<T*>(out), M, F, S, C, plan.n_chunks, plan.cap, p);
}

template <typename T>
int launch(const void* x, const void* sv, const void* dual, const void* icept,
           void* out, int M, int F, int S, int C, const fxp::SvmParams& p,
           int bm, cudaStream_t stream) {
  switch (bm == 0 ? fxp::kSvmRows : bm) {
    case 16:
      return launch_rows<T, 16>(x, sv, dual, icept, out, M, F, S, C, p,
                                stream);
    case 32:
      return launch_rows<T, 32>(x, sv, dual, icept, out, M, F, S, C, p,
                                stream);
    case 64:
      return launch_rows<T, 64>(x, sv, dual, icept, out, M, F, S, C, p,
                                stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (M, F), sv: (S, F), dual: (S, C), icept: (C,), out: (M, C), every
// tensor contiguous in the `bits`-wide container.  `epi_k` and `epi_out`
// hold fxp::kEpilogueFields int64 values each: the kernel-domain format
// (shift = its m) and the decision stage (shift = dec_shift, out format).
// kind: 0 poly, 1 rbf; bm: the cluster's rows (0: today's 32).  Launches on
// the calling thread's current device.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int fxp_svm_model_launch(const void* x, const void* sv,
                                    const void* dual, const void* icept,
                                    void* out, int M, int F, int S, int C,
                                    int bits, const long long* epi_k,
                                    const long long* epi_out, int kind,
                                    int qgamma, int qcoef0, int degree,
                                    int bm, void* stream) {
  if (M <= 0 || F <= 0 || S <= 0 || C <= 0 || degree < 0 ||
      (kind != fxp::kSvmPoly && kind != fxp::kSvmRbf))
    return (int)cudaErrorInvalidValue;
  fxp::SvmParams p;
  p.ek = fxp::epilogue_from(epi_k);
  p.eo = fxp::epilogue_from(epi_out);
  p.kind = kind;
  p.degree = degree;
  p.qgamma = qgamma;
  p.qcoef0 = qcoef0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8:
      return launch<int8_t>(x, sv, dual, icept, out, M, F, S, C, p, bm, s);
    case 16:
      return launch<int16_t>(x, sv, dual, icept, out, M, F, S, C, p, bm, s);
    case 32:
      return launch<int32_t>(x, sv, dual, icept, out, M, F, S, C, p, bm, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
