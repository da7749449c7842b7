// fxp_svm_model: the whole fixed-point kernel-SVM decision function in one
// launch.
//
// Replaces the Pallas megakernel
// repro/kernels/fxp_model.py::fxp_svm_model_pallas (body _svm_kernel, via
// _svm_forward), which keeps every support vector and dual coefficient
// resident in VMEM.  A Hopper block has 227 KB of shared memory, not VMEM's
// megabytes, so here the kernel values, not the support vectors, live in
// shared memory: each block owns kBM = 32 batch rows and fills a (32, S)
// int32 tile of k (38 KB at S = 300); the body is fxp_svm_body.cuh, shared
// with the fleet kernel.  Support vectors and duals are KB-scale and stay in
// L2 across blocks.
//
// Bound on the H100: integer multiply-adds on the CUDA cores for the 16- and
// 32-bit containers (2 * M * (F * S + S * C) operations); the 8-bit
// container's bound is set by bytes at the tensor cores' int8 rate.  Simple
// and exact first: no tensor cores, no double-buffering, and each block
// restages its x tile once per 32-column chunk of support vectors.
#include "fxp_svm_body.cuh"

namespace {

using fxp::kBM;

template <typename T>
__global__ void __launch_bounds__(fxp::kTileThreads)
fxp_svm_model_kernel(const T* __restrict__ x, const T* __restrict__ sv,
                     const T* __restrict__ dual, const T* __restrict__ icept,
                     T* __restrict__ out, int M, int F, int S, int C,
                     const fxp::SvmParams p) {
  fxp::svm_block<T>(x, sv, dual, icept, out, M, F, S, C, blockIdx.x * kBM, p);
}

template <typename T>
int launch(const void* x, const void* sv, const void* dual, const void* icept,
           void* out, int M, int F, int S, int C, const fxp::SvmParams& p,
           cudaStream_t stream) {
  const size_t smem = fxp::svm_smem_bytes(S);
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
    case 8: return launch<int8_t>(x, sv, dual, icept, out, M, F, S, C, p, s);
    case 16: return launch<int16_t>(x, sv, dual, icept, out, M, F, S, C, p, s);
    case 32: return launch<int32_t>(x, sv, dual, icept, out, M, F, S, C, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
