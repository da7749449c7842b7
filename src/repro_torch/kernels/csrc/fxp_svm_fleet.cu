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
// Here the grid is (ceil(M / kBM), E) and blockIdx.y picks the model.  Each
// block runs exactly the single-model megakernel's body (fxp_svm_body.cuh)
// on its model's slices of the stacked operands, with its SvmParams read
// from an (E, kSvmFields) int64 table in device memory, so slot e equals
// model e's own fxp_svm_model launch bit for bit.  The kernel kind (poly or
// rbf) and the container width are shared by the fleet; everything else may
// differ per model.  Shared memory per block is the single model's.
//
// Bound on the H100: integer multiply-adds on the CUDA cores for the 16- and
// 32-bit containers, 2 * E * M * (F * S + S * C) operations.
#include "fxp_svm_body.cuh"

namespace {

using fxp::kBM;
constexpr int kMaxModels = 65535;  // gridDim.y

template <typename T>
__global__ void __launch_bounds__(fxp::kTileThreads)
fxp_svm_fleet_kernel(const T* __restrict__ x, const T* __restrict__ sv,
                     const T* __restrict__ dual, const T* __restrict__ icept,
                     T* __restrict__ out, int M, int F, int S, int C,
                     int kind, const long long* __restrict__ params) {
  const size_t e = blockIdx.y;
  const fxp::SvmParams p =
      fxp::svm_params_from(params + e * fxp::kSvmFields, kind);
  fxp::svm_block<T>(x + e * M * F, sv + e * S * F, dual + e * S * C,
                    icept + e * C, out + e * M * C, M, F, S, C,
                    blockIdx.x * kBM, p);
}

template <typename T>
int launch(const void* x, const void* sv, const void* dual, const void* icept,
           void* out, int M, int F, int S, int C, int E, int kind,
           const long long* params, cudaStream_t stream) {
  const size_t smem = fxp::svm_smem_bytes(S);
  auto kernel = fxp_svm_fleet_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kBM - 1) / kBM, E);
  kernel<<<grid, fxp::kTileThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(sv),
      static_cast<const T*>(dual), static_cast<const T*>(icept),
      static_cast<T*>(out), M, F, S, C, kind, params);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (E, M, F), sv: (E, S, F), dual: (E, S, C), icept: (E, C),
// out: (E, M, C), every tensor contiguous in the `bits`-wide container.
// `params` is a DEVICE pointer to E rows of fxp::kSvmFields int64 values
// (fxp::svm_params_from).  kind: 0 poly, 1 rbf.  Launches on the calling
// thread's current device.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int fxp_svm_fleet_launch(const void* x, const void* sv,
                                    const void* dual, const void* icept,
                                    void* out, int M, int F, int S, int C,
                                    int E, int bits, int kind,
                                    const long long* params, void* stream) {
  if (M <= 0 || F <= 0 || S <= 0 || C <= 0 || E <= 0 || E > kMaxModels ||
      (kind != fxp::kSvmPoly && kind != fxp::kSvmRbf))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8:
      return launch<int8_t>(x, sv, dual, icept, out, M, F, S, C, E, kind,
                            params, s);
    case 16:
      return launch<int16_t>(x, sv, dual, icept, out, M, F, S, C, E, kind,
                             params, s);
    case 32:
      return launch<int32_t>(x, sv, dual, icept, out, M, F, S, C, E, kind,
                             params, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
