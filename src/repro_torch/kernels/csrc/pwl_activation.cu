// pwl_activation: the float PWL sigmoid family (pwl2, pwl4, rational,
// silu_pwl4) over a float32, float16 or bfloat16 tensor, elementwise, in
// one launch.
//
// Replaces the Pallas kernel
// repro/kernels/pwl_activation.py::pwl_activation_pallas (body _kernel),
// which tiles an (R, C) array through VMEM in (256, 512) blocks and computes
// in float32, casting back to the input's dtype.  The function is
// elementwise, so here the tensor is one flat array and a grid-stride loop
// walks it with 16-byte loads and stores (4 float32 or 8 narrow values)
// where both pointers are 16-byte aligned, and the ragged tail (or an
// unaligned tensor) element by element.  A float16 or bfloat16 value widens
// to float32 exactly; the result narrows with round to nearest even
// (cvt.rn), as PyTorch's cast does.  The arithmetic is pwl.cuh's, shared
// with the CPU tests.
//
// Bound on the H100: bytes.  Two to four bytes in and out per element
// against a handful of float operations (one division for `rational`), far
// below the card's operations-per-byte balance.  The design only has to
// keep enough 16-byte transactions in flight: a grid of up to 16 blocks per
// SM.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "pwl.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half narrow<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int kVariant>
__device__ __forceinline__ T apply(T v) {
  return narrow<T>(pwl::apply(kVariant, widen(v)));
}

template <typename T, int kVariant>
__global__ void __launch_bounds__(kThreads)
pwl_activation_kernel(const T* __restrict__ x, T* __restrict__ y,
                      long long n, int vectorized) {
  constexpr int kVec = 16 / (int)sizeof(T);  // values per 16-byte access
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long start = 0;
  if (vectorized) {
    const long long nv = n / kVec;
    const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);
    uint4* __restrict__ yv = reinterpret_cast<uint4*>(y);
    for (long long i = tid; i < nv; i += stride) {
      uint4 v = xv[i];
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) e[j] = apply<T, kVariant>(e[j]);
      yv[i] = v;
    }
    start = nv * kVec;
  }
  for (long long i = start + tid; i < n; i += stride)
    y[i] = apply<T, kVariant>(x[i]);
}

template <typename T, int kVariant>
int launch(const void* xp, void* yp, long long n, cudaStream_t stream) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const T* x = static_cast<const T*>(xp);
  T* y = static_cast<T*>(yp);
  const int vectorized =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  const long long items = vectorized ? n / kVec + n % kVec : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  pwl_activation_kernel<T, kVariant>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, n, vectorized);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_variant(const void* x, void* y, long long n, int variant,
                   cudaStream_t s) {
  switch (variant) {
    case pwl::kPwl2: return launch<T, pwl::kPwl2>(x, y, n, s);
    case pwl::kPwl4: return launch<T, pwl::kPwl4>(x, y, n, s);
    case pwl::kRational: return launch<T, pwl::kRational>(x, y, n, s);
    case pwl::kSiluPwl4: return launch<T, pwl::kSiluPwl4>(x, y, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: n contiguous values of one dtype (0 float32, 1 float16, 2
// bfloat16), not overlapping.  variant: 0 pwl2, 1 pwl4, 2 rational,
// 3 silu_pwl4.  Launches on the calling thread's current device.  Returns
// the CUDA error code of the launch (0 on success).
extern "C" int pwl_activation_launch(const void* x, void* y, long long n,
                                     int variant, int dtype, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_variant<float>(x, y, n, variant, s);
    case 1: return launch_variant<__half>(x, y, n, variant, s);
    case 2: return launch_variant<__nv_bfloat16>(x, y, n, variant, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
