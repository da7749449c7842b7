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
//
// What it saves is launches, not bytes: a launch costs the host more than
// the kernel's body costs the card below a few MB.  So it takes the work
// around it that would be launches of their own: an optional bias over the
// last axis, added before the variant (a hidden layer's `h @ w + b` then
// sigmoid is the matmul and this one launch), and `silu_pwl4`, the LM's
// gated SiLU with the PWL gate in one launch instead of the 18 elementwise
// PyTorch ops of `x * sigmoid_pwl4(x)`.  The bias column of each element is
// walked from the row start (pwl::ColumnWalk): one division per thread, none
// per element, and rows whose width is no multiple of a vector's 4 or 8
// values cross inside a vector.
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

// v + b rounded to T (exact widening, one float32 add, round to nearest
// even), then the variant: what the unfused pwl(h + b) computes.  For the
// narrow types the float32 sum of two values is rounded twice, to float32
// and to T; with 24 bits against 11 or 8 that equals one correctly rounded
// T addition, which is what PyTorch's and XLA's narrow adds give.
template <typename T, int kVariant>
__device__ __forceinline__ T apply_biased(T v, T b) {
  return apply<T, kVariant>(narrow<T>(widen(v) + widen(b)));
}

template <typename T, int kVariant>
struct Op {
  __device__ __forceinline__ T operator()(T v) const {
    return apply<T, kVariant>(v);
  }
  __device__ __forceinline__ T operator()(T v, T b) const {
    return apply_biased<T, kVariant>(v, b);
  }
};

// y = variant(x (+ bias)) over n elements; with a bias the tensor is
// row-major (n / cols, cols) and bias has cols values.  The loops are
// pwl::thread_share, which the CPU tests run on the host.
template <typename T, int kVariant, bool kBias>
__global__ void __launch_bounds__(kThreads)
pwl_activation_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                      T* __restrict__ y, long long n, int cols,
                      int vectorized) {
  constexpr int kVec = 16 / (int)sizeof(T);  // values per 16-byte access
  pwl::thread_share<kBias, kVec, uint4>(
      x, bias, y, n, cols, vectorized,
      (long long)blockIdx.x * kThreads + threadIdx.x,
      (long long)gridDim.x * kThreads, Op<T, kVariant>());
}

template <typename T, int kVariant>
int launch(const void* xp, const void* bp, void* yp, long long n, int cols,
           cudaStream_t stream) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const T* x = static_cast<const T*>(xp);
  const T* b = static_cast<const T*>(bp);
  T* y = static_cast<T*>(yp);
  const int vectorized =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  const long long items = vectorized ? n / kVec + n % kVec : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  if (b != nullptr)
    pwl_activation_kernel<T, kVariant, true>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(x, b, y, n, cols,
                                                     vectorized);
  else
    pwl_activation_kernel<T, kVariant, false>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(x, b, y, n, cols,
                                                     vectorized);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_variant(const void* x, const void* b, void* y, long long n,
                   int cols, int variant, cudaStream_t s) {
  switch (variant) {
    case pwl::kPwl2: return launch<T, pwl::kPwl2>(x, b, y, n, cols, s);
    case pwl::kPwl4: return launch<T, pwl::kPwl4>(x, b, y, n, cols, s);
    case pwl::kRational: return launch<T, pwl::kRational>(x, b, y, n, cols, s);
    case pwl::kSiluPwl4: return launch<T, pwl::kSiluPwl4>(x, b, y, n, cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: n contiguous values of one dtype (0 float32, 1 float16, 2
// bfloat16), not overlapping.  bias: NULL, or cols values of that dtype
// added to each row of the row-major (n / cols, cols) x before the variant
// (n a multiple of cols).  variant: 0 pwl2, 1 pwl4, 2 rational,
// 3 silu_pwl4.  Launches on the calling thread's current device.  Returns
// the CUDA error code of the launch (0 on success).
extern "C" int pwl_activation_launch(const void* x, const void* bias, void* y,
                                     long long n, int cols, int variant,
                                     int dtype, void* stream) {
  if (n <= 0 || (bias != nullptr && (cols <= 0 || n % cols != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_variant<float>(x, bias, y, n, cols, variant, s);
    case 1: return launch_variant<__half>(x, bias, y, n, cols, variant, s);
    case 2:
      return launch_variant<__nv_bfloat16>(x, bias, y, n, cols, variant, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
