// pwl_activation: the float PWL sigmoid family (pwl2, pwl4, rational,
// silu_pwl4) over a float32 tensor, elementwise, in one launch.
//
// Replaces the Pallas kernel
// repro/kernels/pwl_activation.py::pwl_activation_pallas (body _kernel),
// which tiles an (R, C) array through VMEM in (256, 512) blocks.  The
// function is elementwise, so here the tensor is one flat array and a
// grid-stride loop walks it with 16-byte loads and stores (float4) where
// both pointers are 16-byte aligned, and the ragged tail (or an unaligned
// tensor) element by element.  The arithmetic is pwl.cuh's, shared with the
// CPU tests.
//
// Bound on the H100: bytes.  Four bytes in and four out per element against
// a handful of float operations (one division for `rational`), far below
// the card's operations-per-byte balance.  The design only has to keep
// enough 16-byte transactions in flight: a grid of up to 16 blocks per SM.
#include <cuda_runtime.h>

#include <cstdint>

#include "pwl.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
pwl_activation_kernel(const float* __restrict__ x, float* __restrict__ y,
                      long long n, int vectorized) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long start = 0;
  if (vectorized) {
    const long long n4 = n >> 2;
    const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
    float4* __restrict__ y4 = reinterpret_cast<float4*>(y);
    for (long long i = tid; i < n4; i += stride) {
      float4 v = x4[i];
      v.x = pwl::apply(kVariant, v.x);
      v.y = pwl::apply(kVariant, v.y);
      v.z = pwl::apply(kVariant, v.z);
      v.w = pwl::apply(kVariant, v.w);
      y4[i] = v;
    }
    start = n4 << 2;
  }
  for (long long i = start + tid; i < n; i += stride)
    y[i] = pwl::apply(kVariant, x[i]);
}

template <int kVariant>
int launch(const float* x, float* y, long long n, cudaStream_t stream) {
  const int vectorized =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  const long long items = vectorized ? (n >> 2) + (n & 3) : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  pwl_activation_kernel<kVariant>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, n, vectorized);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: n contiguous float32 values, not overlapping.  variant: 0 pwl2,
// 1 pwl4, 2 rational, 3 silu_pwl4.  Launches on the calling thread's current
// device.  Returns the CUDA error code of the launch (0 on success).
extern "C" int pwl_activation_launch(const float* x, float* y, long long n,
                                     int variant, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case pwl::kPwl2: return launch<pwl::kPwl2>(x, y, n, s);
    case pwl::kPwl4: return launch<pwl::kPwl4>(x, y, n, s);
    case pwl::kRational: return launch<pwl::kRational>(x, y, n, s);
    case pwl::kSiluPwl4: return launch<pwl::kSiluPwl4>(x, y, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
