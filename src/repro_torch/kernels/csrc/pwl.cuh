// The float PWL sigmoid family, elementwise in float32: the functions of
// repro/kernels/pwl_activation.py (_pwl2, _pwl4, _rational and the fused
// silu gate) written for the CUDA kernel and, unchanged, for the host, where
// the CPU tests compile this header with the system C++ compiler and hold it
// against the JAX package bit for bit.
//
// Where the bits come from:
// * every slope is a power of two, so each product is exact and a fused
//   multiply-add cannot change a result;
// * jnp.clip propagates NaN, which fminf/fmaxf would not (they return the
//   other operand), so the clip is compare-and-select;
// * `rational` divides: it needs IEEE division, so the kernels build
//   without --use_fast_math, and +-inf gives NaN there (inf / inf);
// * -0.0 >= 0 holds, so pwl4(-0.0) takes the positive branch; silu_pwl4(-inf)
//   is NaN (-inf * 0);
// * XLA flushes subnormal float32 results to zero (the CPU tests see it
//   on its CPU backend), so every result below the smallest normal float
//   becomes a zero of its sign.  Only silu_pwl4 can produce one (x * 0.5
//   for |x| near 2^-126): the other three stay in [0, 1] on a grid far
//   coarser than 2^-126, and a subnormal input or intermediate never moves
//   their result.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define PWL_HOST_DEVICE __host__ __device__ __forceinline__
#else
#define PWL_HOST_DEVICE inline
#endif

namespace pwl {

enum Variant : int { kPwl2 = 0, kPwl4 = 1, kRational = 2, kSiluPwl4 = 3 };

// clip(0.25 x + 0.5, 0, 1)
PWL_HOST_DEVICE float pwl2(float x) {
  const float y = x * 0.25f + 0.5f;
  return y < 0.0f ? 0.0f : (y > 1.0f ? 1.0f : y);
}

// PLAN segments (slopes 1/4, 1/8, 1/32) on |x|, mirrored by 1 - f(|x|)
PWL_HOST_DEVICE float pwl4(float x) {
  const float ax = fabsf(x);
  const float y = ax >= 5.0f     ? 1.0f
                  : ax >= 2.375f ? ax * 0.03125f + 0.84375f
                  : ax >= 1.0f   ? ax * 0.125f + 0.625f
                                 : ax * 0.25f + 0.5f;
  return x >= 0.0f ? y : 1.0f - y;
}

// 0.5 + 0.5 x / (1 + |x|), evaluated left to right as the reference does
PWL_HOST_DEVICE float rational(float x) {
  return 0.5f + (0.5f * x) / (1.0f + fabsf(x));
}

PWL_HOST_DEVICE float silu_pwl4(float x) { return x * pwl4(x); }

// A subnormal becomes a zero of the same sign; NaN and the rest pass.
PWL_HOST_DEVICE float flush_subnormal(float y) {
  return fabsf(y) < 0x1p-126f ? y * 0.0f : y;
}

PWL_HOST_DEVICE float apply(int variant, float x) {
  float y;
  switch (variant) {
    case kPwl2: y = pwl2(x); break;
    case kPwl4: y = pwl4(x); break;
    case kRational: y = rational(x); break;
    default: y = silu_pwl4(x); break;
  }
  return flush_subnormal(y);
}

}  // namespace pwl
