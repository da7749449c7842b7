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
// * a fused bias is added before the variant, the sum rounded to the
//   tensor's type first (pwl_activation.cu), as the unfused h + b rounds
//   it: float32 here, float16 and bfloat16 by the kernel's narrowing cast;
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
#define PWL_UNROLL _Pragma("unroll")
#else
#define PWL_HOST_DEVICE inline
#define PWL_UNROLL
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

// The fused bias of a row-major (rows, cols) tensor: the column of each
// element of a grid-stride pass, without a division per element.  A pass
// whose items are groups of `vec` consecutive elements starts at element
// `first` and moves `stride` elements an iteration: `col` is the column of
// the item's first element, `next` steps one element within the item
// (columns wrap at `cols`, any number of times in an item when cols < vec)
// and `advance` one iteration.
struct ColumnWalk {
  int col, step, cols;
  PWL_HOST_DEVICE ColumnWalk(long long first, long long stride, int cols_)
      : col((int)(first % cols_)), step((int)(stride % cols_)), cols(cols_) {}
  PWL_HOST_DEVICE int next(int c) const { return c + 1 == cols ? 0 : c + 1; }
  PWL_HOST_DEVICE void advance() {
    col += step;
    if (col >= cols) col -= cols;
  }
};

// One thread's share of pwl_activation.cu's grid-stride pass, thread `tid`
// of `threads`: y[i] = op(x[i], bias[column of i]) with kBias, op(x[i])
// without, over the n elements of a row-major (n / cols, cols) tensor.
// Vectorized (x and y aligned to a V of kVec values), it takes the items
// tid, tid + threads, ... of kVec values, then the tail past the last whole
// vector element by element; else every element.  The kernel runs it with
// V = uint4 (16-byte accesses) and op the variant in its storage type; the
// CPU tests run the same loops over float32 with V a plain array.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <bool kBias, int kVec, typename V, typename T, typename Op>
PWL_HOST_DEVICE void thread_share(const T* __restrict__ x,
                                  const T* __restrict__ bias,
                                  T* __restrict__ y, long long n, int cols,
                                  int vectorized, long long tid,
                                  long long threads, const Op& op) {
  long long start = 0;
  if (vectorized) {
    const long long nv = n / kVec;
    const V* __restrict__ xv = reinterpret_cast<const V*>(x);
    V* __restrict__ yv = reinterpret_cast<V*>(y);
    ColumnWalk walk(tid * kVec, threads * kVec, kBias ? cols : 1);
    for (long long i = tid; i < nv; i += threads) {
      V v = xv[i];
      T* e = reinterpret_cast<T*>(&v);
      if (kBias) {
        int c = walk.col;
        PWL_UNROLL
        for (int j = 0; j < kVec; ++j) {
          e[j] = op(e[j], bias[c]);
          c = walk.next(c);
        }
        walk.advance();
      } else {
        PWL_UNROLL
        for (int j = 0; j < kVec; ++j) e[j] = op(e[j]);
      }
      yv[i] = v;
    }
    start = nv * kVec;
  }
  // the ragged tail, or the whole of an unaligned tensor
  ColumnWalk walk(start + tid, threads, kBias ? cols : 1);
  for (long long i = start + tid; i < n; i += threads) {
    if (kBias) {
      y[i] = op(x[i], bias[walk.col]);
      walk.advance();
    } else {
      y[i] = op(x[i]);
    }
  }
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
