// Fixed-point epilogue shared by the hand-written Hopper kernels.
//
// Device copies of the integer runtime that the C emitter of the reference
// package generates (repro/emit/cgen.py, _RUNTIME), which reproduces the
// traced JAX semantics of repro/core/fixedpoint.py and activations.py bit
// for bit: round-to-nearest shifts exact at the dtype extremes, saturation,
// and wide-dtype wrap-around made explicit with wrap() (CUDA C++ promotes
// int16 arithmetic to int, so every op that JAX keeps in int16 or int32 is
// wrapped back to that width here).  All signed shifts and products go
// through unsigned types, so no step has undefined behaviour.
//
// The one difference from that runtime: the matmul accumulator is int32 and
// wraps at 32 bits, as in the Pallas kernels, not at the wide width of the
// reference backend.
#pragma once

#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#define FXP_DEVICE __device__ __forceinline__
#define FXP_HOST_DEVICE __host__ __device__ __forceinline__
#else
// A host build of the epilogue alone: the CPU tests compile this header with
// the system C++ compiler and hold it against the plain PyTorch epilogue.
#define FXP_DEVICE inline
#define FXP_HOST_DEVICE inline
#endif

namespace fxp {

enum Act : int { kNone = 0, kExact = 1, kRational = 2, kPwl2 = 3, kPwl4 = 4 };

// One layer's epilogue: requantize by `shift`, saturating bias add, then the
// activation, all in the output format.  Filled on the host from an int64
// array in the field order below (kernels/fxp_layer.py::epilogue_params).
struct Epilogue {
  int shift, act, m, tb, wb, ib;
  int32_t qmin, qmax, one_q;
  int64_t log2e_q, c0, c1, c2, c3;       // qexp polynomial (exp_poly_consts)
  int64_t one, half;                     // int(scale), int(scale) >> 1
  int64_t t5, t2375, t1, c84375, c625;   // PLAN constants (pwl4_consts)
};
constexpr int kEpilogueFields = 21;

// On the host for launch parameters; on the device for the fleet kernels,
// which read each model's rows from a table in device memory.
FXP_HOST_DEVICE Epilogue epilogue_from(const long long* p) {
  Epilogue e;
  e.shift = (int)p[0];  e.act = (int)p[1];  e.m = (int)p[2];
  e.tb = (int)p[3];     e.wb = (int)p[4];   e.ib = (int)p[5];
  e.qmin = (int32_t)p[6];  e.qmax = (int32_t)p[7];  e.one_q = (int32_t)p[8];
  e.log2e_q = p[9];  e.c0 = p[10];  e.c1 = p[11];  e.c2 = p[12];  e.c3 = p[13];
  e.one = p[14];  e.half = p[15];
  e.t5 = p[16];  e.t2375 = p[17];  e.t1 = p[18];  e.c84375 = p[19];
  e.c625 = p[20];
  return e;
}

// value-preserving two's-complement reinterpretations (no overflow UB; a
// register move on the card)
FXP_DEVICE int64_t u2s(uint64_t u) {
  int64_t s;
  memcpy(&s, &u, sizeof s);
  return s;
}

FXP_DEVICE int32_t u2s32(uint32_t u) {
  int32_t s;
  memcpy(&s, &u, sizeof s);
  return s;
}

FXP_DEVICE int64_t shl(int64_t v, int m) {
  return u2s((uint64_t)v << m);
}

// wrap v into the two's-complement range of `bits`: the overflow behaviour
// of the traced wide integer dtype (keep the low `bits` bits, sign-extend)
FXP_DEVICE int64_t wrap(int64_t v, int bits) {
  if (bits >= 64) return v;
  const int s = 64 - bits;
  return shl(v, s) >> s;
}

FXP_DEVICE int32_t sat(int64_t v, int32_t qmin, int32_t qmax) {
  if (v < (int64_t)qmin) return qmin;
  if (v > (int64_t)qmax) return qmax;
  return (int32_t)v;
}

FXP_DEVICE int64_t mul_wrap(int64_t a, int64_t b) {
  return u2s((uint64_t)a * (uint64_t)b);
}

// _rshift_round: floor-shift + remainder, round-to-nearest, ties away from
// zero; exact for every representable input including dtype extremes
FXP_DEVICE int64_t rshr(int64_t x, int m) {
  if (m == 0) return x;
  const int64_t half = (int64_t)1 << (m - 1);
  const int64_t floor_q = x >> m;
  // x - (floor_q << m): the low m bits of x, in [0, 2^m)
  const int64_t rem = (int64_t)((uint64_t)x & (((uint64_t)1 << m) - 1u));
  return floor_q + ((rem > half - (x >= 0)) ? 1 : 0);
}

// requantize: saturate(round_shift(acc, shift))
FXP_DEVICE int32_t requant(int64_t acc, int shift, int32_t qmin,
                                           int32_t qmax) {
  return sat(rshr(acc, shift), qmin, qmax);
}

// qdiv: (a << m) / b, truncating magnitude division then round-to-nearest
// ties away from zero; b == 0 saturates by the sign of a
FXP_DEVICE int32_t qdiv(int32_t a, int32_t b, int m,
                                        int32_t qmin, int32_t qmax) {
  int64_t wa, q_trunc;
  uint64_t ua, ub, q, r;
  int negative;
  if (b == 0) return (a >= 0) ? qmax : qmin;
  wa = shl((int64_t)a, m);
  negative = (wa < 0) != (b < 0);
  ua = (wa < 0) ? (uint64_t)0 - (uint64_t)wa : (uint64_t)wa;
  ub = (b < 0) ? (uint64_t)0 - (uint64_t)(int64_t)b : (uint64_t)(int64_t)b;
  q = ua / ub;
  r = ua % ub;
  q_trunc = negative ? -u2s(q) : u2s(q);
  if (2u * r >= ub) q_trunc += negative ? -1 : 1;
  return sat(q_trunc, qmin, qmax);
}

// qexp: exp(x) = 2^(x*log2e) = 2^k * 2^f with a cubic 2^f polynomial; every
// product wraps at the wide width wb, exactly like the traced op (for 8-bit
// containers the Horner products wrap at 16 bits)
FXP_DEVICE int32_t qexp_w(int32_t x, const Epilogue& e, int tb, int wb) {
  const int m = e.m;
  int64_t y = rshr(wrap(mul_wrap((int64_t)x, e.log2e_q), wb), m);
  int64_t k = y >> m;
  int64_t f = y - shl(k, m);
  int32_t k_i32 = (int32_t)wrap(k, 32);
  int32_t k_cl = (k_i32 < -tb) ? -tb : ((k_i32 > tb) ? tb : k_i32);
  int pos = (k_cl > 0) ? k_cl : 0;
  int neg = (k_cl < 0) ? -k_cl : 0;
  int s_up = (pos < tb - 1) ? pos : (tb - 1);
  int s_dn = (neg < tb + m) ? neg : (tb + m);
  int64_t acc = e.c3;
  int64_t shifted_up, up, out;
  acc = wrap(rshr(wrap(mul_wrap(acc, f), wb), m) + e.c2, wb);
  acc = wrap(rshr(wrap(mul_wrap(acc, f), wb), m) + e.c1, wb);
  acc = wrap(rshr(wrap(mul_wrap(acc, f), wb), m) + e.c0, wb);
  shifted_up = wrap(shl(acc, s_up), wb);
  up = ((shifted_up >> s_up) != acc) ? (int64_t)e.qmax : shifted_up;
  out = (k_cl >= 0) ? up : (acc >> s_dn);
  if (k_i32 >= e.ib) out = (int64_t)e.qmax;
  return sat(out, e.qmin, e.qmax);
}

// qexp in e's own format; a caller that knows the container at compile time
// may call qexp_w with tb = e.tb and wb = e.wb as constants instead
FXP_DEVICE int32_t qexp(int32_t x, const Epilogue& e) {
  return qexp_w(x, e, e.tb, e.wb);
}

// sigmoid variants — constants quantized on the host
FXP_DEVICE int32_t qsig_exact(int32_t x, const Epilogue& e) {
  int64_t na = (x < 0) ? (int64_t)x : -(int64_t)x;
  int32_t ex = qexp(sat(na, e.qmin, e.qmax), e);
  int32_t denom = sat((int64_t)e.one_q + (int64_t)ex, e.qmin, e.qmax);
  int32_t pos = qdiv(e.one_q, denom, e.m, e.qmin, e.qmax);
  int32_t neg = sat((int64_t)e.one_q - (int64_t)pos, e.qmin, e.qmax);
  return (x >= 0) ? pos : neg;
}

FXP_DEVICE int32_t qsig_pwl2(int32_t x, const Epilogue& e) {
  int64_t ramp = rshr((int64_t)x, 2) + e.half;
  if (ramp < 0) ramp = 0;
  if (ramp > (int64_t)e.one_q) ramp = e.one_q;
  return sat(ramp, e.qmin, e.qmax);
}

FXP_DEVICE int32_t qsig_pwl4(int32_t x, const Epilogue& e) {
  int64_t ax = (x < 0) ? -(int64_t)x : (int64_t)x;
  int64_t y;
  if (ax >= e.t5) y = e.one;
  else if (ax >= e.t2375) y = rshr(ax, 5) + e.c84375;
  else if (ax >= e.t1) y = rshr(ax, 3) + e.c625;
  else y = rshr(ax, 2) + e.half;
  if (x < 0) y = e.one - y;
  return sat(y, e.qmin, e.qmax);
}

FXP_DEVICE int32_t qsig_rational(int32_t x, const Epilogue& e) {
  int64_t ax = (x < 0) ? -(int64_t)x : (int64_t)x;
  int32_t denom = sat(ax + e.one, e.qmin, e.qmax);
  int32_t ratio = qdiv(x, denom, e.m, e.qmin, e.qmax);
  return sat(e.half + rshr((int64_t)ratio, 1), e.qmin, e.qmax);
}

// Elementwise Qn.m ops on container values in the epilogue's format (m,
// qmin, qmax, one_q): every operand fits the container, so each product and
// sum is exact in 64 bits, as it is in the reference's wide dtype.
FXP_DEVICE int32_t qadd(int32_t a, int32_t b, const Epilogue& e) {
  return sat((int64_t)a + (int64_t)b, e.qmin, e.qmax);
}

FXP_DEVICE int32_t qsub(int32_t a, int32_t b, const Epilogue& e) {
  return sat((int64_t)a - (int64_t)b, e.qmin, e.qmax);
}

FXP_DEVICE int32_t qneg(int32_t a, const Epilogue& e) {
  return sat(-(int64_t)a, e.qmin, e.qmax);
}

FXP_DEVICE int32_t qmul(int32_t a, int32_t b, const Epilogue& e) {
  return sat(rshr((int64_t)a * (int64_t)b, e.m), e.qmin, e.qmax);
}

// x**p by square-and-multiply from 1.0 (one_q), as core/fixedpoint.qpow_int
FXP_DEVICE int32_t qpow_int(int32_t x, int p, const Epilogue& e) {
  int32_t out = e.one_q, base = x;
  while (p) {
    if (p & 1) out = qmul(out, base, e);
    base = qmul(base, base, e);
    p >>= 1;
  }
  return out;
}

// A sum of squares taken in int64 at every width (the reference's jnp.sum
// promotes), wrapped mod 2^64 by uint64_t arithmetic, then one rounded shift
// by m and saturation: core/fixedpoint.qsq_norm.
FXP_DEVICE int32_t sumsq_shift(uint64_t acc, const Epilogue& e) {
  return requant(u2s(acc), e.m, e.qmin, e.qmax);
}

// The whole layer epilogue on one int32 accumulator (already wrapped at 32
// bits): requantize, saturating bias add, activation.  Returns a value in
// the output container's range.
FXP_DEVICE int32_t layer_epilogue(uint32_t acc, int32_t bias,
                                                  const Epilogue& e) {
  int32_t h = requant((int64_t)u2s32(acc), e.shift, e.qmin, e.qmax);
  h = sat((int64_t)h + (int64_t)bias, e.qmin, e.qmax);
  switch (e.act) {
    case kExact: return qsig_exact(h, e);
    case kRational: return qsig_rational(h, e);
    case kPwl2: return qsig_pwl2(h, e);
    case kPwl4: return qsig_pwl4(h, e);
    default: return h;
  }
}

#if defined(__CUDACC__)

// What the current device holds at once of `kernel` launched with `threads`
// threads and `smem` bytes of dynamic shared memory: blocks (SMs x blocks
// per SM) when `cluster` is 1, else thread block clusters of `cluster`
// blocks along x (cudaOccupancyMaxActiveClusters).  Queried once per
// (device, kernel, threads, smem, cluster) and cached, the kernel's
// shared-memory limit raised where needed, so that a launch makes no
// occupancy query of its own.  A configuration the card cannot hold even
// once is refused with cudaErrorInvalidConfiguration.
template <typename Kernel>
cudaError_t launch_slots(Kernel kernel, int threads, int smem, int* slots,
                         int cluster = 1) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, int, int>, int> cache;
  static std::map<std::pair<int, const void*>, int> limit;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, fn, threads, smem, cluster);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *slots = hit->second;
    return cudaSuccess;
  }
  int& set = limit[std::make_pair(dev, fn)];
  if (smem > set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set = smem;
  }
  int n = 0;
  if (cluster == 1) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    n = sms * per_sm;
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cluster);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
    if (err != cudaSuccess) return err;
  }
  if (n < 1) return cudaErrorInvalidConfiguration;
  *slots = n;
  cache[key] = n;
  return cudaSuccess;
}

#endif  // __CUDACC__

}  // namespace fxp
