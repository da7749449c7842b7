// The int8 tensor-core building blocks shared by the MLP megakernel body
// (fxp_mlp_body.cuh) and the integer tile of fxp_qmatmul and fxp_layer's
// wide route (fxp_tile.cuh): shared-memory addressing, the 16-byte cp.async,
// ldmatrix, the four signedness mixes of mma.sync.m16n8k32 with s32
// accumulators, and the byte-plane splits of packed 16-bit values.
//
// The accumulators wrap (no .satfinite): every caller recombines its partial
// sums mod 2^32, where multiplication is a ring homomorphism, so a wrapped
// partial still gives the exact wrapping int32 dot of the Pallas kernels.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)

namespace fxp {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, of which the first n are read (n in 0..16) and
// the rest zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a . b for one m16n8k32 tile with int8 operands of the given
// signedness and s32 accumulators that wrap (no .satfinite).
#define FXP_MMA_K32(NAME, AT, BT)                                            \
  __device__ __forceinline__ void NAME(uint32_t(&c)[4], const uint32_t(&a)[4], \
                                       const uint32_t(&b)[2]) {             \
    asm("mma.sync.aligned.m16n8k32.row.col.s32." AT "." BT ".s32 "           \
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"            \
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])                     \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1])); \
  }
FXP_MMA_K32(mma_s8s8, "s8", "s8")
FXP_MMA_K32(mma_s8u8, "s8", "u8")
FXP_MMA_K32(mma_u8s8, "u8", "s8")
FXP_MMA_K32(mma_u8u8, "u8", "u8")
#undef FXP_MMA_K32

// Four 16-bit values (two words) -> their high bytes and their low bytes,
// each as one word of four int8 values in the same order.
__device__ __forceinline__ uint32_t hi_bytes(uint2 v) {
  return __byte_perm(v.x, v.y, 0x7531);
}
__device__ __forceinline__ uint32_t lo_bytes(uint2 v) {
  return __byte_perm(v.x, v.y, 0x6420);
}

__device__ __forceinline__ void ldsm_x4(const unsigned char* p,
                                        uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(const unsigned char* p,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

}  // namespace fxp

#endif  // __CUDACC__
