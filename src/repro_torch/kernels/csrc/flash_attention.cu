// flash_attention: causal or full softmax attention over (BH, S, dh) query
// tensors and (BH / G, S, dh) key/value tensors, float32 or bfloat16, with
// the online (max, sum, acc) softmax in float32, optionally within a sliding
// window.
//
// Replaces the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (body _kernel),
// whose grid walks (BH, S/bq, S/bk) in order and carries the running max,
// sum and accumulator of one query block in VMEM scratch across the KV axis.
// Here one block owns one (bh, query tile) and walks the key tiles itself,
// so the carry lives in registers.  What it computes is _kernel's function:
//   scores q.k^T in float32, then * the caller's scale (float32(1/sqrt(dh))
//   unless the model states another);
//   masked entries set to -1e30, not -inf;
//   online m, l, acc in float32: m' = max(m, rowmax(s)), alpha = exp(m - m'),
//   p = exp(s - m'), l = l*alpha + rowsum(p), acc = acc*alpha + p.v;
//   key tiles strictly above the diagonal skipped when causal;
//   output acc / max(l, 1e-30), cast to the input type.
// Unlike the TPU kernel it takes any S: key rows past S are zero-filled and
// masked (their p is exactly 0), query rows past S are computed and not
// written.
//
// The sliding window is the reference LM's blockwise_attention mask
// (repro/lm/attention.py, the TPU kernel's source): with window > 0 the
// score at (q, k) is masked to -1e30 where q - k >= window, causal or not.
// It is a runtime argument of the same instances.  Key tiles wholly before
// q0 - window + 1 (q0 the block's first query) are masked for every row of
// the block and are skipped, not loaded: the loop's first tile moves up as
// the causal bound moves its last, so a causal windowed block walks about
// window / BK + 1 tiles.  A row of the first tile walked may have every key
// masked there (its window starts in a later tile): its running max is then
// -1e30 and its p are exp(0) = 1, and the first tile that holds one of its
// keys sets alpha = exp(-1e30 - m) = 0, which clears l and acc.  Every row
// keeps its diagonal key, so every row's max is finite by the last tile and
// a masked entry's exp(-1e30 - m) is 0, as in the TPU kernel.
//
// Grouped-query attention is in the kernel: query row bh reads key/value row
// bh / G (G query heads per KV head; for bh = b*H + h with G dividing H that
// is b*(H/G) + h/G, the mapping of the reference LM's _grouped_scores), so
// the caller does not repeat K and V.
//
// Bound on the H100: operations.  4*S^2*dh/2 flops per causal head against
// 2*S*dh*(1 + 2/G) input and output elements: at S = 2048 the work is ~1000x
// the bytes, so the bf16 tensor cores' 989 Tflop/s set the bound.  Within a
// window W the pairs are about S*W, still ~W/2 flops a byte.
//
// bfloat16 (the LM's prefill) runs on Hopper's warpgroup MMA (wgmma), the
// only route to the tensor cores' full rate, fed by the Tensor Memory
// Accelerator (TMA), with the warps specialised:
//   * a block owns 128 query rows of one head and has three warpgroups: a
//     producer, whose one thread starts every TMA load and which gives up
//     its registers (setmaxnreg), and two consumers of 64 rows each, which
//     take them;
//   * Q (128 rows) is loaded once; K and V tiles of BK keys (128 at dh 32
//     and 64, 96 at dh 128, 48 at dh 192 and 224: a consumer holds
//     S, P and O at once, in the ~180 registers ptxas grants it) pass
//     through a two-stage ring with a full and an empty mbarrier per tile
//     and stage, so a consumer starts Q.K^T as soon as K lands.  The tensor
//     maps are 3-D, (dh, S, rows), with the swizzle wgmma's shared-memory
//     descriptors read (128 bytes; 64 at dh 32 and 224): a tile is loaded
//     as dh/64 column chunks of 128-byte rows (dh 32 and 224: dh/32 chunks
//     of 64-byte rows).  Rows past S come back zero-filled;
//     K/V are read at row bh / G;
//   * S = Q.K^T is one wgmma m64nBKk16 per 16 dims, both operands in shared
//     memory, float32 accumulators.  P becomes bf16 in registers, the A
//     operand of O += P.V, whose B operand is V read through a transposed
//     (MN-major) descriptor: P never goes through shared memory;
//   * the consumers take turns on the tensor cores (two named barriers):
//     one starts its P.V and its next Q.K^T while the other runs its
//     softmax, and within a turn the softmax of the next tile's scores runs
//     while the warpgroup's own P.V is still on the tensor cores;
//   * scale and mask are applied in registers (in the log2 domain: exp2 of
//     scores pre-multiplied by log2(e), on the special-function unit with
//     results below 2^-126 flushed to 0); only a consumer's diagonal tile,
//     the ragged last tile and the window's lower edge pay for the compares.
//     Row max is two __shfl_xor_sync steps within the quad holding a row;
//     the row sum stays per thread until the end;
//   * the output is normalized, staged swizzled in the consumer's own rows
//     of the Q tile and written by one TMA store a chunk, which clips the
//     rows past S;
//   * the tensor maps are encoded on the host for each call
//     (cuTensorMapEncodeTiled, looked up through the CUDA runtime's
//     entry-point query), passed as __grid_constant__ parameters; one launch a call,
//     nothing allocated;
//   * the heaviest (last) query tiles of a causal launch are scheduled
//     first (blockIdx.y counts down from the last tile).
// Rounding P to bf16 before P.V is the one approximation the float32
// reference does not make (Q.K^T is exact: bf16 products accumulate in
// float32); it holds the bf16 bounds (3e-2 against the plain version, and
// the LM prefill's).
//
// float32 keeps the first version's CUDA-core path (tensor-core TF32 would
// not hold the 2e-5 tolerance): K/V tiles staged in shared memory as
// float32, each thread a 4x4 (rows x keys) micro-tile of scores and a
// 4 x dh/16 slice of the accumulator in registers, the 16 threads of a row
// group reducing max and sum with warp shuffles.
#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile

constexpr int kThreads = 256;  // 16 row groups of 4 rows x 16 key lanes
constexpr int kRows = 4;       // query rows per thread
constexpr int kLanes = 16;     // threads sharing one row group
constexpr int kKeys = kBK / kLanes;  // keys per thread per tile
constexpr int kPStride = 68;   // P row stride: rows 4 apart land 16 banks apart

template <int DH>
constexpr size_t smem_bytes() {
  // Q and K rows padded by one float (conflict-free column reads), V as is,
  // then the tile's probabilities.
  return sizeof(float) *
         (size_t)(kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH + kBQ * kPStride);
}

// rows [row0, row0 + n) of a (S, DH) slab into a float tile of row stride
// `stride`; rows at or past `s` become zeros.
template <int DH>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int row0, int s, float* tile,
                                          int stride, int n) {
  for (int idx = threadIdx.x; idx < n * DH; idx += kThreads) {
    const int r = idx / DH, c = idx - r * DH;
    const int row = row0 + r;
    tile[r * stride + c] = row < s ? src[(long long)row * DH + c] : 0.0f;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int s, float scale, int causal, int window,
                       int group) {
  constexpr int kQS = DH + 1, kKS = DH + 1, kDims = DH / kLanes;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * kQS;
  float* vs = ks + kBK * kKS;
  float* ps = vs + kBK * DH;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kBQ;
  const long long base = (long long)bh * s * DH;
  const long long kv_base = (long long)(bh / group) * s * DH;
  const int lane = threadIdx.x % kLanes;  // key lane / output-dim lane
  const int r0 = (threadIdx.x / kLanes) * kRows;  // first of my 4 rows

  load_tile<DH>(q + base, q0, s, qs, kQS, kBQ);

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[i][e] = 0.0f;
  }

  const int k_tiles = (s + kBK - 1) / kBK;
  const int n_tiles = causal ? min(k_tiles, qt + 1) : k_tiles;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  for (int kt = kt_lo; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<DH>(k + kv_base, k0, s, ks, kKS, kBK);
    load_tile<DH>(v + kv_base, k0, s, vs, DH, kBK);
    __syncthreads();

    float sc[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(r0 + i) * kQS + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = ks[(lane + kLanes * j) * kKS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + r0 + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kpos = k0 + lane + kLanes * j;
        float x = sc[i][j] * scale;
        if (kpos >= s || (causal && kpos > qpos) ||
            (window > 0 && qpos - kpos >= window))
          x = kNegInf;
        sc[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(r0 + i) * kPStride + lane + kLanes * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[i][e] *= alpha;
    }
    // A row group's P is written and read by its own 16 lanes, which share
    // a warp.
    __syncwarp();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[kDims];
#pragma unroll
      for (int e = 0; e < kDims; ++e) vv[e] = vs[kk * DH + lane + kLanes * e];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[(r0 + i) * kPStride + kk];
#pragma unroll
        for (int e = 0; e < kDims; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + r0 + i;
    if (qpos >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* row = o + base + (long long)qpos * DH;
#pragma unroll
    for (int e = 0; e < kDims; ++e) row[lane + kLanes * e] = acc[i][e] / denom;
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s, float scale, int causal, int window, int group,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)bh, (unsigned)((s + kBQ - 1) / kBQ));
  flash_attention_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s, scale, causal,
      window, group);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: warpgroup MMA (wgmma) fed by TMA, one producer and two consumers
// ---------------------------------------------------------------------------
namespace bf16 {

constexpr int kBQ = 128;       // query rows per block
constexpr int kWgRows = 64;    // query rows per consumer warpgroup
constexpr int kThreads = 384;  // the producer warpgroup, then two consumers
constexpr int kStages = 2;     // K/V ring depth
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128*24 + 256*240
constexpr int kTurnBar = 1;   // named barrier + consumer: its tensor-core turn
constexpr int kStoreBar = 3;  // named barrier + consumer: its output staged
constexpr float kLog2e = 1.4426950408889634f;

// Each head dim's key tile rows and swizzle span (bytes a shared-memory
// row).  A consumer thread holds S (kBK/2 floats), P (kBK/4 bf16 pairs)
// and O (dh/2 floats) at once, and under the 384-thread launch bound ptxas
// grants the consumers ~165-180 registers (setmaxnreg's 240 notwith-
// standing); past that it spills P and serializes the wgmmas.  So the key
// tile narrows as dh grows.
template <int DH>
struct Tile;
template <>
struct Tile<32> {
  static constexpr int kBK = 128, kSw = 64;
};
template <>
struct Tile<64> {
  static constexpr int kBK = 128, kSw = 128;
};
template <>
struct Tile<128> {
  static constexpr int kBK = 96, kSw = 128;
};
template <>
struct Tile<192> {
  static constexpr int kBK = 48, kSw = 128;
};
// dh 224 is 3.5 chunks of 128-byte rows: it takes 64-byte rows, seven
// chunks of 32 columns, each a whole swizzle atom, so Q.K^T is 14 k-steps
// and P.V one m64n224 wgmma with nothing padded.  O is 112 floats a
// thread; 48-key tiles (S 24, P 12) stay unserialized and unspilled, and
// ran 0.471 ms against 32-key tiles' 0.547 at (BH 32, S 4096), causal.
template <>
struct Tile<224> {
  static constexpr int kBK = 48, kSw = 64;
};

// Shared memory, in bytes from a 1024-aligned base: the Q tile, kStages K
// tiles, kStages V tiles, then the mbarriers.  A tile of R rows is dh/kCols
// column chunks of R swizzled rows of kSw bytes, one TMA box each.
template <int DH>
struct Smem {
  static constexpr int kBK = Tile<DH>::kBK;
  static constexpr int kSw = Tile<DH>::kSw;
  static constexpr int kCols = kSw / 2;  // bf16 columns a chunk
  static constexpr int kChunks = DH / kCols;
  static constexpr int kQBytes = kBQ * DH * 2;
  static constexpr int kKvBytes = kBK * DH * 2;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKvBytes;
  static constexpr int kBars = kV + kStages * kKvBytes;
  // q_full, then per stage k_full, v_full, k_empty, v_empty
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages) + 1024;
  static_assert(kBytes <= 232448, "shared memory of one block");
  static_assert(kKvBytes % 1024 == 0 && kBK * kSw % 1024 == 0,
                "chunks on swizzle-atom boundaries");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of byte `colb` of row `row` in a swizzled chunk: the 16-byte
// unit is XORed with bits 7.. of the row's offset (TMA's 128- and 64-byte
// swizzles, wgmma's layouts of the same names).
template <int SW>
__device__ __forceinline__ uint32_t swz(int row, int colb) {
  const int off = row * SW;
  return off + (colb ^ (((off >> 7) & (SW / 16 - 1)) << 4));
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1: 128-byte, 2: 64-byte).
template <int SW>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  constexpr uint64_t kMode = SW == 128 ? 1 : 2;
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | kMode << 62;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the phase of parity `parity` to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Box (c0, c1, c2) of a 3-D tensor map into shared memory at `dst`;
// completes `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler may
// not move their uses across this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// Two floats as one bf16x2 register (lo in the low half), round to nearest
// even.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma instructions, one per shape: a warpgroup's 64 rows by N.  The
// accumulator d[N/2] of a thread holds, for each 8-column block j, rows r
// and r + 8 (r = 16 * warp + lane / 4) at columns 8j + 2 * (lane % 4) + {0,
// 1}: d[4j], d[4j+1] for row r, d[4j+2], d[4j+3] for row r + 8.
template <int N>
struct QkMma;
template <int N>
struct PvMma;

template <>
struct QkMma<32> {
  // d (+)= A . B^T, A and B K-major in shared memory (descriptors)
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct QkMma<48> {
  // d (+)= A . B^T, A and B K-major in shared memory (descriptors)
  static __device__ __forceinline__ void ss(float (&d)[24], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct QkMma<96> {
  // d (+)= A . B^T, A and B K-major in shared memory (descriptors)
  static __device__ __forceinline__ void ss(float (&d)[48], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct QkMma<128> {
  // d (+)= A . B^T, A and B K-major in shared memory (descriptors)
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct PvMma<32> {
  // d += A . B, A (bf16 pairs) in registers, B MN-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct PvMma<64> {
  // d += A . B, A (bf16 pairs) in registers, B MN-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct PvMma<128> {
  // d += A . B, A (bf16 pairs) in registers, B MN-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct PvMma<192> {
  // d += A . B, A (bf16 pairs) in registers, B MN-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[96],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct PvMma<224> {
  // d += A . B, A (bf16 pairs) in registers, B MN-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[112],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
      "%106, %107, %108, %109, %110, %111}, "
      "{%112, %113, %114, %115}, %116, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// S = Q . K^T for one consumer: DH/16 wgmmas, both operands K-major in
// shared memory.  `qd` and `kd` describe the first chunk of the consumer's
// Q rows and of the K tile; a 16-dim step is 32 bytes into a chunk's
// swizzled rows, a chunk R * kSw bytes on (added to the address field).
template <int DH>
__device__ __forceinline__ void async_qk(float (&sc)[Tile<DH>::kBK / 2],
                                         uint64_t qd, uint64_t kd) {
  using L = Smem<DH>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int chunk = kk * 16 / L::kCols;
    const int colb = (kk * 16 % L::kCols) * 2;
    QkMma<L::kBK>::ss(sc, qd + ((chunk * kBQ * L::kSw + colb) >> 4),
                      kd + ((chunk * L::kBK * L::kSw + colb) >> 4), kk > 0);
  }
}

// O += P . V for one consumer: BK/16 wgmmas, P's bf16 pairs in registers,
// V MN-major (dh contiguous) from `vd`, which describes the V tile: a
// 16-key step is 16 rows on, the next chunk of columns the leading byte
// offset on, the next 8 keys the stride byte offset on.
template <int DH>
__device__ __forceinline__ void async_pv(
    float (&o)[DH / 2], const uint32_t (&p)[Tile<DH>::kBK / 16][4],
    uint64_t vd) {
  using L = Smem<DH>;
#pragma unroll
  for (int kj = 0; kj < L::kBK / 16; ++kj)
    PvMma<DH>::rs(o, p[kj], vd + ((kj * 16 * L::kSw) >> 4));
}

// A descriptor the compiler must rebuild where it is used, not hold in
// registers across the loop.
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// 2^x on the special-function unit, results below 2^-126 flushed to 0 (p
// that small add nothing to l >= 1 or to the float32 accumulator).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's scores of rows a and b: scale (log2 domain), mask where the
// tile can hold masked keys, row max over the quad, p = exp2(x - m') in
// place, l updated; returns alpha = exp2(m - m') of each row.
template <int NS>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[NS], bool need_mask, int k0, int row_a, int row_b, int s,
    int causal, int window, float scale_log2, float& m_a, float& m_b,
    float& l_a, float& l_b, float& alpha_a, float& alpha_b) {
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] *= scale_log2;
  if (need_mask) {
    const int key0 = k0 + (threadIdx.x % 4) * 2;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int key = key0 + 8 * (i / 4) + (i & 1);
      const int row = (i & 2) ? row_b : row_a;
      if (key >= s || (causal && key > row) ||
          (window > 0 && row - key >= window))
        sc[i] = kNegInf;
    }
  }
  float mt_a = kNegInf, mt_b = kNegInf;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    mt_a = fmaxf(mt_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mt_b = fmaxf(mt_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // the quad holding a row
    mt_a = fmaxf(mt_a, __shfl_xor_sync(0xffffffffu, mt_a, off));
    mt_b = fmaxf(mt_b, __shfl_xor_sync(0xffffffffu, mt_b, off));
  }
  const float mn_a = fmaxf(m_a, mt_a), mn_b = fmaxf(m_b, mt_b);
  alpha_a = exp2_ftz(m_a - mn_a);
  alpha_b = exp2_ftz(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    sc[4 * j] = exp2_ftz(sc[4 * j] - mn_a);
    sc[4 * j + 1] = exp2_ftz(sc[4 * j + 1] - mn_a);
    sc[4 * j + 2] = exp2_ftz(sc[4 * j + 2] - mn_b);
    sc[4 * j + 3] = exp2_ftz(sc[4 * j + 3] - mn_b);
    sum_a += sc[4 * j] + sc[4 * j + 1];
    sum_b += sc[4 * j + 2] + sc[4 * j + 3];
  }
  // l stays a per-thread partial (alpha is uniform over the quad); the
  // quad's partials are summed once, after the last tile.
  l_a = l_a * alpha_a + sum_a;
  l_b = l_b * alpha_b + sum_b;
}

// acc *= alpha, then P's float32 scores as the bf16 A operand of P.V: the
// accumulators of keys 16j..16j+15 (8-column blocks 2j, 2j+1) are A's
// k-step j.
template <int NO, int NP>
__device__ __forceinline__ void rescale_and_pack(float (&o)[NO],
                                                 uint32_t (&p)[NP][4],
                                                 const float (&sc)[NP * 8],
                                                 float alpha_a,
                                                 float alpha_b) {
#pragma unroll
  for (int d = 0; d < NO / 4; ++d) {
    o[4 * d] *= alpha_a;
    o[4 * d + 1] *= alpha_a;
    o[4 * d + 2] *= alpha_b;
    o[4 * d + 3] *= alpha_b;
  }
#pragma unroll
  for (int kj = 0; kj < NP; ++kj) {
    p[kj][0] = pack(sc[8 * kj], sc[8 * kj + 1]);
    p[kj][1] = pack(sc[8 * kj + 2], sc[8 * kj + 3]);
    p[kj][2] = pack(sc[8 * kj + 4], sc[8 * kj + 5]);
    p[kj][3] = pack(sc[8 * kj + 6], sc[8 * kj + 7]);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, int s,
                       float scale_log2, int causal, int window, int group) {
  using L = Smem<DH>;
  constexpr int kBK = L::kBK, kSw = L::kSw, kCols = L::kCols;
  constexpr int kNS = kBK / 2, kNO = DH / 2, kNP = kBK / 16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kBQ;
  const int k_tiles = (s + kBK - 1) / kBK;
  const int kt_hi =
      causal ? min(k_tiles, (q0 + kBQ - 1) / kBK + 1) : k_tiles;
  // the first key tile that holds a key of the block's window
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const int n = kt_hi - kt_lo;  // >= 1: every row keeps its own key

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 8);  // one arrival per consumer warp
      mbar_init(v_empty + 8 * st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that the compiler sees it is
  // uniform over the warp (wgmma must not sit on a divergent path)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int bkv = bh / group;
      mbar_expect(q_full, L::kQBytes);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(q_s + c * kBQ * kSw, &tq, c * kCols, q0, bh, q_full);
      for (int i = 0; i < n; ++i) {
        const int st = i % kStages;
        const uint32_t empty = ((i / kStages) & 1) ^ 1;
        const int k0 = (kt_lo + i) * kBK;
        const uint32_t kt = k_s + st * L::kKvBytes;
        const uint32_t vt = v_s + st * L::kKvBytes;
        mbar_wait(k_empty + 8 * st, empty);
        mbar_expect(k_full + 8 * st, L::kKvBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(kt + c * kBK * kSw, &tk, c * kCols, k0, bkv,
                   k_full + 8 * st);
        mbar_wait(v_empty + 8 * st, empty);
        mbar_expect(v_full + 8 * st, L::kKvBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(vt + c * kBK * kSw, &tv, c * kCols, k0, bkv,
                   v_full + 8 * st);
      }
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;  // consumer 0 or 1
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int q_lo = q0 + cw * kWgRows;  // the consumer's first row
  const int row_a = q_lo + warp * 16 + lane / 4;  // fragment rows: a, a + 8
  const int row_b = row_a + 8;
  const uint32_t q_rows = q_s + cw * kWgRows * kSw;
  const int my_turn = kTurnBar + cw, other_turn = kTurnBar + (cw ^ 1);
  const uint64_t q_desc = desc<kSw>(q_rows, 16, 8 * kSw);
  const uint64_t k_desc = desc<kSw>(k_s, 16, 8 * kSw);
  const uint64_t v_desc = desc<kSw>(v_s, kBK * kSw, 8 * kSw);
  constexpr int kStageUnits = L::kKvBytes >> 4;  // a stage, in 16 bytes

  float sc[kNS], o[kNO];
  uint32_t p[kNP][4];
#pragma unroll
  for (int i = 0; i < kNS; ++i) sc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kNO; ++i) o[i] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;
  float alpha_a, alpha_b;
  // a tile's scores need masks where it can hold a masked key of this
  // consumer's rows: the ragged edge, the diagonal, the window's lower edge
  const auto need_mask = [&](int k0) {
    return (k0 + kBK > s) || (causal && k0 + kBK - 1 > q_lo) ||
           (window > 0 && q_lo + kWgRows - 1 - k0 >= window);
  };

  if (cw == 1) named_arrive(other_turn, 256);  // consumer 0 goes first
  mbar_wait(q_full, 0);

  // the first tile's scores
  mbar_wait(k_full, 0);
  named_sync(my_turn, 256);
  pin(sc);
  wgmma_fence();
  async_qk<DH>(sc, opaque(q_desc), opaque(k_desc));
  wgmma_commit();
  named_arrive(other_turn, 256);
  wgmma_wait<0>();
  pin(sc);
  if (lane == 0) mbar_arrive(k_empty);
  softmax_tile(sc, need_mask(kt_lo * kBK), kt_lo * kBK, row_a, row_b, s,
               causal, window, scale_log2, m_a, m_b, l_a, l_b, alpha_a,
               alpha_b);
  rescale_and_pack(o, p, sc, alpha_a, alpha_b);

  // every tile but the last: in my turn the next tile's Q.K^T and this
  // tile's P.V; the next tile's softmax runs while P.V is on the tensor
  // cores
  for (int i = 0; i + 1 < n; ++i) {
    const int st = i % kStages, nst = (i + 1) % kStages;
    mbar_wait(v_full + 8 * st, (i / kStages) & 1);
    mbar_wait(k_full + 8 * nst, ((i + 1) / kStages) & 1);
    named_sync(my_turn, 256);
    pin(o);
    pin(sc);
    pin(p);
    wgmma_fence();
    async_qk<DH>(sc, opaque(q_desc), opaque(k_desc) + nst * kStageUnits);
    wgmma_commit();
    async_pv<DH>(o, p, opaque(v_desc) + st * kStageUnits);
    wgmma_commit();
    named_arrive(other_turn, 256);
    wgmma_wait<1>();
    pin(sc);
    if (lane == 0) mbar_arrive(k_empty + 8 * nst);
    const int k0 = (kt_lo + i + 1) * kBK;
    softmax_tile(sc, need_mask(k0), k0, row_a, row_b, s, causal, window,
                 scale_log2, m_a, m_b, l_a, l_b, alpha_a, alpha_b);
    wgmma_wait<0>();
    pin(o);
    pin(p);
    if (lane == 0) mbar_arrive(v_empty + 8 * st);
    rescale_and_pack(o, p, sc, alpha_a, alpha_b);
  }

  // the last tile's P.V (consumer 1's last turn hands over to nobody)
  {
    const int st = (n - 1) % kStages;
    mbar_wait(v_full + 8 * st, ((n - 1) / kStages) & 1);
    named_sync(my_turn, 256);
    pin(o);
    pin(p);
    wgmma_fence();
    async_pv<DH>(o, p, opaque(v_desc) + st * kStageUnits);
    wgmma_commit();
    if (cw == 0) named_arrive(other_turn, 256);
    wgmma_wait<0>();
    pin(o);
    pin(p);
  }

  // epilogue: normalize, stage in the consumer's own rows of the Q tile
  // (swizzled as the tensor map reads them), one TMA store a chunk
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  const int tr = cw * kWgRows + warp * 16 + lane / 4;  // row in the Q tile
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const uint32_t chunk = q_s + (8 * j / kCols) * kBQ * kSw;
    const int colb = (8 * j % kCols) * 2 + (lane % 4) * 4;
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(chunk + swz<kSw>(tr, colb)),
                 "r"(pack(o[4 * j] / den_a, o[4 * j + 1] / den_a))
                 : "memory");
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                     chunk + swz<kSw>(tr + 8, colb)),
                 "r"(pack(o[4 * j + 2] / den_b, o[4 * j + 3] / den_b))
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(kStoreBar + cw, 128);
  if (tid == 0) {
    for (int c = 0; c < L::kChunks; ++c)
      tma_store(&to, q_rows + c * kBQ * kSw, c * kCols, q_lo, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (the library links
// libcudart, not libcuda); null where the installed CUDA lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* fp = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fp, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fp, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(fp)
               : nullptr;
  }();
  return fn;
}

// A contiguous (rows, s, DH) bf16 tensor as boxes of `box_rows` rows by one
// chunk of columns, swizzled as Smem<DH> lays them out.
template <int DH>
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int s,
                int box_rows) {
  using L = Smem<DH>;
  const cuuint64_t dims[3] = {(cuuint64_t)DH, (cuuint64_t)s,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)DH * 2,
                                 (cuuint64_t)s * DH * 2};
  const cuuint32_t box[3] = {(cuuint32_t)L::kCols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode_tiled()(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             L::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s, float scale, int causal, int window, int group,
           cudaStream_t stream) {
  using L = Smem<DH>;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map<DH>(&tq, q, bh, s, kBQ) ||
      !tensor_map<DH>(&tk, k, bh / group, s, L::kBK) ||
      !tensor_map<DH>(&tv, v, bh / group, s, L::kBK) ||
      !tensor_map<DH>(&to, o, bh, s, kWgRows))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)bh, (unsigned)((s + kBQ - 1) / kBQ));
  flash_attention_kernel<DH><<<grid, kThreads, L::kBytes, stream>>>(
      tq, tk, tv, to, s, scale * kLog2e, causal, window, group);
  return (int)cudaGetLastError();
}

}  // namespace bf16

template <int DH>
int launch_dtype(const void* q, const void* k, const void* v, void* o, int bh,
                 int s, int dtype, float scale, int causal, int window,
                 int group, cudaStream_t stream) {
  if (dtype == 0)
    return f32::launch<DH>(q, k, v, o, bh, s, scale, causal, window, group,
                           stream);
  if (dtype == 1)
    return bf16::launch<DH>(q, k, v, o, bh, s, scale, causal, window, group,
                            stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o: contiguous (bh, s, dh) tensors; k, v: contiguous (bh / group, s, dh)
// tensors, all of one type and 16-byte aligned, o not overlapping the
// inputs.  Query row r reads key/value row r / group.  dtype: 0 float32,
// 1 bfloat16.  dh: 32, 64, 128, 192 (MLA's 128 + 64 rotary dims; the
// 192 instance holds 96 float32 accumulators a thread in bf16 and 161.5 KB
// of shared memory in float32) or 224 (Zamba2's shared block: 112
// accumulators in bf16, 185.5 KB in float32).  scale: the scores' factor,
// float32(1/sqrt(dh)) unless the model states another.  causal: 0 or 1.  window: the sliding window (q - k >= window masked), <= 0 for
// none.  Launches on the calling thread's current device.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh, int s,
                                      int dh, int dtype, float scale,
                                      int causal, int window, int group,
                                      void* stream) {
  if (bh <= 0 || s <= 0 || (s + f32::kBQ - 1) / f32::kBQ > 65535 || group <= 0 ||
      bh % group != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch_dtype<32>(q, k, v, o, bh, s, dtype, scale, causal,
                              window, group, st);
    case 64:
      return launch_dtype<64>(q, k, v, o, bh, s, dtype, scale, causal,
                              window, group, st);
    case 128:
      return launch_dtype<128>(q, k, v, o, bh, s, dtype, scale, causal,
                               window, group, st);
    case 192:
      return launch_dtype<192>(q, k, v, o, bh, s, dtype, scale, causal,
                               window, group, st);
    case 224:
      return launch_dtype<224>(q, k, v, o, bh, s, dtype, scale, causal,
                               window, group, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
