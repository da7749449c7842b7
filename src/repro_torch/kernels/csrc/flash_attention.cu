// flash_attention: causal or full softmax attention over (BH, S, dh) query
// tensors and (BH / G, S, dh) key/value tensors, float32 or bfloat16, with
// the online (max, sum, acc) softmax in float32, optionally within a sliding
// window.
//
// Replaces the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (body _kernel),
// whose grid walks (BH, S/bq, S/bk) in order and carries the running max,
// sum and accumulator of one query block in VMEM scratch across the KV axis.
// Here one block owns one (bh, 64-query tile) and walks the key tiles itself,
// so the carry lives in registers.  What it computes is _kernel's function:
//   scores q.k^T in float32, then * float32(1/sqrt(dh)) (the caller's scale);
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
// window / 64 + 1 tiles.  A row of the first tile walked may have every key
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
// bfloat16 (the LM's prefill) runs FlashAttention-2 on the tensor cores
// (mma.sync m16n8k16, bf16 operands, float32 accumulators):
//   * a block is 4 warps and 64 query rows; each warp owns 16 rows, loads
//     their Q A-fragments once (ldmatrix) and keeps them in registers for
//     the whole key loop;
//   * K and V tiles (64 keys) stay bf16 in shared memory, in a two-stage
//     ring fed by 16-byte cp.async.cg (rows past S zero-filled by a source
//     size of 0), the next tile's copy in flight during this tile's math;
//     16-byte chunks are XOR-swizzled by row, so ldmatrix (K) and
//     ldmatrix.trans (V) read eight rows of one chunk column from eight
//     distinct bank groups;
//   * scale and mask are applied to the score fragments in registers (in
//     the log2 domain, exp2 of scores pre-multiplied by log2(e)), and only
//     the diagonal tile and the ragged last tile pay for the compares; row
//     max is two __shfl_xor_sync steps within the quad holding a row, and
//     the row sum stays per thread until the end;
//   * P's accumulator fragments become bf16 A-fragments of P.V in
//     registers, never through shared memory; l sums the float32 p;
//   * the output is normalized, staged through the warp's own rows of the Q
//     tile and written with 16-byte stores;
//   * the heaviest (last) query tiles of a causal launch are scheduled
//     first.
// Rounding P to bf16 before P.V is the one approximation the float32
// reference does not make (Q.K^T is exact: bf16 products accumulate in
// float32); it holds the bf16 bounds (3e-2 against the plain version, and
// the LM prefill's), and were it not to, P would go through two MMAs as
// bf16 hi + lo terms.  Left for later: a warpgroup (wgmma) consumer with a TMA
// producer warp, and skipping the all-masked 8-key blocks of the diagonal
// tile.
//
// float32 keeps the first version's CUDA-core path (tensor-core TF32 would
// not hold the 2e-5 tolerance): K/V tiles staged in shared memory as
// float32, each thread a 4x4 (rows x keys) micro-tile of scores and a
// 4 x dh/16 slice of the accumulator in registers, the 16 threads of a row
// group reducing max and sum with warp shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;  // query rows per block (both paths)
constexpr int kBK = 64;  // keys per tile (both paths)
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

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
// bfloat16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
namespace bf16 {

using bf16_t = __nv_bfloat16;

constexpr int kWarps = kBQ / 16;       // 16 query rows per warp
constexpr int kThreads = 32 * kWarps;  // 128
constexpr int kStages = 2;             // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kBQ == kBK, "the diagonal is one tile: masks only there");

template <int DH>
constexpr size_t smem_bytes() {
  // the Q tile, then kStages K tiles, then kStages V tiles, all bf16
  return sizeof(bf16_t) * (size_t)(kBQ * DH + 2 * kStages * kBK * DH);
}

// Element offset of 16-byte chunk `chunk` of row `row` in a (rows, DH) bf16
// tile.  The chunk index is XORed with bits of the row so that the eight
// rows an ldmatrix phase reads at one logical chunk fall in eight distinct
// 16-byte bank groups (rows of dh 32 hold 4 chunks, two rows per 128 bytes).
template <int DH>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int kChunks = DH / 8;
  const int x = kChunks >= 8 ? (row & 7) : ((row >> 1) & 3);
  return row * DH + ((chunk ^ x) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c += a . b for one 16x8 tile: a 16x16 (row), b 16x8 (col), bf16 in,
// float32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register (lo in the low half), round to nearest
// even.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a (S, DH) bf16 slab into a swizzled tile,
// asynchronously; rows at or past `s` are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile_async(const bf16_t* __restrict__ src,
                                                int row0, int s,
                                                bf16_t* tile) {
  constexpr int kChunks = DH / 8;
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    const bool valid = row < s;
    cp_async16(smem_u32(tile + swz<DH>(r, c)),
               src + (long long)(valid ? row : 0) * DH + c * 8, valid);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const bf16_t* __restrict__ q,
                       const bf16_t* __restrict__ k,
                       const bf16_t* __restrict__ v, bf16_t* __restrict__ o,
                       int s, float scale_log2, int causal, int window,
                       int group) {
  constexpr int kChunks = DH / 8;    // 16-byte chunks per row
  constexpr int kKSteps = DH / 16;   // k-steps of Q.K^T
  constexpr int kDBlocks = DH / 8;   // 8-wide output column blocks
  constexpr int kNBlocks = kBK / 8;  // 8-key score column blocks
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem_raw);
  bf16_t* ks = qs + kBQ * DH;
  bf16_t* vs = ks + kStages * kBK * DH;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kBQ;
  const long long q_base = (long long)bh * s * DH;
  const long long kv_base = (long long)(bh / group) * s * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_a = q0 + warp * 16 + lane / 4;  // fragment rows: a, a + 8
  const int row_b = row_a + 8;
  const int k_tiles = (s + kBK - 1) / kBK;
  const int n_tiles = causal ? min(k_tiles, qt + 1) : k_tiles;
  // the first key tile that holds a key of the block's window
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  load_tile_async<DH>(q + q_base, q0, s, qs);
  load_tile_async<DH>(k + kv_base, kt_lo * kBK, s, ks);
  load_tile_async<DH>(v + kv_base, kt_lo * kBK, s, vs);
  cp_async_commit();

  uint32_t qf[kKSteps][4];
  float oacc[kDBlocks][4];
#pragma unroll
  for (int d = 0; d < kDBlocks; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;

  for (int kt = kt_lo; kt < n_tiles; ++kt) {
    const int st = (kt - kt_lo) % kStages;
    const int k0 = kt * kBK;
    if (kt + 1 < n_tiles) {  // the next tile's copy overlaps this one's math
      const int nst = (kt + 1 - kt_lo) % kStages;
      load_tile_async<DH>(k + kv_base, k0 + kBK, s, ks + nst * kBK * DH);
      load_tile_async<DH>(v + kv_base, k0 + kBK, s, vs + nst * kBK * DH);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == kt_lo) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldsm_x4(smem_u32(qs + swz<DH>(warp * 16 + lane % 16,
                                      2 * kk + lane / 16)),
                qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
    }
    const bf16_t* kt_s = ks + st * kBK * DH;
    const bf16_t* vt_s = vs + st * kBK * DH;

    // S = Q . K^T: 16 rows x 64 keys per warp
    float sc[kNBlocks][4];
#pragma unroll
    for (int nb = 0; nb < kNBlocks; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int nb = 0; nb < kNBlocks; nb += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(kt_s + swz<DH>(nb * 8 + lane % 8 + (lane / 16) * 8,
                                        2 * kk + (lane / 8) % 2)),
                b0, b1, b2, b3);
        mma(sc[nb], qf[kk], b0, b1);
        mma(sc[nb + 1], qf[kk], b2, b3);
      }
    }

    // scale (log2 domain), mask where a tile can hold masked keys (the
    // ragged edge, the diagonal, the window's lower edge), row max
    const bool need_mask = (k0 + kBK > s) || (causal && kt == qt) ||
                           (window > 0 && q0 + kBQ - 1 - k0 >= window);
    float mt_a = kNegInf, mt_b = kNegInf;
#pragma unroll
    for (int nb = 0; nb < kNBlocks; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nb][e] * scale_log2;
        if (need_mask) {
          const int key = k0 + nb * 8 + (lane % 4) * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (key >= s || (causal && key > row) ||
              (window > 0 && row - key >= window))
            x = kNegInf;
        }
        sc[nb][e] = x;
      }
      mt_a = fmaxf(mt_a, fmaxf(sc[nb][0], sc[nb][1]));
      mt_b = fmaxf(mt_b, fmaxf(sc[nb][2], sc[nb][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the quad holding a row
      mt_a = fmaxf(mt_a, __shfl_xor_sync(0xffffffffu, mt_a, off));
      mt_b = fmaxf(mt_b, __shfl_xor_sync(0xffffffffu, mt_b, off));
    }
    const float mn_a = fmaxf(m_a, mt_a), mn_b = fmaxf(m_b, mt_b);
    const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int nb = 0; nb < kNBlocks; ++nb) {
      sc[nb][0] = exp2f(sc[nb][0] - mn_a);
      sc[nb][1] = exp2f(sc[nb][1] - mn_a);
      sc[nb][2] = exp2f(sc[nb][2] - mn_b);
      sc[nb][3] = exp2f(sc[nb][3] - mn_b);
      sum_a += sc[nb][0] + sc[nb][1];
      sum_b += sc[nb][2] + sc[nb][3];
    }
    // l stays a per-thread partial (alpha is uniform over the quad); the
    // quad's partials are summed once, after the last tile.
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int d = 0; d < kDBlocks; ++d) {
      oacc[d][0] *= alpha_a;
      oacc[d][1] *= alpha_a;
      oacc[d][2] *= alpha_b;
      oacc[d][3] *= alpha_b;
    }

    // O += P . V: the score accumulators of keys 16j..16j+15 are the
    // A-fragment of k-step j (C layout of n-blocks 2j, 2j+1 = A layout).
#pragma unroll
    for (int kj = 0; kj < kBK / 16; ++kj) {
      uint32_t pa[4];
      pa[0] = pack(sc[2 * kj][0], sc[2 * kj][1]);
      pa[1] = pack(sc[2 * kj][2], sc[2 * kj][3]);
      pa[2] = pack(sc[2 * kj + 1][0], sc[2 * kj + 1][1]);
      pa[3] = pack(sc[2 * kj + 1][2], sc[2 * kj + 1][3]);
#pragma unroll
      for (int nd = 0; nd < kDBlocks; nd += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_u32(vt_s + swz<DH>(kj * 16 + lane % 16,
                                              nd + lane / 16)),
                      b0, b1, b2, b3);
        mma(oacc[nd], pa, b0, b1);
        mma(oacc[nd + 1], pa, b2, b3);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  // Stage the warp's 16 output rows in its own rows of the Q tile (no other
  // warp reads them), then write whole 16-byte chunks.
  const int wr = warp * 16 + lane / 4;
#pragma unroll
  for (int nd = 0; nd < kDBlocks; ++nd) {
    const int col = (lane % 4) * 2;
    *reinterpret_cast<uint32_t*>(qs + swz<DH>(wr, nd) + col) =
        pack(oacc[nd][0] / den_a, oacc[nd][1] / den_a);
    *reinterpret_cast<uint32_t*>(qs + swz<DH>(wr + 8, nd) + col) =
        pack(oacc[nd][2] / den_b, oacc[nd][3] / den_b);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = q0 + warp * 16 + r;
    if (row < s)
      *reinterpret_cast<int4*>(o + q_base + (long long)row * DH + c * 8) =
          *reinterpret_cast<const int4*>(qs + swz<DH>(warp * 16 + r, c));
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
      static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
      static_cast<const bf16_t*>(v), static_cast<bf16_t*>(o), s,
      scale * kLog2e, causal, window, group);
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
// 1 bfloat16.  dh: 32, 64, 128 or 192 (MLA's 128 + 64 rotary dims; the
// 192 instance holds 96 float32 accumulators a thread in bf16 and 161.5 KB
// of shared memory in float32).  scale: float32(1/sqrt(dh)).  causal: 0
// or 1.  window: the sliding window (q - k >= window masked), <= 0 for
// none.  Launches on the calling thread's current device.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh, int s,
                                      int dh, int dtype, float scale,
                                      int causal, int window, int group,
                                      void* stream) {
  if (bh <= 0 || s <= 0 || (s + kBQ - 1) / kBQ > 65535 || group <= 0 ||
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
    default:
      return (int)cudaErrorInvalidValue;
  }
}
