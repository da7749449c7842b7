// The body of the MLP megakernel: every layer of one model on its batch
// rows, in one launch.  Shared by fxp_mlp_model.cu (one model) and
// fxp_mlp_fleet.cu (E stacked models, blockIdx.y picks the model), so that
// slot e of a fleet launch computes exactly what model e's own launch
// computes.
//
// Every layer is an int32 dot that wraps mod 2^32, then the shared epilogue
// (fxp_common.cuh: requantize, saturating bias add, activation, narrowing to
// the container).  Two bodies compute it:
//
// * mlp_mma_block, for the 8- and 16-bit containers, on the int8 tensor
//   cores (mma.sync.m16n8k32, s32 accumulators, no .satfinite).  A 16-bit
//   value splits exactly into a signed high byte and an unsigned low byte,
//   x = 256 hi + lo, so
//       x.w = 65536 hi_x.hi_w + 256 (hi_x.lo_w + lo_x.hi_w) + lo_x.lo_w,
//   four int8 MMAs (s8.s8, s8.u8, u8.s8, u8.u8) into four accumulators.  No
//   partial sum can overflow (|hi.hi| <= 2^14, |hi.lo| < 2^15, |lo.lo| <
//   2^16 per product, K <= 3632), and multiplication mod 2^32 is a ring
//   homomorphism, so (hh << 16) + ((hl + lh) << 8) + ll in uint32_t is the
//   Pallas kernel's wrapping int32 dot bit for bit.  An 8-bit container is
//   one s8.s8 MMA.  The MMA, ldmatrix, cp.async and byte-split helpers live
//   in fxp_mma.cuh, shared with the integer tile of fxp_qmatmul
//   (fxp_tile.cuh).
//   - Activations live in shared memory across the layers (the megakernel):
//     at 16 bits as two byte planes, high and low, written split by the
//     input unpack and by each layer's epilogue, so the A fragments are one
//     ldmatrix a plane.  The weights stay 16-bit and k-major; ldmatrix.trans
//     gives the B fragments, split in registers (PRMT).  ldmatrix.trans
//     pairs k 2t, 2t+1, so the planes store each group of 16 k in the same
//     permuted order (plane_pos): a dot product does not see a permutation
//     of k shared by A and B.  At 8 bits the operands are the container
//     (activations k-contiguous, weights transposed, 32-bit loads).
//   - A tile is 16 batch rows (one m16 MMA tile): 3089 rows are 194 tiles.
//     Blocks are persistent and hold up to three warp groups of 8 warps,
//     each with its own barrier and buffers, walking row tiles on its own
//     (as many as fit, or fewer: the block-size tuner, kernels/tune.py,
//     caps the groups at 1, 2 or 3, a block's 16, 32 or 48 rows);
//     the block stages the weights once (zero-padded to K % 32 == 0 and
//     N % 8 == 0: zeros add nothing, so the padding is exact; by 16-byte
//     cp.async where the rows allow) and the layers' epilogues.  A tile's
//     rows are one contiguous run in global memory, copied by 16-byte
//     cp.async from the 16-byte boundary below its start (a fleet slice
//     starts at e.M.K elements, which is not aligned at M 3089, K 561),
//     zero-filled past its end, and unpacked through funnel shifts; the next
//     tile's copy is in flight while the current one runs its layers.
//     Models whose weights do not fit beside the activations stream them
//     through a chunk instead, one group a block.
//   - Each layer walks its outputs in chunks of 64 columns.  The 8 warps of
//     a group split a chunk's n8 tiles and, where there are fewer than 8
//     (N = 6: one tile), the k steps too (split-K), so every warp works on
//     the last layer and on a logistic fleet's single layer.  The warps'
//     recombined uint32 partials meet in a 16 x 64 scratch tile (shared-
//     memory atomicAdd, exact mod 2^32 in any order), and the group's 256
//     threads run the epilogue on it, biases and epilogue rows read from
//     shared memory.
//   - Row strides are odd multiples of 16 bytes: eight rows at one column
//     fall in eight distinct bank groups (ldmatrix phases, 32-bit fragment
//     loads, the transposed 8-bit staging).
//   - Bound: bytes on paper (four int8 MMAs a 16-bit product at 1,979 Top/s
//     take ~0.45 us for 561->64->6 at 3089 rows, its input ~1.04 us at 3.35
//     TB/s), so wgmma was not taken.  On the card the layer epilogue (the
//     exact sigmoid's 64-bit division) and mma.sync's int8 rate, well below
//     wgmma's, bound it first (PERF.md, Findings).
// * mlp_block_cuda_cores, for the 32-bit container: int32 multiply-adds on
//   the CUDA cores (the int8 MMAs of a four-byte split would take 10
//   products per multiply-add).  A block owns BM rows (16, 32 or 64, an
//   instance each, the tuner's choice; kMlpBM by default), and each thread
//   computes kMlpTM rows of one output column so one weight load feeds
//   kMlpTM multiply-adds.
#pragma once

#include <cstddef>
#include <type_traits>

#include "fxp_common.cuh"
#include "fxp_mma.cuh"

namespace fxp {

constexpr int kMlpMaxLayers = 8;
constexpr int kMlpThreads = 256;
constexpr int kMlpWarps = kMlpThreads / 32;
// CUDA-core body: its default rows per block, and rows per thread.  kMlpBM
// is also the `bm` of the routing count (MODEL_BLOCK_M in kernels/tune.py:
// mlp_fits_smem sizes two kMlpBM x widest buffers), no longer the only
// block: the tuner picks 16, 32 or 64 rows, an instance each.
constexpr int kMlpBM = 32, kMlpTM = 4;
// Tensor-core body: rows per tile and output columns per chunk.
constexpr int kMmaBM = 16, kMmaNC = 64;
constexpr int kMlpSmemMax = 232448;  // one Hopper block's shared memory

struct MlpShape {
  int dims[kMlpMaxLayers + 1];
  int n_layers;
  int stride;  // the widest layer
};

// One layer of the block's model: weights (K, N) row-major and bias (N,).
template <typename T>
struct MlpLayer {
  const T* w;
  const T* b;
};

// Fills the host-side shape from the layer widths; false if a width is not
// positive or the layer count is out of range.
inline bool mlp_shape_from(const int* dims, int n_layers, MlpShape* s) {
  if (n_layers < 1 || n_layers > kMlpMaxLayers) return false;
  s->n_layers = n_layers;
  s->stride = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] <= 0) return false;
    s->dims[l] = dims[l];
    s->stride = dims[l] > s->stride ? dims[l] : s->stride;
  }
  return true;
}

// Shared memory of one CUDA-core block: two bm x stride buffers of T.
template <typename T>
inline size_t mlp_smem_bytes(const MlpShape& s, int bm = kMlpBM) {
  return 2 * (size_t)bm * s.stride * sizeof(T);
}

FXP_HOST_DEVICE int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Row strides are odd multiples of 16 bytes, so that eight rows at one
// column fall in eight distinct 16-byte bank groups: conflict-free ldmatrix
// phases, and 32-bit fragment loads (8 rows x 4 words) on 32 banks.
FXP_HOST_DEVICE int odd16(int row_bytes) {
  const int s = round_up(row_bytes, 16);
  return ((s / 16) & 1) ? s : s + 16;
}

// The row stride of a byte plane (or an 8-bit operand) of k elements a row,
// k padded to a multiple of 32.
FXP_HOST_DEVICE int mma_row_stride(int k) { return odd16(round_up(k, 32)); }

// The weights of a K x N layer in shared memory: at 16 bits row-major (K
// padded to 32 rows of N elements padded to 8; the B fragments come by
// ldmatrix.trans), at 8 bits transposed (N padded to 8 rows of K elements).
FXP_HOST_DEVICE int mma_weight_rows(int K, int N, int bytes) {
  return bytes == 2 ? round_up(K, 32) : round_up(N, 8);
}
FXP_HOST_DEVICE int mma_weight_stride(int K, int N, int bytes) {
  return bytes == 2 ? odd16(round_up(N, 8) * 2) : mma_row_stride(K);
}

// Where the tensor-core body keeps what in shared memory (byte offsets).
// Shared by the block: the layers' epilogues and, when they fit, every
// layer's weights.  Each warp group (kMlpThreads threads that run their own
// row tiles, behind their own named barrier) has a region of its own: the
// two activation buffers, the raw input tile, the partial-sum scratch, the
// bias chunk and, when the weights are streamed, the weight chunk.
struct MlpPlan {
  int groups;       // warp groups per block
  int resident;     // 1: every layer's weights staged once per block
  int epi_off;      // kMlpMaxLayers Epilogues
  int w_base;       // resident weights
  int w_off[kMlpMaxLayers], w_stride[kMlpMaxLayers];  // from w_base
  int group_off, group_bytes;  // group g's region at group_off + g * bytes
  // within a group's region:
  int x_off[2], x_stride[2];   // activations: even / odd layers' inputs,
                               // as `bytes` planes (high, low) of bytes
  int raw_off;                 // a tile's input rows as copied
  int scr_off;                 // kMmaBM x kMmaNC uint32 partial sums
  int bias_off;                // kMmaNC int32 biases of the chunk
  int wc_off, kc, wc_stride;   // streamed: kc x kMmaNC weights
  int total;                   // bytes of dynamic shared memory
};

constexpr int kMlpMaxGroups = 3;  // 768 threads: at most 85 registers
constexpr int kMlpEpiBytes = kMlpMaxLayers * (int)sizeof(Epilogue);

// Lays out shared memory for a model: resident weights with as many warp
// groups as fit, up to max_groups (3, 2, 1), else one group streaming the
// weights through the largest chunk that fits.  False if nothing fits one
// block.  Every model that mlp_fits_smem admits (2 * 32 * widest * bytes <=
// kMlpSmemMax) fits.
FXP_HOST_DEVICE bool mlp_plan(const MlpShape& s, int bytes, MlpPlan* p,
                              int max_groups = kMlpMaxGroups) {
  int wide[2] = {1, 1};  // the widest input of even and of odd layers
  for (int l = 0; l < s.n_layers; ++l)
    wide[l & 1] = s.dims[l] > wide[l & 1] ? s.dims[l] : wide[l & 1];
  int resident = 0;
  for (int l = 0; l < kMlpMaxLayers; ++l) {
    p->w_off[l] = resident;
    if (l >= s.n_layers) {
      p->w_stride[l] = 0;
      continue;
    }
    const int K = s.dims[l], N = s.dims[l + 1];
    p->w_stride[l] = mma_weight_stride(K, N, bytes);
    resident += mma_weight_rows(K, N, bytes) * p->w_stride[l];
  }
  int g = 0;
  for (int b = 0; b < 2; ++b) {  // `bytes` planes of kMmaBM rows of bytes
    p->x_stride[b] = mma_row_stride(wide[b]);
    p->x_off[b] = g;
    g += bytes * kMmaBM * p->x_stride[b];
  }
  p->raw_off = g;
  // a tile's rows, the 15-byte head below them, and what the unpack's
  // funnel shifts read past them (up to the 16-group end, and one word)
  g += round_up(kMmaBM * s.dims[0] * bytes + 15 + 32 * bytes + 8, 16);
  p->scr_off = g;
  g += kMmaBM * kMmaNC * 4;
  p->bias_off = g;
  g += kMmaNC * 4;
  p->wc_off = g;
  p->epi_off = 0;
  p->w_base = round_up(kMlpEpiBytes, 16);
  const int kcs[] = {256, 128, 64, 32};
  for (int i = -max_groups; i < 4; ++i) {  // i < 0: resident, -i groups
    const int groups = i < 0 ? -i : 1, kc = i < 0 ? 0 : kcs[i];
    const int chunk = kc ? mma_weight_rows(kc, kMmaNC, bytes) *
                               mma_weight_stride(kc, kMmaNC, bytes)
                         : 0;
    const long long total = (long long)p->w_base + (kc ? 0 : resident) +
                            (long long)groups * (g + chunk);
    if (total > kMlpSmemMax) continue;
    p->groups = groups;
    p->resident = kc == 0;
    p->kc = kc;
    p->wc_stride = kc ? mma_weight_stride(kc, kMmaNC, bytes) : 0;
    p->group_off = p->w_base + (kc ? 0 : resident);
    p->group_bytes = g + chunk;
    p->total = (int)total;
    return true;
  }
  return false;
}

// Blocks per model for `tiles` row tiles, when `blocks` blocks of `groups`
// warp groups fit the card at once: as many rounds as the tiles need, the
// fewest groups that still finish in that many rounds, and those spread
// over as many of the model's share of blocks as there are groups (so that
// a small batch runs one group a block, on as many SMs as it has tiles).
FXP_HOST_DEVICE int mlp_blocks_per_model(int tiles, int blocks, int groups,
                                         int models) {
  int per_model = blocks / models;
  if (per_model < 1) per_model = 1;
  const int slots = per_model * groups;
  const int rounds = (tiles + slots - 1) / slots;
  const int need = (tiles + rounds - 1) / rounds;  // groups at work
  return need < per_model ? need : per_model;
}

#if defined(__CUDACC__)

// ---------------------------------------------------------------------------
// 32-bit container: the CUDA-core body
// ---------------------------------------------------------------------------
// x: (M, dims[0]) and out: (M, dims[n_layers]) of this block's model;
// layer(l) returns that model's MlpLayer<T> for layer l, epilogue(l) its
// Epilogue.  The epilogue is fetched after each output's dot product, not
// before, so that its 21 fields are not held in registers across the K
// loop.  The block owns rows row0 .. row0 + BM - 1.  Every thread of the
// block must call it.
template <typename T, int BM, typename LayerFn, typename EpilogueFn>
__device__ __forceinline__ void mlp_block_cuda_cores(
    const T* __restrict__ x, T* __restrict__ out, int M, int row0,
    const MlpShape& s, LayerFn layer, EpilogueFn epilogue) {
  static_assert(BM % kMlpTM == 0, "whole row groups");
  extern __shared__ __align__(16) unsigned char mlp_smem[];
  T* hin = reinterpret_cast<T*>(mlp_smem);
  T* hout = hin + BM * s.stride;
  const int rows = min(BM, M - row0);

  const int k0 = s.dims[0];
  for (int i = threadIdx.x; i < BM * k0; i += kMlpThreads) {
    const int r = i / k0, c = i - r * k0;
    hin[r * s.stride + c] =
        (r < rows) ? x[(size_t)(row0 + r) * k0 + c] : T(0);
  }
  __syncthreads();

  for (int l = 0; l < s.n_layers; ++l) {
    const int K = s.dims[l], N = s.dims[l + 1];
    const MlpLayer<T> L = layer(l);
    const T* __restrict__ W = L.w;
    const T* __restrict__ B = L.b;
    const bool last = l == s.n_layers - 1;
    for (int item = threadIdx.x; item < (BM / kMlpTM) * N;
         item += kMlpThreads) {
      const int g = item / N, n = item - g * N;
      const T* h = hin + g * kMlpTM * s.stride;
      uint32_t acc[kMlpTM];
#pragma unroll
      for (int t = 0; t < kMlpTM; ++t) acc[t] = 0u;
      for (int k = 0; k < K; ++k) {
        const uint32_t w = (uint32_t)(int32_t)W[(size_t)k * N + n];
#pragma unroll
        for (int t = 0; t < kMlpTM; ++t)
          acc[t] += (uint32_t)(int32_t)h[t * s.stride + k] * w;  // mod 2^32
      }
      const int32_t bias = (int32_t)B[n];
      // A compiler barrier: the epilogue's loads (a row of a device table in
      // the fleet kernel) stay here and are not hoisted out of the item
      // loop, where their 21 fields would be live across the K loop and
      // starve it of registers.
      asm volatile("" ::: "memory");
      const Epilogue e = epilogue(l);
#pragma unroll
      for (int t = 0; t < kMlpTM; ++t) {
        const int r = g * kMlpTM + t;
        const T v = (T)layer_epilogue(acc[t], bias, e);
        if (!last) {
          hout[r * s.stride + n] = v;
        } else if (r < rows) {
          out[(size_t)(row0 + r) * N + n] = v;
        }
      }
    }
    __syncthreads();  // layer l+1 reads every column layer l wrote
    T* tmp = hin;
    hin = hout;
    hout = tmp;
  }
}

// ---------------------------------------------------------------------------
// 8- and 16-bit containers: the tensor-core body
// ---------------------------------------------------------------------------
// The barrier of warp group g alone (barrier 0 is __syncthreads).
__device__ __forceinline__ void mlp_group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "n"(kMlpThreads)
               : "memory");
}

template <typename T>
__device__ __forceinline__ uint32_t container_bits(T v) {
  return sizeof(T) == 1 ? (uint32_t)(uint8_t)v : (uint32_t)(uint16_t)v;
}

// One k32 step's operands of a warp's 16 x 8 output tile, as loaded.
//
// 8 bits: the MMA's own fragments, by 32-bit loads: A rows lane/4 and +8 at
// k 4 (lane % 4) .. +3 and 16 + that; B (weights transposed, n-major) row
// lane/4 at the same k.
//
// 16 bits: the activations are two byte planes (high bytes, low bytes) and
// each plane's A fragment is one ldmatrix; the weights stay 16-bit and
// k-major, and ldmatrix.trans gives thread (g = lane/4, t = lane % 4)
// column g at k 2t, 2t+1 of each 8 x 8 matrix.  The four int8 values of one
// B register are then k {2t, 2t+1, 8+2t, 9+2t} (and 16 + those) rather than
// 4t .. 4t+3; the planes store each group of 16 k in that same order
// (plane_pos), so A and B see one permutation of k, which a dot product
// does not see.  b[0..3]: column g at k 0-7, 8-15, 16-23, 24-31.
template <typename T>
struct MmaFrag;
template <>
struct MmaFrag<int8_t> {
  uint32_t a[4], b[2];
};
template <>
struct MmaFrag<int16_t> {
  uint32_t hi[4], lo[4], b[4];
};

// The position of k in its plane row: within each group of 16, k 2t and
// 2t + 1 go to 4t and 4t + 1, k 8 + 2t and 9 + 2t to 4t + 2 and 4t + 3.
__device__ __forceinline__ int plane_pos(int k) {
  const int j = k & 15;
  return (k & ~15) + ((j & 7) >> 1) * 4 + ((j >> 3) << 1) + (j & 1);
}

// xa: the tile's row 0 at the step's first k (the high-byte plane at 16
// bits, whose low-byte plane follows 16 rows later), row stride xs.  wb: the
// n8 tile's weights at the same k: at 8 bits its row 0 (n-major, stride
// ws), at 16 bits row k of its first column (k-major, stride ws).
__device__ __forceinline__ void mma_load(MmaFrag<int8_t>& f,
                                         const unsigned char* xa, int xs,
                                         const unsigned char* wb, int ws,
                                         int lane) {
  const int g = lane >> 2, o = (lane & 3) * 4;
  const unsigned char* r0 = xa + g * xs + o;
  const unsigned char* r8 = r0 + 8 * xs;
  const unsigned char* n0 = wb + g * ws + o;
  f.a[0] = *reinterpret_cast<const uint32_t*>(r0);
  f.a[1] = *reinterpret_cast<const uint32_t*>(r8);
  f.a[2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
  f.a[3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
  f.b[0] = *reinterpret_cast<const uint32_t*>(n0);
  f.b[1] = *reinterpret_cast<const uint32_t*>(n0 + 16);
}

__device__ __forceinline__ void mma_load(MmaFrag<int16_t>& f,
                                         const unsigned char* xa, int xs,
                                         const unsigned char* wb, int ws,
                                         int lane) {
  // lanes 8i .. 8i+7 address matrix i: A rows (lane % 8) + 8 (i % 2) at
  // bytes 16 (i / 2) of a plane, so that register i is the MMA's a_i;
  // B rows (k) lane
  const int m = lane >> 3;
  const unsigned char* a = xa + ((lane & 7) + 8 * (m & 1)) * xs + (m >> 1) * 16;
  ldsm_x4(a, f.hi);
  ldsm_x4(a + kMmaBM * xs, f.lo);
  ldsm_x4_trans(wb + lane * ws, f.b);
}

// Where the weights of output column n start in a staged block of row
// stride ws: a column offset at 16 bits (k-major), a row at 8 bits.
template <typename T>
__device__ __forceinline__ int mma_tile_offset(int n, int ws) {
  return sizeof(T) == 2 ? n * 2 : n * ws;
}

// A k32 step's address advance: 32 columns of the activations; 32 columns
// (8 bits) or 32 rows (16 bits) of the weights.
template <typename T>
__device__ __forceinline__ int mma_w_step(int ws) {
  return sizeof(T) == 1 ? 32 : 32 * ws;
}

// acc[0] += hi.hi, acc[1] += hi.lo, acc[2] += lo.hi, acc[3] += lo.lo (16
// bits; four chains, none waiting on another); acc[0] += a.b (8 bits).
__device__ __forceinline__ void mma_run(const MmaFrag<int8_t>& f,
                                        uint32_t (&acc)[4][4]) {
  mma_s8s8(acc[0], f.a, f.b);
}

__device__ __forceinline__ void mma_run(const MmaFrag<int16_t>& f,
                                        uint32_t (&acc)[4][4]) {
  // B registers of k {2t, 2t+1, 8+2t, 9+2t}, then 16 + those
  const uint2 b[2] = {{f.b[0], f.b[1]}, {f.b[2], f.b[3]}};
  const uint32_t bhi[2] = {hi_bytes(b[0]), hi_bytes(b[1])};
  const uint32_t blo[2] = {lo_bytes(b[0]), lo_bytes(b[1])};
  mma_s8s8(acc[0], f.hi, bhi);
  mma_s8u8(acc[1], f.hi, blo);
  mma_u8s8(acc[2], f.lo, bhi);
  mma_u8u8(acc[3], f.lo, blo);
}

// k steps ks0, ks0 + step, ... < ksteps of one warp's 16 x 8 tile, the next
// step's operands loaded before this step's MMAs run.
template <typename T>
__device__ __forceinline__ void mma_steps(uint32_t (&acc)[4][4],
                                          const unsigned char* xa, int xs,
                                          const unsigned char* wb, int ws,
                                          int ks0, int step, int ksteps,
                                          int lane) {
  constexpr int kStep = 32;  // k 32 of the activations: 32 bytes a plane
  const int w_step = mma_w_step<T>(ws);
  if (ks0 >= ksteps) return;
  MmaFrag<T> f;
  mma_load(f, xa + ks0 * kStep, xs, wb + ks0 * w_step, ws, lane);
  for (int ks = ks0 + step; ks < ksteps; ks += step) {
    MmaFrag<T> next;
    mma_load(next, xa + ks * kStep, xs, wb + ks * w_step, ws, lane);
    mma_run(f, acc);
    f = next;
  }
  mma_run(f, acc);
}

// Stages the block W[k0 : k0 + kc, n0 : n0 + nc] of a K x N row-major
// weight matrix in global memory into dst (row stride ws bytes), zero where
// k >= K or n >= N: at 16 bits as it is (kc rows of nc elements; the
// fragments come by ldmatrix.trans), at 8 bits transposed (nc rows of kc
// elements, the MMA's n-major B operand).  The `threads` threads from `tid`
// share it, kBatch 32-bit words a thread with every load in flight before
// the first store; consecutive threads write consecutive words (16 bits)
// or 8 rows x 4 words a warp (8 bits: few bank conflicts).
template <typename T>
__device__ __forceinline__ void mlp_stage_weights(unsigned char* dst, int ws,
                                                  const T* __restrict__ W,
                                                  int K, int N, int n0,
                                                  int nc, int k0, int kc,
                                                  int tid, int threads) {
  constexpr int kPerWord = 4 / (int)sizeof(T), kBatch = 8;
  if (sizeof(T) == 2 && N % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(W) & 15) == 0) {
    // rows of 16-byte chunks, copied by cp.async (rows past K zero-filled;
    // n0 + nc <= N here, since N is a multiple of 8)
    const int chunks = nc / 8;
    for (int t = tid; t < kc * chunks; t += threads) {
      const int r = t / chunks, c = t - r * chunks;
      const int k = k0 + r;
      cp_async16(smem_u32(dst + r * ws + c * 16),
                     W + (size_t)(k < K ? k : 0) * N + n0 + c * 8,
                     k < K ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    return;
  }
  // 16 bits: word (r, c) holds n0 + 2c, +1 of row k0 + r; 8 bits: word
  // (n, w) holds k0 + 4w .. +3 of column n0 + n
  const int per_row = sizeof(T) == 2 ? nc / 2 : kc / 4;
  const int total = (sizeof(T) == 2 ? kc : nc) * per_row;
  auto coords = [&](int t, int& row, int& col) {
    if constexpr (sizeof(T) == 2) {
      row = t / per_row;
      col = t - row * per_row;
    } else {  // a warp covers 8 rows x 4 words
      const int lane = t & 31, tile = t >> 5, n_tiles = nc / 8;
      const int tk = tile / n_tiles, tn = tile - tk * n_tiles;
      row = tn * 8 + (lane & 7);
      col = tk * 4 + (lane >> 3);
    }
  };
  for (int t0 = tid; t0 < total; t0 += threads * kBatch) {
    uint32_t word[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * threads;
      int row, col;
      coords(t, row, col);
      word[u] = 0u;
#pragma unroll
      for (int j = 0; j < kPerWord; ++j) {
        const int k = sizeof(T) == 2 ? k0 + row : k0 + col * 4 + j;
        const int n = sizeof(T) == 2 ? n0 + col * 2 + j : n0 + row;
        if (t < total && k < K && n < N)
          word[u] |= container_bits(W[(size_t)k * N + n])
                     << (8 * (int)sizeof(T) * j);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * threads;
      if (t < total) {
        int row, col;
        coords(t, row, col);
        *reinterpret_cast<uint32_t*>(dst + row * ws + col * 4) = word[u];
      }
    }
  }
}

// Starts the copy of rows row0 .. row0 + rows - 1 of x (M, K0), one
// contiguous run, into raw: 16-byte cp.async from the 16-byte boundary at
// or below the run's start (x itself is 16-byte aligned, so the copy never
// starts before it), the bytes past the run's end zero-filled and not read.
// Returns nothing; the group's threads (gtid) share the chunks.
template <typename T>
__device__ __forceinline__ void mlp_issue_rows(unsigned char* raw,
                                               const T* x, int K0, int row0,
                                               int rows, int gtid) {
  const char* start = reinterpret_cast<const char*>(x + (size_t)row0 * K0);
  const char* end = start + (size_t)rows * K0 * sizeof(T);
  const char* base = reinterpret_cast<const char*>(
      reinterpret_cast<uintptr_t>(start) & ~(uintptr_t)15);
  const int chunks = (int)((end - base + 15) >> 4);
  for (int c = gtid; c < chunks; c += kMlpThreads) {
    const char* src = base + 16 * c;
    const long long left = end - src;
    cp_async16(smem_u32(raw + 16 * c), src, left < 16 ? (int)left : 16);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The raw tile (row r at byte head + r K0 B) into the layer-0 input rows of
// stride xs, through 32-bit funnel shifts (the rows of an odd K0 are not
// word aligned).  8 bits: a word of 4 values at a time.  16 bits: four
// values k {2t, 2t+1, 8+2t, 9+2t} of a 16-group (two raw words) split into
// a word of high bytes and a word of low bytes, at plane_pos order, in the
// high plane and in the low plane 16 rows below.  Values past K0 (the next
// row's, or beyond the tile) land in the padding columns, where the weights
// are zero.
template <typename T>
__device__ __forceinline__ void mlp_unpack(unsigned char* dst, int xs,
                                           const unsigned char* raw,
                                           int head, int rows, int K0,
                                           int gtid) {
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(raw);
  const int lane = gtid & 31;
  auto word_at = [&](int byte) {
    return __funnelshift_r(rw[byte >> 2], rw[(byte >> 2) + 1], (byte & 3) * 8);
  };
  for (int r = gtid >> 5; r < rows; r += kMlpWarps) {
    const int row = head + r * K0 * (int)sizeof(T);
    uint32_t* out = reinterpret_cast<uint32_t*>(dst + r * xs);
    if constexpr (sizeof(T) == 1) {
#pragma unroll 4
      for (int j = lane; j < (K0 + 3) / 4; j += 32) out[j] = word_at(row + 4 * j);
    } else {
      uint32_t* out_lo = reinterpret_cast<uint32_t*>(dst + (r + kMmaBM) * xs);
#pragma unroll 4
      for (int j = lane; j < round_up(K0, 16) / 4; j += 32) {
        const int k = (j >> 2) * 16 + (j & 3) * 2;  // the word's k 2t, 2t+1
        const uint2 v = {word_at(row + 2 * k), word_at(row + 2 * k + 16)};
        out[j] = hi_bytes(v);
        out_lo[j] = lo_bytes(v);
      }
    }
  }
}

// x: (M, dims[0]) and out: (M, dims[n_layers]) of this block's model, x
// 16-byte aligned up to a fleet slice's offset.  Warp group g of the block
// runs row tiles g0, g0 + step, ... with g0 = g * blocks + block and step =
// blocks * groups.  layer(l)
// returns the model's MlpLayer<T> for layer l, epilogue(l) its Epilogue.
// Every thread of the block must call it.
template <typename T, typename LayerFn, typename EpilogueFn>
__device__ __forceinline__ void mlp_mma_block(const T* __restrict__ x,
                                              T* __restrict__ out, int M,
                                              const MlpShape& s,
                                              const MlpPlan& p, int block,
                                              int blocks, LayerFn layer,
                                              EpilogueFn epilogue) {
  extern __shared__ __align__(16) unsigned char mlp_smem[];
  constexpr int B = (int)sizeof(T);
  const int K0 = s.dims[0], L = s.n_layers;
  const int tiles = (M + kMmaBM - 1) / kMmaBM;
  Epilogue* epi = reinterpret_cast<Epilogue*>(mlp_smem + p.epi_off);
  unsigned char* wsm = mlp_smem + p.w_base;

  // the block: epilogues and resident weights, shared by its groups
  for (int l = threadIdx.x; l < L; l += blockDim.x) epi[l] = epilogue(l);
  if (p.resident) {
    for (int l = 0; l < L; ++l)
      mlp_stage_weights<T>(wsm + p.w_off[l], p.w_stride[l], layer(l).w,
                           s.dims[l], s.dims[l + 1], 0,
                           round_up(s.dims[l + 1], 8), 0,
                           round_up(s.dims[l], 32), threadIdx.x, blockDim.x);
  }
  const int g = threadIdx.x / kMlpThreads, gtid = threadIdx.x % kMlpThreads;
  const int lane = gtid & 31, warp = gtid >> 5;
  unsigned char* region = mlp_smem + p.group_off + g * p.group_bytes;
  unsigned char* raw = region + p.raw_off;
  uint32_t* scr = reinterpret_cast<uint32_t*>(region + p.scr_off);
  int32_t* bias = reinterpret_cast<int32_t*>(region + p.bias_off);
  unsigned char* wc = region + p.wc_off;
  for (int i = gtid; i < kMmaBM * kMmaNC; i += kMlpThreads) scr[i] = 0u;
  __syncthreads();  // the epilogues and weights are staged

  // group g of every block before group g + 1 of any: a launch with fewer
  // tiles than groups spreads them over all its blocks
  const int tile0 = g * blocks + block, step = blocks * p.groups;
  if (tile0 >= tiles) return;  // the whole group leaves together
  mlp_issue_rows(raw, x, K0, tile0 * kMmaBM, min(kMmaBM, M - tile0 * kMmaBM),
                 gtid);
  for (int tile = tile0; tile < tiles; tile += step) {
    const int row0 = tile * kMmaBM, rows = min(kMmaBM, M - row0);
    asm volatile("cp.async.wait_group 0;\n" ::);
    mlp_group_sync(g);  // the copy has landed; the previous tile is done
    mlp_unpack<T>(region + p.x_off[0], p.x_stride[0], raw,
                  (int)(reinterpret_cast<uintptr_t>(x + (size_t)row0 * K0) &
                        15),
                  rows, K0, gtid);
    mlp_group_sync(g);  // raw is free: start the next tile's copy
    if (tile + step < tiles)
      mlp_issue_rows(raw, x, K0, (tile + step) * kMmaBM,
                     min(kMmaBM, M - (tile + step) * kMmaBM), gtid);

    for (int l = 0; l < L; ++l) {
      const int K = s.dims[l], N = s.dims[l + 1];
      const int ksteps = round_up(K, 32) / 32, np = round_up(N, 8);
      const unsigned char* xin = region + p.x_off[l & 1];
      const int xs = p.x_stride[l & 1];
      unsigned char* xout = region + p.x_off[(l + 1) & 1];
      const int xos = p.x_stride[(l + 1) & 1];
      const MlpLayer<T> Ly = layer(l);
      const bool last = l == L - 1;
      for (int n0 = 0; n0 < N; n0 += kMmaNC) {
        const int ncols = min(kMmaNC, N - n0);
        if (gtid < ncols) bias[gtid] = (int32_t)Ly.b[n0 + gtid];
        // this chunk's n8 tiles over the warps; split-K below 8 tiles
        const int nt = min(kMmaNC, np - n0) / 8;
        const int slices = kMlpWarps / nt;
        const int tn = warp % nt, sl = warp / nt;
        const bool active = sl < slices;
        uint32_t acc[4][4] = {};
        if (p.resident) {
          if (active)
            mma_steps<T>(acc, xin, xs,
                         wsm + p.w_off[l] +
                             mma_tile_offset<T>(n0 + tn * 8, p.w_stride[l]),
                         p.w_stride[l], sl, slices, ksteps, lane);
        } else {
          for (int k0 = 0; k0 < ksteps * 32; k0 += p.kc) {
            const int kc = min(p.kc, ksteps * 32 - k0);
            mlp_group_sync(g);  // the previous chunk is consumed
            mlp_stage_weights<T>(wc, p.wc_stride, Ly.w, K, N, n0, nt * 8, k0,
                                 kc, gtid, kMlpThreads);
            mlp_group_sync(g);
            if (active)
              mma_steps<T>(acc, xin + k0, xs,
                           wc + mma_tile_offset<T>(tn * 8, p.wc_stride),
                           p.wc_stride, sl, slices, kc / 32, lane);
          }
        }
        if (active) {
          // C fragment: rows lane/4 and +8, columns 2 (lane % 4) and +1
          const int r = lane >> 2, c = tn * 8 + 2 * (lane & 3);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t v =
                B == 1 ? acc[0][i]
                       : (acc[0][i] << 16) + ((acc[1][i] + acc[2][i]) << 8) +
                             acc[3][i];
            const int cc = c + (i & 1);
            if (cc < ncols)
              atomicAdd(&scr[(r + 8 * (i >> 1)) * kMmaNC + cc], v);
          }
        }
        mlp_group_sync(g);
        const Epilogue& e = epi[l];
        auto store = [&](int r, int c, T v) {
          if (!last) {
            if constexpr (B == 1) {
              reinterpret_cast<T*>(xout + r * xos)[n0 + c] = v;
            } else {  // the next layer's planes
              const int pos = plane_pos(n0 + c);
              xout[r * xos + pos] = (unsigned char)((uint16_t)v >> 8);
              xout[(r + kMmaBM) * xos + pos] = (unsigned char)v;
            }
          } else if (r < rows) {
            out[(size_t)(row0 + r) * N + n0 + c] = v;
          }
        };
        if (B == 2 && ncols == kMmaNC) {
          // a full chunk at 16 bits: kPer outputs a thread, independent, in
          // one straight-line block whose epilogues the compiler
          // interleaves (at 8 bits the same spills under the 85-register
          // cap of three groups, and the loop below runs instead)
          constexpr int kPer = kMmaBM * kMmaNC / kMlpThreads;
          uint32_t a[kPer];
          int32_t bv[kPer];
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int i = gtid + u * kMlpThreads;
            a[u] = scr[i];
            scr[i] = 0u;
            bv[u] = bias[i % kMmaNC];
          }
          T v[kPer];
#pragma unroll
          for (int u = 0; u < kPer; ++u)
            v[u] = (T)layer_epilogue(a[u], bv[u], e);
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int i = gtid + u * kMlpThreads;
            store(i / kMmaNC, i % kMmaNC, v[u]);
          }
        } else {
          for (int i = gtid; i < kMmaBM * ncols; i += kMlpThreads) {
            const int r = i / ncols, c = i - r * ncols;
            const uint32_t a = scr[r * kMmaNC + c];
            scr[r * kMmaNC + c] = 0u;
            store(r, c, (T)layer_epilogue(a, bias[c], e));
          }
        }
        mlp_group_sync(g);  // the scratch is zero again; xout is complete
      }
    }
  }
}

#endif  // __CUDACC__

}  // namespace fxp
