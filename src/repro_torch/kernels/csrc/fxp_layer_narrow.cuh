// The narrow-N route of fxp_layer: act(qadd(requantize(A @ W), bias)) for
// a layer of N <= 32 outputs whose weights fit one block's shared memory
// (the logistic and linear-SVM heads, 561 x 6; the SVM per-layer route's
// decision stage, 300 x 6 and 300 x 10; an MLP's last layer, 64 x 6).
//
// Such a layer moves its rows of A once and does little else: at 65536
// rows of 561 fxp16 features and N = 6 it reads 73.5 MB (22 us at 3.35
// TB/s) for 220 M multiply-adds (13 us at the int32 rate).  The first
// version's tile loop ran it as a latency chain instead: 32-wide N tiles
// that multiplied zeros on 26 of 32 columns, and K walked in serial 32-deep
// steps behind two block barriers each.  This kernel streams the rows:
//
//   * Persistent blocks of 8 warps, as many as the card holds at once but
//     no more than the row groups need (narrow_blocks).  Each block stages
//     W (K x N, zero-padded to narrow_plan's NB columns and k_pad rows) and
//     the bias once in shared memory as int32, behind its only barrier.
//   * A warp owns R rows at a time (a row group) and walks K in chunks of
//     128.  Each row's chunk is one contiguous run of A, copied into the
//     warp's ring of kNarrowStages chunks by 16-byte cp.async from the
//     16-byte boundary at or below its start, so rows of 561 x 2 bytes, or
//     a row slice of a larger tensor, load whole 16-byte granules at any
//     alignment; three chunks, of this row group or the next, are in flight
//     while one is multiplied, and only __syncwarp orders the ring (no
//     block barrier).  Its 32 lanes split K (lane l takes k = l, l + 32,
//     ... of the chunk), reading the ring's values at the row's offset.
//   * Each lane keeps R x NB uint32 partials (wrapping mod 2^32, as the
//     Pallas int32 accumulator does) and multiplies its row values by one
//     row of W read from shared memory with 16-, 8- or 4-byte loads whose
//     row stride puts the lanes on distinct banks (narrow_stride).
//   * The partials are summed across the warp by a reduce-scatter butterfly
//     (narrow_fold): at each xor offset a lane keeps half of its values and
//     sends the other half, while the count is even, so R x NB sums cost
//     about R x NB shuffles in all; the lanes that end with a full sum run
//     the shared epilogue (fxp_common.cuh) on it in parallel and store it.
//     Addition mod 2^32 is associative and commutative, so any split of K
//     and any order of the butterfly gives the wrapping int32 dot bit for
//     bit.
//
// NB is a template parameter, N rounded up to 1, 2, 4, 6, 8, 10, 16 or 32
// (6 and 10: the paper's D6 and D5 class counts, so the main paths multiply
// no padding); zero columns of W add nothing and their outputs are not
// stored.  R = 4 rows up to NB 10, then 32 / NB, so a lane holds at most
// 40 partials.  Products run on the CUDA cores at every width.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_compare.py, device
// time): 561 x 6 at fxp16 takes 0.0076 ms for 3089 rows (the first tile
// loop took 0.0309; bound 0.00105) and 0.059 ms for 65536 rows (0.204; bound
// 0.0221), so the small batch is a few latencies and the large one is
// bound by instructions, not bytes: 96 IMADs, 28 shared loads and the copy
// bookkeeping per 4 rows x 128 k.  Chunks of 256 k, rings of 3 or 6
// stages and four blocks an SM all ran slower or no faster.  The int8
// tensor cores (split bytes, as in fxp_mlp_body.cuh) would take the IMADs
// off the CUDA cores; that is the next step for this route.
#pragma once

#include "fxp_common.cuh"

namespace fxp {

constexpr int kNarrowThreads = 256;
constexpr int kNarrowWarps = kNarrowThreads / 32;
constexpr int kNarrowMaxN = 32;
constexpr int kNarrowKU = 4;                     // k values a lane per chunk
constexpr int kNarrowKChunk = 32 * kNarrowKU;    // k per chunk
constexpr int kNarrowSmemMax = 98304;            // W + bias, bytes a block
constexpr int kNarrowStages = 4;                 // a warp's ring of chunks

// N rounded up to the kernel's instance, 0 if N is out of [1, 32].
FXP_HOST_DEVICE constexpr int narrow_bucket(int n) {
  return n < 1 ? 0 : n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : n <= 6 ? 6
       : n <= 8 ? 8 : n <= 10 ? 10 : n <= 16 ? 16 : n <= 32 ? 32 : 0;
}

// Rows a warp owns at a time.
FXP_HOST_DEVICE constexpr int narrow_rows(int nb) {
  return nb <= 10 ? 4 : 32 / nb;
}

// Blocks an SM must hold (the register cap of __launch_bounds__): three
// while a lane's partials are few, two above NB 8.
FXP_HOST_DEVICE constexpr int narrow_min_blocks(int nb) {
  return nb <= 8 ? 3 : 2;
}

// Words a lane loads at once from a row of W: 4 (16 bytes), 2 or 1.
FXP_HOST_DEVICE constexpr int narrow_vec(int nb) {
  return nb % 4 == 0 ? 4 : nb % 2 == 0 ? 2 : 1;
}

// Row stride of W in shared memory, in words: a multiple of the load width
// whose quotient by it is odd, so that the lanes of one load phase (8 lanes
// of 16 bytes, 16 of 8, 32 of 4) reading 8, 16 or 32 consecutive rows hit
// distinct banks.
FXP_HOST_DEVICE constexpr int narrow_stride(int nb) {
  return (nb / narrow_vec(nb)) % 2 == 1 ? nb : nb + narrow_vec(nb);
}

// The narrow route's plan for a K x N layer: instance NB, rows R a group,
// W's row stride and padded rows (K rounded up to a whole chunk) in shared
// memory, and the block's dynamic shared memory in bytes (W, then NB bias
// words).  False (the wide route, fxp_tile.cuh) when K < 1, N is out of
// [1, 32], or W does not fit kNarrowSmemMax.
struct NarrowPlan {
  int nb, rows, stride, k_pad, smem;
};

FXP_HOST_DEVICE bool narrow_plan(int K, int N, NarrowPlan* p) {
  const int nb = narrow_bucket(N);
  if (K < 1 || nb == 0) return false;
  const long long k_pad =
      ((long long)K + kNarrowKChunk - 1) / kNarrowKChunk * kNarrowKChunk;
  const long long smem = 4 * (k_pad * narrow_stride(nb) + nb);
  if (smem > kNarrowSmemMax) return false;
  p->nb = nb;
  p->rows = narrow_rows(nb);
  p->stride = narrow_stride(nb);
  p->k_pad = (int)k_pad;
  p->smem = (int)smem;
  return true;
}

// Bytes of one row's chunk in a warp's ring: kNarrowKChunk container values
// and the up to 15 bytes before them on the 16-byte boundary the copy
// starts from.
FXP_HOST_DEVICE constexpr int narrow_row_bytes(int elem_bytes) {
  return kNarrowKChunk * elem_bytes + 16;
}

// A block's dynamic shared memory: the plan's W and bias (rounded up to 16
// bytes), then each warp's ring of kNarrowStages chunks of `rows` rows.
FXP_HOST_DEVICE int narrow_block_smem(const NarrowPlan& p, int elem_bytes) {
  return (p.smem + 15) / 16 * 16 +
         kNarrowWarps * kNarrowStages * p.rows * narrow_row_bytes(elem_bytes);
}

// Blocks of the persistent grid for `groups` row groups: enough blocks for
// one group a warp, at least one a SM while the groups last (small batches
// spread over the card), at most what the card holds at once (`slots`).
// The default; the block-size tuner may pass another grid (fxp_layer.cu),
// and any grid computes the same outputs.
FXP_HOST_DEVICE int narrow_blocks(int groups, int sms, int slots) {
  int b = (groups + kNarrowWarps - 1) / kNarrowWarps;
  const int spread = groups < sms ? groups : sms;
  if (b < spread) b = spread;
  return b < slots ? b : slots;
}

// The first row group of warp `warp` of block `block` in a grid of `grid`
// blocks, and the step to its next one: groups go to the blocks in turn
// (group g to block g % grid), so a batch of fewer groups than warps still
// spreads over every block.
FXP_HOST_DEVICE int narrow_first_group(int block, int warp, int grid) {
  return warp * grid + block;
}

FXP_HOST_DEVICE int narrow_group_step(int grid) { return grid * kNarrowWarps; }

// The butterfly's shape for V partials a lane: at each xor offset 16 .. 1
// the count halves while it is even, else the values are summed whole
// (every lane then holds all of them).  narrow_fold_count is the values a
// lane holds at the end, narrow_fold_reps the lanes holding each (the low
// bits of the lane index tell them apart).
FXP_HOST_DEVICE constexpr int narrow_fold_count(int v) {
  for (int o = 16; o > 0; o >>= 1)
    if (v % 2 == 0) v /= 2;
  return v;
}

FXP_HOST_DEVICE constexpr int narrow_fold_reps(int v) {
  int reps = 32;
  for (int o = 16; o > 0; o >>= 1)
    if (v % 2 == 0) {
      v /= 2;
      reps /= 2;
    }
  return reps;
}

#if defined(__CUDACC__)

// One butterfly stage at xor offset O on the window v[0 .. C) of V values,
// then the stages below it.  `base` accumulates the index of v[0] in the
// lane's original V values.
template <int V, int C, int O>
__device__ __forceinline__ void narrow_fold(uint32_t (&v)[V], int lane,
                                            int& base) {
  if constexpr (O > 0) {
    if constexpr (C % 2 == 0) {
      constexpr int H = C / 2;
      const bool up = (lane & O) != 0;  // keeps the upper half
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const uint32_t send = up ? v[i] : v[i + H];
        const uint32_t keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);  // mod 2^32
      }
      if (up) base += H;
      narrow_fold<V, H, O / 2>(v, lane, base);
    } else {
#pragma unroll
      for (int i = 0; i < C; ++i)
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], O);
      narrow_fold<V, C, O / 2>(v, lane, base);
    }
  }
}

// Row k of W (NB words at `w`, aligned to the load width) into registers.
template <int NB>
__device__ __forceinline__ void narrow_load_w(const int32_t* w,
                                              uint32_t (&out)[NB]) {
  constexpr int VW = narrow_vec(NB);
#pragma unroll
  for (int q = 0; q < NB / VW; ++q) {
    if constexpr (VW == 4) {
      const int4 t = reinterpret_cast<const int4*>(w)[q];
      out[4 * q] = (uint32_t)t.x;
      out[4 * q + 1] = (uint32_t)t.y;
      out[4 * q + 2] = (uint32_t)t.z;
      out[4 * q + 3] = (uint32_t)t.w;
    } else if constexpr (VW == 2) {
      const int2 t = reinterpret_cast<const int2*>(w)[q];
      out[2 * q] = (uint32_t)t.x;
      out[2 * q + 1] = (uint32_t)t.y;
    } else {
      out[q] = (uint32_t)w[q];
    }
  }
}

__device__ __forceinline__ void narrow_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// a: (M, K), b: (K, N), bias: (N,), out: (M, N); dynamic shared memory of
// narrow_block_smem(plan, sizeof(T)) bytes; grid narrow_blocks(...) x
// kNarrowThreads.
template <typename T, int NB>
__global__ void __launch_bounds__(kNarrowThreads, narrow_min_blocks(NB))
fxp_layer_narrow_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        const T* __restrict__ bias, T* __restrict__ out,
                        int M, int K, int N, int k_pad, int w_bytes,
                        const Epilogue e) {
  constexpr int R = narrow_rows(NB), S = narrow_stride(NB), V = R * NB;
  constexpr int KU = kNarrowKU, NS = kNarrowStages;
  constexpr int RB = narrow_row_bytes((int)sizeof(T));  // a row's chunk
  constexpr int VPR = RB / 16;  // 16-byte copies a row's chunk at most
  constexpr int kCount = narrow_fold_count(V), kReps = narrow_fold_reps(V);
  extern __shared__ __align__(16) int32_t narrow_smem[];
  int32_t* ws = narrow_smem;     // [k_pad][S]
  int32_t* bs = ws + k_pad * S;  // [NB]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  char* ring = reinterpret_cast<char*>(narrow_smem) + w_bytes +
               warp * NS * R * RB;  // this warp's [NS][R][RB]

  // W and the bias, once: eight loads in flight a thread before the stores
  constexpr int kU = 8;
  const int w_words = k_pad * S;
  for (int i0 = 0; i0 < w_words; i0 += kNarrowThreads * kU) {
    int32_t v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kNarrowThreads + threadIdx.x;
      const int k = i / S, n = i - k * S;
      v[u] = (i < w_words && k < K && n < N) ? (int32_t)b[(size_t)k * N + n]
                                             : 0;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kNarrowThreads + threadIdx.x;
      if (i < w_words) ws[i] = v[u];
    }
  }
  if (threadIdx.x < NB)
    bs[threadIdx.x] = threadIdx.x < N ? (int32_t)bias[threadIdx.x] : 0;
  __syncthreads();  // the block's only barrier

  // This warp's steps: (row group, K chunk) pairs, chunks in turn.
  const int n_groups = (M + R - 1) / R;
  const int n_chunks = k_pad / kNarrowKChunk;
  const int g_step = narrow_group_step(gridDim.x);
  const int g0 = narrow_first_group(blockIdx.x, warp, gridDim.x);
  if (g0 >= n_groups) return;
  const int n_steps = ((n_groups - 1 - g0) / g_step + 1) * n_chunks;
  const char* a_bytes = reinterpret_cast<const char*>(a);
  auto row_src = [&](int row, int ch) {
    return a_bytes +
           ((size_t)row * K + (size_t)ch * kNarrowKChunk) * sizeof(T);
  };
  // a row chunk's offset above the 16-byte boundary below it (chunks are
  // 128 values, a multiple of 16 bytes, so only the row start counts)
  const unsigned a_head = (unsigned)(reinterpret_cast<uintptr_t>(a) & 15);
  auto row_head = [&](int row) {
    return (int)((a_head + (unsigned)row * (unsigned)K * sizeof(T)) & 15u);
  };
  // Step s's rows into stage s % NS: each row's chunk as 16-byte copies from
  // the 16-byte boundary at or below its start, through its last value
  // (whole 16-byte granules of A's rows: never past a mapped byte).
  auto issue = [&](int s) {
    if (s < n_steps) {
      const int grp = g0 + (s / n_chunks) * g_step, ch = s % n_chunks;
      const int n_valid = min(kNarrowKChunk, K - ch * kNarrowKChunk);
      char* st = ring + (s % NS) * R * RB;
      for (int v = lane; v < R * VPR; v += 32) {
        const int r = v / VPR, j = v - r * VPR;
        const int row = grp * R + r;
        if (row >= M) continue;
        const char* src = row_src(row, ch);
        const int head = row_head(row);
        const int n_vec = (head + n_valid * (int)sizeof(T) + 15) / 16;
        if (j < n_vec)
          narrow_cp_async16(st + r * RB + 16 * j, src - head + 16 * j);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);  // empty groups keep count
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) issue(s);

  uint32_t acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0u;
  for (int s = 0; s < n_steps; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2));
    __syncwarp();  // every lane's copies of step s landed; step s - 1 is read
    issue(s + NS - 1);  // into the stage step s - 1 used
    const int grp = g0 + (s / n_chunks) * g_step, ch = s % n_chunks;
    const char* st = ring + (s % NS) * R * RB;
    int32_t x[R][KU];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = grp * R + r;
      const int head = row_head(row);
      const T* vals = reinterpret_cast<const T*>(st + r * RB + head);
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int k = u * 32 + lane;
        x[r][u] = (row < M && ch * kNarrowKChunk + k < K) ? (int32_t)vals[k]
                                                           : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      uint32_t w[NB];
      narrow_load_w<NB>(ws + (ch * kNarrowKChunk + u * 32 + lane) * S, w);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int n = 0; n < NB; ++n)
          acc[r * NB + n] += (uint32_t)x[r][u] * w[n];  // mod 2^32
    }
    if (ch == n_chunks - 1) {  // the row group is complete: sum, store
      int base = 0;
      narrow_fold<V, V, 16>(acc, lane, base);
#pragma unroll
      for (int i = 0; i < kCount; ++i) {
        if (i % kReps != (lane & (kReps - 1))) continue;
        const int idx = base + i, r = idx / NB, n = idx - r * NB;
        const int row = grp * R + r;
        if (row < M && n < N)
          out[(size_t)row * N + n] = (T)layer_epilogue(acc[i], bs[n], e);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0u;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

#endif  // __CUDACC__

}  // namespace fxp
