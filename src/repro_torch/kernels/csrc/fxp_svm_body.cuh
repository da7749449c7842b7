// The body of the kernel-SVM megakernel: one thread block cluster computes
// the whole decision function of one model for R batch rows (R 16, 32 or
// 64, an instance each: the block-size tuner's choice, kernels/tune.py;
// kSvmRows = 32 by default, 4 R threads a block).  Shared
// by fxp_svm_model.cu (one model, SvmParams passed by value) and
// fxp_svm_fleet.cu (E stacked models, blockIdx.y picks the model and its
// SvmParams row), so that slot e of a fleet launch computes exactly what
// model e's own launch computes:
//
//   dot = requantize(x . sv^T, m)                   (uint32-wrapping sum)
//   poly: k = qpow_int(qadd(qmul(dot, g), c0), degree)
//   rbf:  k = qexp(-qmul(qadd(qsub(|x|^2, 2 dot), |sv|^2), g))
//   out = qadd(requantize(k . dual, dec_shift), intercept)   (uint32 sum)
//
// with the squared norms summed in int64 (core/fixedpoint.qsq_norm).
//
// Bound on the H100: integer multiply-adds on the CUDA cores for the 16- and
// 32-bit containers, 2 * M * (F * S + S * C) operations, almost all of them
// in x . sv^T; the 8-bit container's bound is set at the tensor cores' int8
// rate (not used here).  The design keeps the IMAD pipes busy:
//
//   * The card is filled by splitting the support vectors, not only the
//     rows.  The S support vectors form ceil(S / 64) chunks of 64; a thread
//     block cluster of G = min(8, chunks) blocks owns 32 batch rows, and
//     cluster rank g takes a contiguous run of chunks (svm_plan).  M = 3089
//     at S = 300 is 97 clusters of 5, 485 blocks of 128 threads.
//   * The dot is register-blocked: each thread owns a 4-row x 4-vector
//     micro-tile of 16 uint32 accumulators.  Each step of up to 32 features
//     (a partial last step, or D5's single 8-feature step, multiplies only
//     the staged features) stages
//     the block's x rows and the chunk's support vectors in shared memory as
//     int32, transposed ([feature][row], [feature][vector]), so that one
//     16-byte load gives a thread its 4 rows (a broadcast within half a
//     warp) and one its 4 vectors: 2 shared loads per 16 IMADs.  The next
//     step's global loads are in flight in registers while this step
//     computes (two shared buffers, one barrier per step).  Rows and
//     vectors past M and S, and features past F, stage as zeros.  Staging
//     goes through registers rather than cp.async because a row of F
//     container values starts 16-byte aligned only when F is a multiple of
//     16 / sizeof(T) (F = 561 in the paper's D6), and because the int32
//     transposed layout is what the inner loop wants.  Each block stages its
//     x rows once per chunk it owns: once when S <= 512.
//   * Each block sums the rbf squared norms of its own rows and of its own
//     support vectors only, from the staged values in registers (int64,
//     wrapping mod 2^64 through uint64), reduced over the 8 lanes that staged
//     one row.
//   * The block's kernel values, (32, its vectors) int32, stay in shared
//     memory.  The dot leaves its requantized values there, and the
//     kernel-value algebra runs over the tile as a pass of its own, two
//     values at a time a thread, once the accumulators are dead: the 64-bit
//     chains of the fxp32 qexp then need few registers (and at fxp32 the
//     container's widths are compile-time constants, qexp_w).  The
//     decision stage k . dual stages the block's slice of the duals in
//     shared memory as int32 and gives each thread a (row, class)
//     item, summed over the block's vectors in four interleaved uint32
//     chains into a partial.  The cluster's partials are then summed
//     through distributed shared memory (cluster.map_shared_rank), each
//     rank finishing a share of the items with the shared epilogue.  Every
//     partial and the sum are taken mod 2^32, and addition mod 2^32 is
//     associative and commutative, so the result is the single-block sum
//     bit for bit, for any split of the support vectors.  Classes go in
//     rounds (at least 23 classes each), the duals and partials reusing
//     the staging buffers, so any C fits.  The cluster's G remote partials
//     are loaded together (an unrolled loop), not one after another.
//   * Five blocks an SM (kSvmMinBlocks: 96 registers, 8-16 bytes of spills).
//
// On an NVIDIA H100 80GB HBM3 at 700 W (tools/svm_ablation.py,
// tools/kernel_compare.py): at D6 (fxp16, F = 561) the dot is ~45% of the
// time and runs near the IMAD rate; at path D's fleet (D5 rbf at fxp32,
// F = 8) the kernel-value algebra is ~half (the 64-bit qexp) and most of
// the rest is each block's chain of global loads and barriers, which a
// grid of 3-4 waves of short blocks exposes.  Three earlier variants ran
// slower: 8x8 micro-tiles per lane with the features split over the warps
// (half the shared loads per IMAD, but 128-144 registers); staging loads
// through hoisted row pointers (127 registers at 8 and 16 bits); and a
// decision stage that reduced each (row, class) over the block's vectors
// with warp shuffles (a warp's 8 rows x 4 classes per lane, 31 shuffles per
// 32 sums), 1-5% slower end to end: at S = 300 a block holds 60 vectors, 2
// per lane, so the shuffles and selects outweigh the products the serial
// walk does.  Staging x in the container type would save shared memory,
// not time: at S <= 512 each block already stages its x rows once, and the
// inner loop would then widen every operand it reads.
//
// Left for later: tensor cores for the 8-bit container (int8 MMA), and
// split-byte int8 MMA for 16-bit operands.
#pragma once

#include <cstddef>

#include "fxp_common.cuh"

#if defined(__CUDACC__)
#include <cooperative_groups.h>
#endif

namespace fxp {

constexpr int kSvmPoly = 0, kSvmRbf = 1;

// batch rows per cluster by default (MODEL_BLOCK_M: the routing count's
// bm); the tuner may pick 16 or 64
constexpr int kSvmRows = 32;
constexpr int kSvmChunk = 64;     // support vectors per chunk
constexpr int kSvmStep = 32;      // features per staging step
constexpr int kSvmMaxCluster = 8;  // the portable cluster size
constexpr int kSvmSP = kSvmChunk + 4;  // staged sv row stride

// The block of an instance of R rows: R / 4 row groups x 16 vector groups
// of 4x4 micro-tiles, 4 R threads.  Blocks an SM must hold
// (__launch_bounds__): at R = 32, five, 96 registers a thread, 20 of 32
// warps; five ran faster than four (128 registers) at D5 fxp32 and D6
// fxp16 alike, six and eight spilled in the dot loop and ran slower at D6.
// R = 16 and 64 hold 8 x 2 and 2 x 8 warps (128 registers).
template <int R>
struct SvmTile {
  static_assert(R == 16 || R == 32 || R == 64, "rows 16, 32, 64");
  static constexpr int kThreads = (R / 4) * (kSvmChunk / 4);
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kMinBlocks = R == 16 ? 8 : R == 32 ? 5 : 2;
  static constexpr int kXP = R + 4;  // staged x row stride (16-byte aligned)
  static constexpr int kStageWords = 2 * kSvmStep * (kXP + kSvmSP);
  // sv rows a staging lane holds: kWarps x 4 lanes x this = kSvmChunk
  static constexpr int kSvRows = kSvmChunk / (4 * kWarps);
};

constexpr int kSvmThreads = SvmTile<kSvmRows>::kThreads;  // 128
constexpr int kSvmMinBlocks = SvmTile<kSvmRows>::kMinBlocks;
constexpr int kSvmXP = SvmTile<kSvmRows>::kXP;
constexpr int kSvmStageWords = SvmTile<kSvmRows>::kStageWords;

struct SvmParams {
  Epilogue ek;  // kernel domain: fmt, shift = m
  Epilogue eo;  // decision: out_fmt, shift = dec_shift, no activation
  int kind, degree;
  int32_t qgamma, qcoef0;
};

// One model's row of the fleet's parameter table: the two epilogues, then
// degree, q(gamma) and q(coef0) (kernels/fxp_model.py::svm_fleet_table).
constexpr int kSvmFields = 2 * kEpilogueFields + 3;

FXP_HOST_DEVICE SvmParams svm_params_from(const long long* row, int kind) {
  SvmParams p;
  p.ek = epilogue_from(row);
  p.eo = epilogue_from(row + kEpilogueFields);
  p.kind = kind;
  p.degree = (int)row[2 * kEpilogueFields];
  p.qgamma = (int32_t)row[2 * kEpilogueFields + 1];
  p.qcoef0 = (int32_t)row[2 * kEpilogueFields + 2];
  return p;
}

// The split of S support vectors over a cluster of `rows` batch rows:
// n_chunks chunks of kSvmChunk, g = min(kSvmMaxCluster, n_chunks) blocks a
// cluster, each holding at most cap vectors (a whole number of chunks), and
// the dynamic shared memory of one block in bytes: the staging buffers
// (then the duals and the decision partials), the (rows, cap + 1) kernel
// values and cap + rows norms, int32.  False when S < 1, `rows` is not an
// instance, or a decision round would hold no class.
struct SvmPlan {
  int n_chunks, g, cap;
  int smem;
};

FXP_HOST_DEVICE bool svm_plan(int S, SvmPlan* p, int rows = kSvmRows) {
  if (S < 1 || (rows != 16 && rows != 32 && rows != 64)) return false;
  const int stage = 2 * kSvmStep * (rows + 4 + kSvmSP);  // SvmTile's
  p->n_chunks = (S + kSvmChunk - 1) / kSvmChunk;
  p->g = p->n_chunks < kSvmMaxCluster ? p->n_chunks : kSvmMaxCluster;
  p->cap = (p->n_chunks + p->g - 1) / p->g * kSvmChunk;
  if (stage / (p->cap + rows) < 1) return false;
  p->smem = (int)sizeof(int32_t) *
            (stage + rows * (p->cap + 1) + p->cap + rows);
  return true;
}

// Cluster rank `rank` of `g` owns chunks [begin, end) of n_chunks.
FXP_HOST_DEVICE void svm_rank_chunks(int rank, int g, int n_chunks,
                                     int* begin, int* end) {
  *begin = rank * n_chunks / g;
  *end = (rank + 1) * n_chunks / g;
}

#if defined(__CUDACC__)

// x: (M, F), sv: (S, F), dual: (S, C), icept: (C,), out: (M, C) of this
// cluster's model; the cluster (G blocks along x, svm_plan's g) owns rows
// (blockIdx.x / G) * R ... + R - 1.  `p` may live in the kernel parameters
// or in shared memory.  Every thread of the cluster must call it.
template <typename T, int R>
__device__ __forceinline__ void svm_cluster_body(
    const T* __restrict__ x, const T* __restrict__ sv,
    const T* __restrict__ dual, const T* __restrict__ icept,
    T* __restrict__ out, int M, int F, int S, int C, int n_chunks, int cap,
    const SvmParams& p) {
  namespace cg = cooperative_groups;
  using Tile = SvmTile<R>;
  constexpr int kRows = R, kChunk = kSvmChunk, kStep = kSvmStep;
  constexpr int kThreads = Tile::kThreads, kXP = Tile::kXP, kSP = kSvmSP;
  constexpr int kStageWords = Tile::kStageWords;
  constexpr int kRowStep = 4 * Tile::kWarps;  // staged rows a lane steps
  constexpr int kSvR = Tile::kSvRows;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / G) * kRows;
  int c_begin, c_end;
  svm_rank_chunks(rank, G, n_chunks, &c_begin, &c_end);
  const int j_begin = c_begin * kChunk;
  const int n_local = min(S, c_end * kChunk) - j_begin;  // >= 1

  extern __shared__ __align__(16) int32_t svm_cluster_smem[];
  int32_t* xs = svm_cluster_smem;       // [2][kStep][kXP]
  int32_t* svs = xs + 2 * kStep * kXP;  // [2][kStep][kSP]
  const int kvld = cap + 1;             // odd: rows in distinct banks
  int32_t* kv = svm_cluster_smem + kStageWords;  // [kRows][kvld]
  int32_t* sv2 = kv + kRows * kvld;     // [cap]   rbf: |sv|^2, local index
  int32_t* x2 = sv2 + cap;              // [kRows] rbf: |x|^2
  const Epilogue& ek = p.ek;
  const bool rbf = p.kind == kSvmRbf;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // staging: lane (kl, rl) stages features kl + 8 i of rows rl + 4 warp +
  // kRowStep j (kRowStep = 16 at R = 32); a warp's 32 stores hit 32 banks
  // (stride 4 mod 32 per feature)
  const int kl = lane / 4, rl = lane % 4;
  // compute: 4 rows from rg * 4, 4 vectors from vg * 4
  const int vg = tid % 16, rg = tid / 16;
  const int n_steps = (F + kStep - 1) / kStep;

  for (int ch = c_begin; ch < c_end; ++ch) {
    const int j0 = ch * kChunk;
    const bool first = ch == c_begin;
    int32_t xr[2][4], sr[kSvR][4];
    unsigned long long xsq[2] = {0ull, 0ull};
    unsigned long long ssq[kSvR];
#pragma unroll
    for (int i = 0; i < kSvR; ++i) ssq[i] = 0ull;
    uint32_t acc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[t][u] = 0u;

    auto load = [&](int step) {
      const int f0 = step * kStep;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + rl + 4 * warp + kRowStep * i;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = f0 + kl + 8 * e;
          xr[i][e] = (row < M && f < F) ? (int32_t)x[(size_t)row * F + f] : 0;
        }
      }
#pragma unroll
      for (int i = 0; i < kSvR; ++i) {
        const int j = j0 + rl + 4 * warp + kRowStep * i;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = f0 + kl + 8 * e;
          sr[i][e] = (j < S && f < F) ? (int32_t)sv[(size_t)j * F + f] : 0;
        }
      }
    };
    auto store = [&](int buf) {
      int32_t* xb = xs + buf * kStep * kXP;
      int32_t* sb = svs + buf * kStep * kSP;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int32_t q = xr[i][e];
          xb[(kl + 8 * e) * kXP + rl + 4 * warp + kRowStep * i] = q;
          if (rbf && first)
            xsq[i] += (unsigned long long)((int64_t)q * (int64_t)q);
        }
#pragma unroll
      for (int i = 0; i < kSvR; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int32_t q = sr[i][e];
          sb[(kl + 8 * e) * kSP + rl + 4 * warp + kRowStep * i] = q;
          if (rbf) ssq[i] += (unsigned long long)((int64_t)q * (int64_t)q);
        }
    };

    load(0);
    store(0);
    __syncthreads();
    for (int step = 0; step < n_steps; ++step) {
      const int buf = step & 1;
      if (step + 1 < n_steps) load(step + 1);  // in flight during the math
      const int32_t* xb = xs + buf * kStep * kXP + rg * 4;
      const int32_t* sb = svs + buf * kStep * kSP + vg * 4;
      auto mac = [&](int kk) {
        const int4 a = *reinterpret_cast<const int4*>(xb + kk * kXP);
        const int4 b = *reinterpret_cast<const int4*>(sb + kk * kSP);
        const uint32_t av[4] = {(uint32_t)a.x, (uint32_t)a.y, (uint32_t)a.z,
                                (uint32_t)a.w};
        const uint32_t bv[4] = {(uint32_t)b.x, (uint32_t)b.y, (uint32_t)b.z,
                                (uint32_t)b.w};
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[t][u] += av[t] * bv[u];  // mod 2^32
      };
      // features past F staged as zeros: a partial step (the last one, or
      // the only one at F = 8) multiplies only the staged features
      const int kn = min(kStep, F - step * kStep);
      if (kn == kStep) {
#pragma unroll
        for (int kk = 0; kk < kStep; ++kk) mac(kk);
      } else {
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) mac(kk);
      }
      if (step + 1 < n_steps) store(buf ^ 1);
      __syncthreads();
    }

    // this chunk's requantized dots into the block's (kRows, cap) tile
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jl = j0 - j_begin + vg * 4 + u;
        if (j_begin + jl < S)
          kv[(rg * 4 + t) * kvld + jl] =
              requant((int64_t)u2s32(acc[t][u]), ek.shift, ek.qmin, ek.qmax);
      }
    if (rbf) {
      // the 8 lanes of one staged row differ in lane bits 2..4
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          xsq[i] += __shfl_xor_sync(0xffffffffu, xsq[i], o);
#pragma unroll
        for (int i = 0; i < kSvR; ++i)
          ssq[i] += __shfl_xor_sync(0xffffffffu, ssq[i], o);
      }
      if (kl == 0) {
        if (first) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            x2[rl + 4 * warp + kRowStep * i] = sumsq_shift(xsq[i], ek);
        }
#pragma unroll
        for (int i = 0; i < kSvR; ++i)
          sv2[j0 - j_begin + rl + 4 * warp + kRowStep * i] =
              sumsq_shift(ssq[i], ek);
      }
    }
    __syncthreads();

    // The kernel-value algebra on the chunk's tile in place, as a pass of
    // its own: the dot's accumulators are dead here, so the 64-bit chains
    // (fxp32's qexp) run two at a time a thread on few registers.
    const int n_chunk = min(kChunk, S - j0);
#pragma unroll 2
    for (int i = tid; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk, u = i - r * kChunk;
      if (u >= n_chunk) continue;
      const int jl = j0 - j_begin + u;
      const int32_t dot = kv[r * kvld + jl];
      int32_t k;
      if (!rbf) {
        k = qpow_int(qadd(qmul(dot, p.qgamma, ek), p.qcoef0, ek), p.degree,
                     ek);
      } else {
        const int32_t d2 =
            qadd(qsub(x2[r], qadd(dot, dot, ek), ek), sv2[jl], ek);
        const int32_t z = qneg(qmul(d2, p.qgamma, ek), ek);
        // fxp32 (tb 32, wb 64 for a 4-byte container): the 64-bit wraps
        // and clamps fold to constants, 10% of path D's fleet; the same
        // at 16 bits ran 5% slower at D6 once, so narrower widths stay
        // generic
        k = sizeof(T) == 4 ? qexp_w(z, ek, 32, 64) : qexp(z, ek);
      }
      kv[r * kvld + jl] = k;
    }
  }
  __syncthreads();  // the kernel-value tile is complete; staging is free

  // The decision stage in rounds of classes: this block's duals staged as
  // int32 in shared memory, a thread per (row, class) summing k . dual over
  // the block's vectors into a uint32 partial, then the cluster's partials
  // summed through distributed shared memory.
  // classes per round, >= 23 at R = 32 (svm_plan refuses a round of none)
  const int round = kStageWords / (cap + kRows);
  int32_t* ds = svm_cluster_smem;                 // [n_local][cc]
  uint32_t* part =
      reinterpret_cast<uint32_t*>(svm_cluster_smem) + cap * round;
  for (int c0 = 0; c0 < C; c0 += round) {
    const int cc = min(round, C - c0);
    for (int i = tid; i < n_local * cc; i += kThreads) {
      const int j = i / cc, ci = i - j * cc;
      ds[i] = (int32_t)dual[(size_t)(j_begin + j) * C + c0 + ci];
    }
    __syncthreads();
    for (int item = tid; item < kRows * cc; item += kThreads) {
      const int r = item / cc, ci = item - r * cc;
      const int32_t* krow = kv + r * kvld;
      const int32_t* dcol = ds + ci;
      uint32_t a0 = 0u, a1 = 0u, a2 = 0u, a3 = 0u;  // four chains (ILP)
      int j = 0;
      for (; j + 4 <= n_local; j += 4) {
        a0 += (uint32_t)krow[j] * (uint32_t)dcol[j * cc];
        a1 += (uint32_t)krow[j + 1] * (uint32_t)dcol[(j + 1) * cc];
        a2 += (uint32_t)krow[j + 2] * (uint32_t)dcol[(j + 2) * cc];
        a3 += (uint32_t)krow[j + 3] * (uint32_t)dcol[(j + 3) * cc];
      }
      for (; j < n_local; ++j) a0 += (uint32_t)krow[j] * (uint32_t)dcol[j * cc];
      part[item] = a0 + a1 + a2 + a3;  // mod 2^32
    }
    cluster.sync();  // every rank's partials are visible cluster-wide
    for (int item = rank * kThreads + tid; item < kRows * cc;
         item += G * kThreads) {
      const int r = item / cc, ci = item - r * cc;
      if (row0 + r >= M) continue;
      uint32_t a = 0u;  // the G remote loads issued together
#pragma unroll
      for (int g = 0; g < kSvmMaxCluster; ++g)
        if (g < G) a += cluster.map_shared_rank(part, g)[item];
      out[(size_t)(row0 + r) * C + c0 + ci] =
          (T)layer_epilogue(a, (int32_t)icept[c0 + ci], p.eo);
    }
    cluster.sync();  // no rank restages its duals or partials while read
  }
}

// Launches `kernel` (a __global__ whose every cluster runs
// svm_cluster_body<T, R>) over `models` models: grid (g x ceil(M / R),
// models), clusters of g blocks along x, plan.smem bytes of dynamic shared
// memory (svm_plan at R rows).  Refuses with cudaErrorInvalidConfiguration
// a cluster the card cannot hold once at that shared memory
// (cudaOccupancyMaxActiveClusters, queried once and cached).
template <int R, typename Kernel, typename... Args>
cudaError_t svm_cluster_launch(Kernel kernel, const SvmPlan& plan, int M,
                               int models, cudaStream_t stream,
                               Args... args) {
  int clusters = 0;
  cudaError_t err = launch_slots(kernel, SvmTile<R>::kThreads, plan.smem,
                                 &clusters, plan.g);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)plan.g;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(plan.g * ((M + R - 1) / R)), (unsigned)models);
  cfg.blockDim = dim3(SvmTile<R>::kThreads);
  cfg.dynamicSmemBytes = (size_t)plan.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace fxp
