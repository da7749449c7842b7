// fxp_svm_model: the whole fixed-point kernel-SVM decision function in one
// launch.
//
// Replaces the Pallas megakernel
// repro/kernels/fxp_model.py::fxp_svm_model_pallas (body _svm_kernel, via
// _svm_forward), which keeps every support vector and dual coefficient
// resident in VMEM.  It computes svm_block's function (fxp_svm_body.cuh),
// bit for bit:
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
//     cluster rank g takes a contiguous run of chunks.  M = 3089 at S = 300
//     is 97 clusters of 5, 485 blocks of 128 threads.
//   * The dot is register-blocked: each thread owns a 4-row x 4-vector
//     micro-tile of 16 uint32 accumulators.  Each 32-feature step stages
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
//     memory.  The decision stage k . dual stages the block's slice of the
//     duals in shared memory as int32 and gives each thread a (row, class)
//     item, summed over the block's vectors in four interleaved uint32
//     chains into a partial.  The cluster's partials are then summed
//     through distributed shared memory (cluster.map_shared_rank), each
//     rank finishing a share of the items with the shared epilogue.  Every
//     partial and the sum are taken mod 2^32, and addition mod 2^32 is
//     associative and commutative, so the result is the single-block sum
//     bit for bit, for any split of the support vectors.  Classes go in
//     rounds (at least 23 classes each), the duals and partials reusing
//     the staging buffers, so any C fits.
//
// On the H100 the dot loop of this design runs near the IMAD rate; past
// the bound, the time goes to staging (the sv chunk is restaged by every
// cluster of rows), the kernel-value algebra (qexp for rbf) and the
// decision stage.  Three variants ran slower: 8x8 micro-tiles per lane with
// the features split over the warps (half the shared loads per IMAD, but
// 128-144 registers); staging loads through hoisted row pointers (127
// registers at 8 and 16 bits); and a decision stage that reduced each
// (row, class) over the block's vectors with warp shuffles (a warp's 8 rows
// x 4 classes per lane, 31 shuffles per 32 sums), 1-5% slower end to end:
// at S = 300 a block holds 60 vectors, 2 per lane, so the shuffles and
// selects outweigh the products the serial walk does.  Staging x in the
// container type would save shared memory, not time: at S <= 512 each block
// already stages its x rows once, and the inner loop would then widen every
// operand it reads.
//
// Left for later: tensor cores for the 8-bit container (int8 MMA), and
// split-byte int8 MMA for 16-bit operands.  The fleet kernel
// (fxp_svm_fleet.cu) still runs svm_block.
#include <cooperative_groups.h>

#include "fxp_svm_body.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 32;      // batch rows per cluster (MODEL_BLOCK_M)
constexpr int kChunk = 64;     // support vectors per chunk
constexpr int kStep = 32;      // features per staging step
constexpr int kThreads = 128;  // 8 row groups x 16 vector groups
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kXP = kRows + 4;   // staged x row stride (16-byte aligned)
constexpr int kSP = kChunk + 4;  // staged sv row stride
constexpr int kStageWords = 2 * kStep * (kXP + kSP);
static_assert(kThreads == (kRows / 4) * (kChunk / 4), "4x4 micro-tiles");

// Dynamic shared memory, int32 words: the staging buffers (then the duals
// and the decision partials), the (kRows, cap + 1) kernel values, cap +
// kRows norms.
inline size_t smem_bytes(int cap) {
  return sizeof(int32_t) *
         ((size_t)kStageWords + (size_t)kRows * (cap + 1) + cap + kRows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fxp_svm_model_kernel(const T* __restrict__ x, const T* __restrict__ sv,
                     const T* __restrict__ dual, const T* __restrict__ icept,
                     T* __restrict__ out, int M, int F, int S, int C,
                     int n_chunks, int cap, const fxp::SvmParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / G) * kRows;
  const int c_begin = rank * n_chunks / G, c_end = (rank + 1) * n_chunks / G;
  const int j_begin = c_begin * kChunk;
  const int n_local = min(S, c_end * kChunk) - j_begin;  // >= 1

  extern __shared__ __align__(16) int32_t svm_cluster_smem[];
  int32_t* xs = svm_cluster_smem;       // [2][kStep][kXP]
  int32_t* svs = xs + 2 * kStep * kXP;  // [2][kStep][kSP]
  const int kvld = cap + 1;             // odd: rows in distinct banks
  int32_t* kv = svm_cluster_smem + kStageWords;  // [kRows][kvld]
  int32_t* sv2 = kv + kRows * kvld;     // [cap]   rbf: |sv|^2, local index
  int32_t* x2 = sv2 + cap;              // [kRows] rbf: |x|^2
  const fxp::Epilogue& ek = p.ek;
  const bool rbf = p.kind == fxp::kSvmRbf;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // staging: lane (kl, rl) stages features kl + 8 i of rows rl + 4 warp +
  // 16 j; a warp's 32 stores hit 32 banks (stride 4 mod 32 per feature)
  const int kl = lane / 4, rl = lane % 4;
  // compute: 4 rows from rg * 4, 4 vectors from vg * 4
  const int vg = tid % 16, rg = tid / 16;
  const int n_steps = (F + kStep - 1) / kStep;

  for (int ch = c_begin; ch < c_end; ++ch) {
    const int j0 = ch * kChunk;
    const bool first = ch == c_begin;
    int32_t xr[2][4], sr[4][4];
    unsigned long long xsq[2] = {0ull, 0ull};
    unsigned long long ssq[4] = {0ull, 0ull, 0ull, 0ull};
    uint32_t acc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[t][u] = 0u;

    auto load = [&](int step) {
      const int f0 = step * kStep;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + rl + 4 * warp + 16 * i;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = f0 + kl + 8 * e;
          xr[i][e] = (row < M && f < F) ? (int32_t)x[(size_t)row * F + f] : 0;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + rl + 4 * warp + 16 * i;
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
          xb[(kl + 8 * e) * kXP + rl + 4 * warp + 16 * i] = q;
          if (rbf && first)
            xsq[i] += (unsigned long long)((int64_t)q * (int64_t)q);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int32_t q = sr[i][e];
          sb[(kl + 8 * e) * kSP + rl + 4 * warp + 16 * i] = q;
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
#pragma unroll
      for (int kk = 0; kk < kStep; ++kk) {
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
      }
      if (step + 1 < n_steps) store(buf ^ 1);
      __syncthreads();
    }

    if (rbf) {
      // the 8 lanes of one staged row differ in lane bits 2..4
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          xsq[i] += __shfl_xor_sync(0xffffffffu, xsq[i], o);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ssq[i] += __shfl_xor_sync(0xffffffffu, ssq[i], o);
      }
      if (kl == 0) {
        if (first) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            x2[rl + 4 * warp + 16 * i] = fxp::sumsq_shift(xsq[i], ek);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sv2[j0 - j_begin + rl + 4 * warp + 16 * i] =
              fxp::sumsq_shift(ssq[i], ek);
      }
      __syncthreads();
    }

    // kernel values of this chunk into the block's (kRows, cap) tile
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int r = rg * 4 + t;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jl = j0 - j_begin + vg * 4 + u;
        if (j_begin + jl >= S) continue;
        const int32_t dot = fxp::requant((int64_t)fxp::u2s32(acc[t][u]),
                                         ek.shift, ek.qmin, ek.qmax);
        int32_t k;
        if (!rbf) {
          k = fxp::qpow_int(
              fxp::qadd(fxp::qmul(dot, p.qgamma, ek), p.qcoef0, ek), p.degree,
              ek);
        } else {
          const int32_t d2 = fxp::qadd(
              fxp::qsub(x2[r], fxp::qadd(dot, dot, ek), ek), sv2[jl], ek);
          k = fxp::qexp(fxp::qneg(fxp::qmul(d2, p.qgamma, ek), ek), ek);
        }
        kv[r * kvld + jl] = k;
      }
    }
  }
  __syncthreads();  // the kernel-value tile is complete; staging is free

  // The decision stage in rounds of classes: this block's duals staged as
  // int32 in shared memory, a thread per (row, class) summing k . dual over
  // the block's vectors into a uint32 partial, then the cluster's partials
  // summed through distributed shared memory.
  const int round = kStageWords / (cap + kRows);  // classes per round, >= 23
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
      uint32_t a = 0u;
      for (int g = 0; g < G; ++g) a += cluster.map_shared_rank(part, g)[item];
      out[(size_t)(row0 + r) * C + c0 + ci] =
          (T)fxp::layer_epilogue(a, (int32_t)icept[c0 + ci], p.eo);
    }
    cluster.sync();  // no rank restages its duals or partials while read
  }
}

template <typename T>
int launch(const void* x, const void* sv, const void* dual, const void* icept,
           void* out, int M, int F, int S, int C, const fxp::SvmParams& p,
           cudaStream_t stream) {
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int g = min(kMaxCluster, n_chunks);
  const int cap = (n_chunks + g - 1) / g * kChunk;
  if (kStageWords / (cap + kRows) < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(cap);
  auto kernel = fxp_svm_model_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g * ((M + kRows - 1) / kRows)));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           static_cast<const T*>(sv),
                           static_cast<const T*>(dual),
                           static_cast<const T*>(icept), static_cast<T*>(out),
                           M, F, S, C, n_chunks, cap, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, F), sv: (S, F), dual: (S, C), icept: (C,), out: (M, C), every
// tensor contiguous in the `bits`-wide container.  `epi_k` and `epi_out`
// hold fxp::kEpilogueFields int64 values each: the kernel-domain format
// (shift = its m) and the decision stage (shift = dec_shift, out format).
// kind: 0 poly, 1 rbf.  Launches on the calling thread's current device.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int fxp_svm_model_launch(const void* x, const void* sv,
                                    const void* dual, const void* icept,
                                    void* out, int M, int F, int S, int C,
                                    int bits, const long long* epi_k,
                                    const long long* epi_out, int kind,
                                    int qgamma, int qcoef0, int degree,
                                    void* stream) {
  if (M <= 0 || F <= 0 || S <= 0 || C <= 0 || degree < 0 ||
      (kind != fxp::kSvmPoly && kind != fxp::kSvmRbf))
    return (int)cudaErrorInvalidValue;
  fxp::SvmParams p;
  p.ek = fxp::epilogue_from(epi_k);
  p.eo = fxp::epilogue_from(epi_out);
  p.kind = kind;
  p.degree = degree;
  p.qgamma = qgamma;
  p.qcoef0 = qcoef0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8: return launch<int8_t>(x, sv, dual, icept, out, M, F, S, C, p, s);
    case 16: return launch<int16_t>(x, sv, dual, icept, out, M, F, S, C, p, s);
    case 32: return launch<int32_t>(x, sv, dual, icept, out, M, F, S, C, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
