// tree_ensemble: decision-tree inference, one launch per predict.
//
// Replaces the Pallas kernel
// repro/kernels/tree_ensemble.py::tree_ensemble_pallas (body _kernel), which
// evaluates the tree in its dense oblivious form on the MXU: a one-hot
// feature-select matmul xn = x @ sel, every predicate xn <= thr at once, and
// the leaf whose path predicates all hold, found by two path-matrix matmuls.
// On a GPU the natural form is a traversal: from the root, chase
// node = x[feature] <= threshold ? left : right to a leaf.  Compares are
// float32, as the TPU kernel's are.  The rows come as float32 or as the
// quantized container (int8, int16, int32); each feature read is cast with
// round-to-nearest-even (__int2float_rn), as the Pallas body's astype and
// PyTorch's cast do, and the thresholds are cast on the host.  For finite
// rows the two forms select the same leaf.
//
// Non-finite inputs (float32 rows only; an integer is finite): in the TPU
// kernel, inf * 0 = NaN inside x @ sel, so a non-finite value anywhere in a
// row reaches every node's xn.  Exactly one leaf still matches any set of
// predicate values, and the traversal that follows the same predicates
// reaches it.  The predicates are:
//   * no non-finite value: x[f] <= thr;
//   * one non-finite value, -inf at feature g: true exactly at the nodes
//     that test g (-inf * 1 = -inf there, NaN elsewhere);
//   * otherwise (NaN, +inf, or two or more): all false, the all-right leaf.
//
// Design.  The node table is one 16-byte record a node (feature, float
// threshold bits, left, right; a leaf holds feature < 0 and its class in
// place of the threshold), so a level of the walk is one 16-byte load.
// Persistent blocks of 8 warps stage the table in shared memory once
// (cp.async) and walk 32 rows a warp, one row a lane: 32 dependent chains
// in flight a warp, where the first version walked one row a warp on lane 0.
// A table over the shared-memory budget (chosen on the host by the node
// count alone) is walked from device memory through the read-only cache.
// Float32 rows are first scanned whole for non-finite values, a group of
// 32 rows at a time (16 where 32-row groups would leave some of the card's
// block slots idle, as at 3089 rows) by warps 1-7 of a block: the group is
// one contiguous run, read as 16-byte granules from the boundary at or
// below its start (a 561-float row is 2244 bytes, not a multiple of 16),
// eight loads in flight a thread; a non-finite value bumps its row's count
// and lowers its first feature in shared memory (atomics; the rare path).
// Warp 0 walks the group the others scanned in the turn before, so a turn
// takes the longer of the scan and the walk.  Integer rows skip the scan
// and read only the features on their path.
//
// Bound on the H100: bytes.  Float32 rows: every row read whole, M F 4
// bytes (D6, 3089 rows: 6.93 MB, 0.00207 ms at 3.35 TB/s).  Integer rows:
// the path's features, at most depth + 1 a row, one 32-byte sector each
// (D6, 3089 rows, depth 12: at most 1.29 MB, 0.00038 ms), plus the table;
// 13 dependent loads a row set a latency floor of a few microseconds above
// that.
#include <climits>
#include <type_traits>

#include "fxp_common.cuh"
#include "fxp_mma.cuh"

namespace {

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kRows = 32;       // rows a warp walks (and a scan covers)
constexpr int kScanUnroll = 8;  // 16-byte loads in flight a thread
constexpr int kFinite = -1, kAllFalse = -2;
constexpr uint32_t kExpMask = 0x7f800000u, kNegInf = 0xff800000u;
// Records a block can stage beside its static counts (227 KB a block).
constexpr int kMaxTableNodes = (232448 - 1024) / 16;

template <typename T>
__device__ __forceinline__ float feature_value(const T* __restrict__ xr,
                                               int f) {
  if constexpr (std::is_same<T, float>::value) {
    return __ldg(xr + f);
  } else {
    return __int2float_rn((int)__ldg(xr + f));
  }
}

template <bool kSmem>
__device__ __forceinline__ int4 node_at(const int4* __restrict__ table,
                                        int i) {
  if constexpr (kSmem) {
    return table[i];
  } else {
    return __ldg(table + i);
  }
}

// The class of the leaf row xr reaches; code is kFinite (compare), kAllFalse
// or the one -inf feature g (true exactly at the nodes that test g).
template <typename T, bool kSmem>
__device__ __forceinline__ int walk(const T* __restrict__ xr,
                                    const int4* __restrict__ table, int code,
                                    int n_nodes) {
  int4 rec = node_at<kSmem>(table, 0);
  for (int step = 0; step < n_nodes && rec.x >= 0; ++step) {
    const bool go_left = code == kFinite
                             ? feature_value(xr, rec.x) <= __int_as_float(rec.y)
                             : rec.x == code;
    rec = node_at<kSmem>(table, go_left ? rec.z : rec.w);
  }
  return rec.y;
}

// Rows [r0, r1) of x (float32, F a row), scanned by `threads` threads (this
// one is `tid`): a non-finite value adds one to cnt[row - r0] and lowers
// first[row - r0] to its feature.
__device__ __forceinline__ void scan_rows(const float* __restrict__ x, int F,
                                          int r0, int r1, int* cnt,
                                          int* first, int tid, int threads) {
  const uintptr_t start = reinterpret_cast<uintptr_t>(x + (size_t)r0 * F);
  const uintptr_t end = reinterpret_cast<uintptr_t>(x + (size_t)r1 * F);
  const uintptr_t base = start & ~(uintptr_t)15;
  const int granules = (int)((end - base + 15) >> 4);
  // element index (from x) of the first value of granule 0; the up to 3
  // values before the run's start are masked below
  const long long e0 =
      ((long long)base - (long long)reinterpret_cast<uintptr_t>(x)) / 4;
  const long long lo = (long long)r0 * F, hi = (long long)r1 * F;
  for (int g0 = tid; g0 < granules; g0 += threads * kScanUnroll) {
    uint4 v[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int g = g0 + u * threads;
      v[u] = g < granules
                 ? __ldg(reinterpret_cast<const uint4*>(base) + g)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((w[j] & kExpMask) != kExpMask) continue;  // finite: the rule
        const long long e = e0 + 4LL * (g0 + u * threads) + j;
        if (e < lo || e >= hi) continue;
        const int row = (int)(e / F);
        atomicAdd(cnt + (row - r0), 1);
        atomicMin(first + (row - r0), (int)(e - (long long)row * F));
      }
    }
  }
}

// x: (M, F) rows of T; table: (n_nodes,) records; out: (M,) class ids.
// Dynamic shared memory: n_nodes records when kSmem.  Float32 rows are
// scanned in groups of `rows` (16 or 32; warp 0's first `rows` lanes walk
// them).
template <typename T, bool kSmem>
__global__ void __launch_bounds__(kThreads)
tree_ensemble_kernel(const T* __restrict__ x, const int4* __restrict__ table_g,
                     int32_t* __restrict__ out, int M, int F, int n_nodes,
                     int rows) {
  extern __shared__ __align__(16) int4 tree_table_smem[];
  __shared__ int cnt[2][kRows], first[2][kRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int4* table = kSmem ? tree_table_smem : table_g;
  if constexpr (kSmem) {
    for (int i = threadIdx.x; i < n_nodes; i += kThreads)
      fxp::cp_async16(fxp::smem_u32(tree_table_smem + i), table_g + i, 16);
    fxp::cp_async_commit();
  }
  constexpr bool kFloat = std::is_same<T, float>::value;
  if constexpr (kFloat) {
    // Warps 1.. scan this block's next group of rows while warp 0 walks the
    // group they scanned before (its counts in the other buffer), so a
    // turn takes the longer of the two; one barrier a turn.
    if (warp == 0) {
      cnt[0][lane] = 0;
      first[0][lane] = INT_MAX;
    }
    __syncthreads();  // the first group's counts are zero
    const int scan_groups = (M + rows - 1) / rows;
    int buf = 0, prev = -1;
    for (int g = blockIdx.x;; g += gridDim.x, buf ^= 1) {
      const bool scan = g < scan_groups;
      if (warp != 0) {
        if (scan)
          scan_rows(x, F, g * rows, min(M, (g + 1) * rows), cnt[buf],
                    first[buf], threadIdx.x - 32, kThreads - 32);
      } else {
        const int row = prev * rows + lane;
        if (prev >= 0 && lane < rows && row < M) {
          const float* xr = x + (size_t)row * F;
          const int c = cnt[buf ^ 1][lane], f = first[buf ^ 1][lane];
          const int code =
              c == 0 ? kFinite
                     : (c == 1 && __float_as_uint(__ldg(xr + f)) == kNegInf
                            ? f
                            : kAllFalse);
          out[row] = walk<T, kSmem>(xr, table, code, n_nodes);
        }
        cnt[buf ^ 1][lane] = 0;  // for the group after this one
        first[buf ^ 1][lane] = INT_MAX;
      }
      if constexpr (kSmem) fxp::cp_async_wait<0>();  // before the first walk
      __syncthreads();  // group g's counts are complete; prev is walked
      if (!scan) break;
      prev = g;
    }
  } else {
    if constexpr (kSmem) fxp::cp_async_wait<0>();
    __syncthreads();  // the table is staged
    const int groups = (M + kRows - 1) / kRows;
    for (int g = blockIdx.x * kWarps + warp; g < groups;
         g += gridDim.x * kWarps) {
      const int row = g * kRows + lane;
      if (row < M)
        out[row] = walk<T, kSmem>(x + (size_t)row * F, table, kFinite,
                                  n_nodes);
    }
  }
}

template <typename T, bool kSmem>
int launch(const void* x, const void* table, void* out, int M, int F,
           int n_nodes, cudaStream_t stream) {
  auto kernel = tree_ensemble_kernel<T, kSmem>;
  const int smem = kSmem ? n_nodes * (int)sizeof(int4) : 0;
  int slots = 0;
  const cudaError_t err = fxp::launch_slots(kernel, kThreads, smem, &slots);
  if (err != cudaSuccess) return (int)err;
  const int groups = (M + kRows - 1) / kRows;
  // float32: a block a group of rows, which its whole block scans; groups
  // of 16 rows where groups of 32 would leave some of the card's block
  // slots idle (twice the blocks, each half the scan), else of 32.
  // Integer rows: a warp a group of 32.
  int rows = kRows, want = (groups + kWarps - 1) / kWarps;
  if (std::is_same<T, float>::value) {
    rows = groups < slots ? kRows / 2 : kRows;
    want = (M + rows - 1) / rows;
  }
  kernel<<<want < slots ? want : slots, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int4*>(table),
      static_cast<int32_t*>(out), M, F, n_nodes, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_route(const void* x, const void* table, void* out, int M, int F,
                 int n_nodes, int smem_table, cudaStream_t stream) {
  return smem_table
             ? launch<T, true>(x, table, out, M, F, n_nodes, stream)
             : launch<T, false>(x, table, out, M, F, n_nodes, stream);
}

}  // namespace

// x: (M, F) contiguous, float32 (bits 0) or the `bits`-wide integer
// container; table: (n_nodes, 4) int32 records (feature, threshold bits or
// the leaf's class, left, right), 16-byte aligned, node 0 the root; out: (M,)
// int32.  smem_table: 1 walks a copy of the table in shared memory (n_nodes
// x 16 bytes), 0 the table in device memory.  Launches on the calling
// thread's current device.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int tree_ensemble_launch(const void* x, int bits, const void* table,
                                    void* out, int M, int F, int n_nodes,
                                    int smem_table, void* stream) {
  if (M <= 0 || F <= 0 || n_nodes <= 0 ||
      (smem_table && n_nodes > kMaxTableNodes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 0: return launch_route<float>(x, table, out, M, F, n_nodes, smem_table, s);
    case 8: return launch_route<int8_t>(x, table, out, M, F, n_nodes, smem_table, s);
    case 16: return launch_route<int16_t>(x, table, out, M, F, n_nodes, smem_table, s);
    case 32: return launch_route<int32_t>(x, table, out, M, F, n_nodes, smem_table, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
