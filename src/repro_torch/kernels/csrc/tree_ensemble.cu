// tree_ensemble: decision-tree inference, one launch per predict.
//
// Replaces the Pallas kernel
// repro/kernels/tree_ensemble.py::tree_ensemble_pallas (body _kernel), which
// evaluates the tree in its dense oblivious form on the MXU: a one-hot
// feature-select matmul xn = x @ sel, every predicate xn <= thr at once, and
// the leaf whose path predicates all hold, found by two path-matrix matmuls.
// On a GPU the natural form is a traversal: from the root, chase
// node = x[feature[node]] <= threshold[node] ? left[node] : right[node] to a
// leaf, reading the node arrays (KB-scale) through L1.  Compares are
// float32, as the TPU kernel's are; on fixed-point targets the caller passes
// the quantized inputs cast to float32, and the thresholds are cast on the
// host.  For finite rows the two forms select the same leaf.
//
// Non-finite inputs: in the TPU kernel, inf * 0 = NaN inside x @ sel, so a
// non-finite value anywhere in a row reaches every node's xn.  Exactly one
// leaf still matches any set of predicate values, and the traversal that
// follows the same predicates reaches it.  The predicates are:
//   * no non-finite value: x[f] <= thr;
//   * one non-finite value, -inf at feature g: true exactly at the nodes
//     that test g (-inf * 1 = -inf there, NaN elsewhere);
//   * otherwise (NaN, +inf, or two or more): all false, the all-right leaf.
// So each row is first scanned whole: one warp per row, lanes along the
// features (coalesced, independent loads), reduced across the warp to a
// count, the first non-finite feature and whether it is -inf.  Lane 0 then
// walks the tree, mostly from L1 since the row was just read.  Ragged
// batches are masked here; nothing is padded.
//
// Bound on the H100: bytes.  The scan reads every row whole (M * F * 4
// bytes); the traversal touches at most depth + 1 features per row.  The
// work is M * F finiteness tests plus one compare per node on each path.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8, kThreads = 32 * kWarps;  // one row per warp
constexpr int kFinite = -1, kAllFalse = -2;
constexpr uint32_t kExpMask = 0x7f800000u, kNegInf = 0xff800000u;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
tree_ensemble_kernel(const float* __restrict__ x,
                     const int32_t* __restrict__ feature,
                     const float* __restrict__ threshold,
                     const int32_t* __restrict__ left,
                     const int32_t* __restrict__ right,
                     const int32_t* __restrict__ leaf_class,
                     int32_t* __restrict__ out, int M, int F, int n_nodes) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= M) return;  // uniform across the warp
  const float* __restrict__ xr = x + (size_t)row * F;

  // NaN and +-inf are the floats whose exponent bits are all ones
  unsigned count = 0, first = 0xffffffffu;
  bool first_neg_inf = false;
#pragma unroll 4
  for (int k = lane; k < F; k += 32) {
    const uint32_t v = __float_as_uint(__ldg(xr + k));
    if ((v & kExpMask) == kExpMask) {
      if (count == 0) {
        first = (unsigned)k;
        first_neg_inf = v == kNegInf;
      }
      ++count;
    }
  }
  count = __reduce_add_sync(kFull, count);
  const unsigned where = __reduce_min_sync(kFull, first);
  // only the lane that found `where` can match it (features are distinct)
  const bool neg_inf = __any_sync(kFull, first == where && first_neg_inf);
  if (lane != 0) return;
  const int code = count == 0 ? kFinite
                              : (count == 1 && neg_inf ? (int)where : kAllFalse);

  int node = 0;
  for (int step = 0; step < n_nodes; ++step) {
    const int f = __ldg(feature + node);
    if (f < 0) break;
    const bool go_left =
        code == kFinite ? __ldg(xr + f) <= __ldg(threshold + node) : f == code;
    node = go_left ? __ldg(left + node) : __ldg(right + node);
  }
  out[row] = __ldg(leaf_class + node);
}

}  // namespace

// x: (M, F) float32; feature/left/right/leaf_class: (n_nodes,) int32;
// threshold: (n_nodes,) float32; out: (M,) int32; all contiguous.  Node 0
// is the root; leaves have feature < 0.  Launches on the calling thread's
// current device.  Returns the CUDA error code of the launch (0 on success).
extern "C" int tree_ensemble_launch(const void* x, const void* feature,
                                    const void* threshold, const void* left,
                                    const void* right, const void* leaf_class,
                                    void* out, int M, int F, int n_nodes,
                                    void* stream) {
  if (M <= 0 || F <= 0 || n_nodes <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (M + kWarps - 1) / kWarps;
  tree_ensemble_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(feature),
      static_cast<const float*>(threshold), static_cast<const int32_t*>(left),
      static_cast<const int32_t*>(right),
      static_cast<const int32_t*>(leaf_class), static_cast<int32_t*>(out), M,
      F, n_nodes);
  return (int)cudaGetLastError();
}
