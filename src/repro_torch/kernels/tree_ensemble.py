"""Decision-tree inference in one launch.

Replaces the Pallas kernel ``repro/kernels/tree_ensemble.py::tree_ensemble_pallas``
(body ``_kernel``): the class of the one leaf whose path predicates all
hold, per row, with float32 compares.  The rows are float32 (``flt``) or the
quantized container (int8, int16, int32), cast to float32 feature by
feature with round-to-nearest-even, as the Pallas body's ``astype`` does.
Two versions of the same function:

* :func:`tree_ensemble_cuda` launches ``csrc/tree_ensemble.cu``: persistent
  blocks stage the node table (one 16-byte record a node, from
  :func:`packed_operands`) in shared memory once, and each lane walks one
  row from the root, 32 rows a warp.  A table of more than
  :data:`TABLE_SMEM_NODES` nodes is walked from device memory instead
  (:func:`table_in_smem`: by the node count alone).  Float32 rows are first
  scanned whole for non-finite values, 32 rows at a time by the whole block;
  integer rows skip the scan and read only the features on their path.  It
  counts its launches in ``tree_ensemble_cuda.launches``.
* :func:`tree_ensemble_plain` computes the same thing in PyTorch ops: the
  rows cast to float32, every internal node's predicate at once, then the
  oblivious path match of :mod:`repro_torch.core.trees`.

Both follow the TPU kernel on non-finite inputs, where ``x @ sel`` spreads
``inf * 0 = NaN`` over a row: a row holding exactly one non-finite value,
``-inf`` at feature g, goes left exactly at the nodes that test g; any other
non-finite row takes the all-right leaf (see the CUDA source).  Integer
rows are always finite.

Thresholds are cast to float32 on the host, as the reference's ``pack_tree``
does (exact for quantized thresholds below 2^24).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.trees import TreeArrays, match_leaf, oblivious_of

from . import build

__all__ = ["tree_ensemble_plain", "tree_ensemble_cuda", "packed_operands",
           "table_in_smem", "TABLE_SMEM_NODES", "ROW_DTYPES", "REPLACES"]

REPLACES = "src/repro/kernels/tree_ensemble.py:76"  # tree_ensemble_pallas

# The row types the kernel takes, by the code its C entry point reads.
ROW_DTYPES = {torch.float32: 0, torch.int8: 8, torch.int16: 16,
              torch.int32: 32}
# The node records one block stages in shared memory (16 bytes each: 96 KB,
# two blocks an SM); a larger table is walked from device memory.
TABLE_SMEM_NODES = 6144


def packed_operands(tree: TreeArrays, device: torch.device) -> torch.Tensor:
    """The kernel's node table on ``device``: (n_nodes, 4) int32 records
    (feature, threshold as float32 bits, left, right), a leaf's class in
    place of its threshold; cached on the tree instance."""
    cache = tree.__dict__.setdefault("_kernel_operands", {})
    key = str(device)
    if key not in cache:
        feature = tree.feature.astype(np.int32)
        thr_bits = tree.threshold.astype(np.float32).view(np.int32)
        table = np.stack([feature,
                          np.where(feature >= 0, thr_bits,
                                   tree.leaf_class.astype(np.int32)),
                          tree.left.astype(np.int32),
                          tree.right.astype(np.int32)], axis=1)
        cache[key] = torch.from_numpy(np.ascontiguousarray(table)).to(device)
    return cache[key]


def table_in_smem(n_nodes: int) -> bool:
    """Whether the kernel walks a copy of the node table in shared memory
    (else the table in device memory): by the node count alone."""
    return int(n_nodes) <= TABLE_SMEM_NODES


def tree_ensemble_plain(tree: TreeArrays, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch ops.  x: (B, F) float32 or an integer
    container -> (B,) int32 class ids."""
    ob = oblivious_of(tree)
    feats = torch.from_numpy(ob.node_feature.astype(np.int64)).to(x.device)
    thr = torch.from_numpy(ob.node_threshold.astype(np.float32)).to(x.device)
    x = x.to(torch.float32)
    cmp = x[:, feats] <= thr[None, :]
    bad = ~torch.isfinite(x)
    count = bad.sum(1)
    first = torch.argmax(bad.to(torch.int8), dim=1)
    one_neg_inf = (count == 1) & (
        torch.gather(x, 1, first[:, None])[:, 0] == float("-inf"))
    degenerate = one_neg_inf[:, None] & (feats[None, :] == first[:, None])
    cmp = torch.where((count == 0)[:, None], cmp, degenerate)
    return match_leaf(ob, cmp)


def _lib():
    fn = build.load("tree_ensemble").tree_ensemble_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p] + [ctypes.c_int] * 4 + [
                           ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def tree_ensemble_cuda(tree: TreeArrays, x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: x (B, F) float32, int8, int16 or int32 on a
    CUDA device -> (B,) int32 class ids on that device."""
    if x.device.type != "cuda":
        raise ValueError(f"tree_ensemble_cuda needs CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in ROW_DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected one of "
                        f"{tuple(ROW_DTYPES)}")
    if x.dim() != 2 or x.shape[1] != tree.n_features:
        raise ValueError(f"x {tuple(x.shape)} does not match the tree's "
                         f"{tree.n_features} features")
    x = x.contiguous()
    m = int(x.shape[0])
    out = torch.empty((m,), dtype=torch.int32, device=x.device)
    if m == 0:
        return out
    table = packed_operands(tree, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), ROW_DTYPES[x.dtype], table.data_ptr(),
                     out.data_ptr(), m, tree.n_features, tree.n_nodes,
                     int(table_in_smem(tree.n_nodes)), stream)
    if err != 0:
        raise RuntimeError(f"tree_ensemble kernel launch failed: CUDA error "
                           f"{err}")
    tree_ensemble_cuda.launches += 1
    return out


tree_ensemble_cuda.launches = 0
