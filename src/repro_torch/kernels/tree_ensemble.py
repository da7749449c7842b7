"""Decision-tree inference in one launch.

Replaces the Pallas kernel ``repro/kernels/tree_ensemble.py::tree_ensemble_pallas``
(body ``_kernel``): the class of the one leaf whose path predicates all
hold, per row, with float32 compares.  Two versions of the same function:

* :func:`tree_ensemble_cuda` launches ``csrc/tree_ensemble.cu``: one warp
  per row scans the row for non-finite values, then one lane walks the node
  arrays from the root.  It counts its launches in
  ``tree_ensemble_cuda.launches``.
* :func:`tree_ensemble_plain` computes the same thing in PyTorch ops: every
  internal node's predicate at once, then the oblivious path match of
  :mod:`repro_torch.core.trees`.

Both follow the TPU kernel on non-finite inputs, where ``x @ sel`` spreads
``inf * 0 = NaN`` over a row: a row holding exactly one non-finite value,
``-inf`` at feature g, goes left exactly at the nodes that test g; any other
non-finite row takes the all-right leaf (see the CUDA source).  Quantized
inputs, cast to float32 by the caller, are always finite.

The kernel reads the node arrays as they are: :func:`packed_operands`
uploads them once per tree instance and device, thresholds cast to
float32 on the host (exact for quantized thresholds below 2^24).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.trees import TreeArrays, match_leaf, oblivious_of

from . import build

__all__ = ["tree_ensemble_plain", "tree_ensemble_cuda", "packed_operands",
           "REPLACES"]

REPLACES = "src/repro/kernels/tree_ensemble.py:76"  # tree_ensemble_pallas


def packed_operands(tree: TreeArrays, device: torch.device) -> tuple:
    """(feature, threshold, left, right, leaf_class) on ``device``: int32
    node arrays and float32 thresholds, cached on the tree instance."""
    cache = tree.__dict__.setdefault("_kernel_operands", {})
    key = str(device)
    if key not in cache:
        arrays = (tree.feature.astype(np.int32),
                  tree.threshold.astype(np.float32),
                  tree.left.astype(np.int32), tree.right.astype(np.int32),
                  tree.leaf_class.astype(np.int32))
        cache[key] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                           for a in arrays)
    return cache[key]


def tree_ensemble_plain(tree: TreeArrays, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch ops.  x: (B, F) float32 -> (B,)
    int32 class ids."""
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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def tree_ensemble_cuda(tree: TreeArrays, x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: x (B, F) float32 on a CUDA device -> (B,)
    int32 class ids on that device."""
    if x.device.type != "cuda":
        raise ValueError(f"tree_ensemble_cuda needs CUDA tensors, got "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"x has dtype {x.dtype}, expected torch.float32")
    if x.dim() != 2 or x.shape[1] != tree.n_features:
        raise ValueError(f"x {tuple(x.shape)} does not match the tree's "
                         f"{tree.n_features} features")
    x = x.contiguous()
    m = int(x.shape[0])
    out = torch.empty((m,), dtype=torch.int32, device=x.device)
    if m == 0:
        return out
    ops = packed_operands(tree, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), *(t.data_ptr() for t in ops),
                     out.data_ptr(), m, tree.n_features, tree.n_nodes, stream)
    if err != 0:
        raise RuntimeError(f"tree_ensemble kernel launch failed: CUDA error "
                           f"{err}")
    tree_ensemble_cuda.launches += 1
    return out


tree_ensemble_cuda.launches = 0
