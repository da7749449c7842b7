"""Decision-tree inference layouts (paper §III-E, contribution C4), in PyTorch.

The counterpart of :mod:`repro.core.trees`: the three prediction-equivalent
layouts the ``ref`` backend runs, over one flat struct-of-arrays tree.

* ``iterative`` — the MCU node-chasing loop: ``max_depth + 1`` steps of
  ``node = x[feat[node]] <= thr[node] ? left[node] : right[node]``, batched
  with gathers.
* ``ifelse`` — EmbML emits C++ source; here the tree is emitted as *torch*
  source, nested ``torch.where`` expressions, one per internal node, compiled
  with ``exec`` and cached on the tree instance.
* ``oblivious`` — every node predicate at once (one gather and one compare),
  then the leaf whose path predicates all hold, by a dense path-matrix
  contraction.

Tree convention (CART-style): ``feature[n], threshold[n], left[n], right[n],
leaf_class[n]``; leaves have ``feature == -1``, ``left == right == n`` and
their class in ``leaf_class``.  Thresholds are float32, or Qn.m integers
after :meth:`TreeArrays.quantized`, compared against inputs quantized into
the same format.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .fixedpoint import FxpFormat, quantize, to_numpy

__all__ = ["TreeArrays", "ObliviousTree", "build_oblivious", "oblivious_of",
           "predict_iterative", "predict_ifelse", "predict_oblivious",
           "codegen_ifelse", "tree_memory_bytes", "TREE_LAYOUTS"]

TREE_LAYOUTS = ("iterative", "ifelse", "oblivious")


@dataclasses.dataclass
class TreeArrays:
    """Flat struct-of-arrays binary decision tree."""

    feature: np.ndarray  # (n_nodes,) int32; -1 for leaves
    threshold: np.ndarray  # (n_nodes,) float32 (or Qn.m ints after quantized)
    left: np.ndarray  # (n_nodes,) int32
    right: np.ndarray  # (n_nodes,) int32
    leaf_class: np.ndarray  # (n_nodes,) int32; class id at leaves, -1 inside
    max_depth: int
    n_classes: int
    n_features: int

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    @property
    def n_leaves(self) -> int:
        return int((self.feature < 0).sum())

    def quantized(self, fmt: FxpFormat) -> "TreeArrays":
        """Qn.m thresholds (inputs are quantized at predict time)."""
        thr = to_numpy(quantize(
            torch.from_numpy(self.threshold.astype(np.float32)), fmt))
        return dataclasses.replace(self, threshold=thr)


def _device_arrays(tree: TreeArrays, device: torch.device) -> dict:
    """The tree's node arrays as tensors on ``device``, cached on the tree
    instance (one upload per tree and device)."""
    cache = tree.__dict__.setdefault("_torch_arrays", {})
    key = str(device)
    if key not in cache:
        cache[key] = {name: torch.from_numpy(np.ascontiguousarray(
            getattr(tree, name))).to(device)
            for name in ("feature", "threshold", "left", "right",
                         "leaf_class")}
    return cache[key]


# --------------------------------------------------------------------------
# Layout 1: iterative traversal (faithful)
# --------------------------------------------------------------------------
def predict_iterative(tree: TreeArrays, x: torch.Tensor) -> torch.Tensor:
    """Batched iterative traversal.  x: (B, F) -> (B,) int32 class ids."""
    t = _device_arrays(tree, x.device)
    feat, thr = t["feature"].long(), t["threshold"]
    node = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
    for _ in range(tree.max_depth + 1):
        f = feat[node]
        # Leaves have feature == -1; stay put (left == right == self there).
        xv = torch.gather(x, 1, f.clamp_min(0)[:, None])[:, 0]
        nxt = torch.where(xv <= thr[node], t["left"][node], t["right"][node])
        node = torch.where(f < 0, node, nxt.long())
    return t["leaf_class"][node]


# --------------------------------------------------------------------------
# Layout 2: if-then-else codegen (faithful — EmbML emits source code)
# --------------------------------------------------------------------------
def codegen_ifelse(tree: TreeArrays) -> str:
    """Emit torch source for the nested if-then-else form of ``tree``.

    The generated ``tree_predict(x, threshold, leaf_class)`` takes the
    batched input (B, F) plus the tree's threshold array and returns (B,)
    int32 class ids: one ``torch.where`` per internal node, leaves inline
    their class constant.
    """
    lines = ["def tree_predict(x, threshold, leaf_class):"]

    def emit(node: int, indent: int) -> str:
        if tree.feature[node] < 0:
            return (f"torch.full((b,), {int(tree.leaf_class[node])}, "
                    f"dtype=torch.int32, device=x.device)")
        f = int(tree.feature[node])
        left = emit(int(tree.left[node]), indent + 1)
        right = emit(int(tree.right[node]), indent + 1)
        pad = "\n" + "    " * (indent + 1)
        return f"torch.where(x[:, {f}] <= threshold[{node}],{pad}{left},{pad}{right})"

    lines.append("    b = x.shape[0]")
    lines.append("    return " + emit(0, 1))
    return "\n".join(lines)


def predict_ifelse(tree: TreeArrays, x: torch.Tensor) -> torch.Tensor:
    """Compile (once per tree) and run the codegen'd nested-where form; the
    compiled function is cached on the tree instance."""
    fn = tree.__dict__.get("_ifelse_fn")
    if fn is None:
        ns: dict = {"torch": torch}
        exec(compile(codegen_ifelse(tree), f"<embml-tree-{id(tree)}>", "exec"),
             ns)
        fn = ns["tree_predict"]
        tree.__dict__["_ifelse_fn"] = fn
    t = _device_arrays(tree, x.device)
    return fn(x, t["threshold"], t["leaf_class"])


# --------------------------------------------------------------------------
# Layout 3: oblivious / tensorized
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ObliviousTree:
    """Dense path-matrix form: all predicates evaluated at once.

    ``path[l, n]`` is +1 if the path to leaf l requires
    ``x[feat[n]] <= thr[n]``, -1 if it requires the negation, 0 if internal
    node n is not on the path.  A leaf is selected iff its count of satisfied
    path predicates equals its path length.
    """

    node_feature: np.ndarray  # (N,) internal-node features
    node_threshold: np.ndarray  # (N,)
    path: np.ndarray  # (L, N) in {-1, 0, +1}, int8
    path_len: np.ndarray  # (L,)
    leaf_class: np.ndarray  # (L,)


def build_oblivious(tree: TreeArrays) -> ObliviousTree:
    internal = np.where(tree.feature >= 0)[0]
    n_index = {int(n): i for i, n in enumerate(internal)}
    leaves = np.where(tree.feature < 0)[0]
    L, N = len(leaves), len(internal)
    path = np.zeros((L, N), np.int8)
    path_len = np.zeros((L,), np.int32)
    leaf_class = np.zeros((L,), np.int32)

    def walk(node: int, trail):
        if tree.feature[node] < 0:
            li = np.searchsorted(leaves, node)
            for n, sign in trail:
                path[li, n_index[n]] = sign
            path_len[li] = len(trail)
            leaf_class[li] = tree.leaf_class[node]
            return
        walk(int(tree.left[node]), trail + [(node, 1)])
        walk(int(tree.right[node]), trail + [(node, -1)])

    walk(0, [])
    return ObliviousTree(
        node_feature=tree.feature[internal].astype(np.int32),
        node_threshold=tree.threshold[internal],
        path=path,
        path_len=path_len,
        leaf_class=leaf_class,
    )


def oblivious_of(tree: TreeArrays) -> ObliviousTree:
    """:func:`build_oblivious`, cached on the tree instance."""
    ob = tree.__dict__.get("_oblivious")
    if ob is None:
        ob = tree.__dict__["_oblivious"] = build_oblivious(tree)
    return ob


def match_leaf(ob: ObliviousTree, cmp: torch.Tensor) -> torch.Tensor:
    """(B,) int32 class of the one leaf whose path predicates all hold,
    given every internal node's predicate ``cmp`` (B, N) bool.

    The counts are at most the tree depth, so the float32 products are
    exact on any device (torch has no integer matmul on CUDA)."""
    p = torch.from_numpy(ob.path.astype(np.float32)).to(cmp.device)
    c = cmp.to(torch.float32)
    score = c @ p.clamp_min(0).T + (1 - c) @ (-p).clamp_min(0).T  # (B, L)
    plen = torch.from_numpy(ob.path_len.astype(np.float32)).to(cmp.device)
    leaf = torch.argmax((score == plen[None, :]).to(torch.int8), dim=1)
    return torch.from_numpy(ob.leaf_class).to(cmp.device)[leaf]


def predict_oblivious(tree: TreeArrays, x: torch.Tensor,
                      ob: Optional[ObliviousTree] = None) -> torch.Tensor:
    """Dense tensorized prediction.  x: (B, F) -> (B,) int32 class ids."""
    ob = oblivious_of(tree) if ob is None else ob
    feats = torch.from_numpy(ob.node_feature.astype(np.int64)).to(x.device)
    thr = torch.from_numpy(np.ascontiguousarray(ob.node_threshold)).to(x.device)
    # (B, N): one gather + one vector compare evaluates every predicate.
    return match_leaf(ob, x[:, feats] <= thr[None, :])


# --------------------------------------------------------------------------
# Memory model (paper Figs 5-6 analogue)
# --------------------------------------------------------------------------
def tree_memory_bytes(tree: TreeArrays, layout: str,
                      fmt: Optional[FxpFormat] = None) -> int:
    """Model artifact size in bytes for each layout/number format.

    iterative: node arrays (feature i16, threshold, left/right i16, class i8).
    ifelse: inlined constants — per internal node one threshold + one feature
    index embedded in code (the paper's 'more instructions' memory cost ~
    modelled as 1.5x the constant footprint), per leaf one class constant.
    oblivious: predicate arrays + path matrix (bitpacked) + leaf classes.
    """
    thr_bytes = 4 if fmt is None else fmt.total_bits // 8
    n, l = tree.n_nodes, tree.n_leaves
    internal = n - l
    if layout == "iterative":
        return n * (2 + thr_bytes + 2 + 2 + 1)
    if layout == "ifelse":
        per_node_code = 2 + thr_bytes  # cmp immediate + feature offset
        overhead = int(1.5 * internal)  # extra branch instructions
        return internal * per_node_code + l * 1 + overhead
    if layout == "oblivious":
        path_bits = l * internal * 2  # {-1,0,1} -> 2 bits
        return internal * (2 + thr_bytes) + path_bits // 8 + l * 1
    raise KeyError(f"unknown layout '{layout}'")
