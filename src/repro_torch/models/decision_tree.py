"""CART decision-tree trainer (J48 / DecisionTreeClassifier analogue).

The counterpart of :mod:`repro.models.decision_tree`, and a copy of its
trainer: pure-numpy greedy CART with Gini impurity, vectorized threshold
scans (per-feature sort + cumulative class counts), depth / min-leaf
bounds.  On the same inputs it produces the same
:class:`repro_torch.core.trees.TreeArrays`, byte for byte.  Inference goes
through :func:`repro_torch.compile.compile`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.trees import TreeArrays

__all__ = ["DecisionTreeModel", "train_decision_tree"]


@dataclasses.dataclass
class DecisionTreeModel:
    tree: TreeArrays

    compile_kind = "tree"  # lowering registry key (repro_torch.compile)


def _best_split(x: np.ndarray, y: np.ndarray, n_classes: int,
                min_leaf: int) -> Optional[tuple]:
    """Vectorized exhaustive Gini scan.  Returns (feature, threshold, gain)."""
    n = x.shape[0]
    counts = np.bincount(y, minlength=n_classes).astype(np.float64)
    parent_gini = 1.0 - np.sum((counts / n) ** 2)
    best = None
    for f in range(x.shape[1]):
        order = np.argsort(x[:, f], kind="stable")
        xs = x[order, f]
        ys = y[order]
        onehot = np.zeros((n, n_classes), np.float64)
        onehot[np.arange(n), ys] = 1.0
        left_counts = np.cumsum(onehot, axis=0)  # counts if split after i
        left_n = np.arange(1, n + 1, dtype=np.float64)
        right_counts = counts[None, :] - left_counts
        right_n = n - left_n
        # candidate split positions: between distinct consecutive values,
        # respecting min_leaf.
        valid = (xs[:-1] < xs[1:])
        valid &= (left_n[:-1] >= min_leaf) & (right_n[:-1] >= min_leaf)
        if not valid.any():
            continue
        gl = 1.0 - np.sum((left_counts[:-1] / left_n[:-1, None]) ** 2, axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            gr = 1.0 - np.sum((right_counts[:-1]
                               / np.maximum(right_n[:-1, None], 1)) ** 2,
                              axis=1)
        weighted = (left_n[:-1] * gl + right_n[:-1] * gr) / n
        weighted = np.where(valid, weighted, np.inf)
        i = int(np.argmin(weighted))
        gain = parent_gini - weighted[i]
        if gain > 1e-12 and (best is None or gain > best[2]):
            thr = 0.5 * (xs[i] + xs[i + 1])
            best = (f, float(thr), float(gain))
    return best


def train_decision_tree(x: np.ndarray, y: np.ndarray, n_classes: int,
                        max_depth: int = 12, min_leaf: int = 5,
                        max_features: Optional[int] = None,
                        seed: int = 0) -> DecisionTreeModel:
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int32)
    rng = np.random.RandomState(seed)

    feature, threshold, left, right, leaf_class = [], [], [], [], []

    def new_node():
        feature.append(-1)
        threshold.append(0.0)
        left.append(0)
        right.append(0)
        leaf_class.append(-1)
        return len(feature) - 1

    def grow(idx: np.ndarray, depth: int) -> int:
        node = new_node()
        ys = y[idx]
        maj = int(np.bincount(ys, minlength=n_classes).argmax())
        if depth >= max_depth or idx.size < 2 * min_leaf or np.all(ys == ys[0]):
            leaf_class[node] = maj
            left[node] = right[node] = node
            return node
        xs = x[idx]
        if max_features is not None and max_features < x.shape[1]:
            cols = np.sort(rng.choice(x.shape[1], max_features, replace=False))
            sub = _best_split(xs[:, cols], ys, n_classes, min_leaf)
            split = None if sub is None else (int(cols[sub[0]]), sub[1], sub[2])
        else:
            split = _best_split(xs, ys, n_classes, min_leaf)
        if split is None:
            leaf_class[node] = maj
            left[node] = right[node] = node
            return node
        f, thr, _ = split
        mask = x[idx, f] <= thr
        feature[node] = f
        threshold[node] = thr
        left[node] = grow(idx[mask], depth + 1)
        right[node] = grow(idx[~mask], depth + 1)
        return node

    grow(np.arange(x.shape[0]), 0)
    tree = TreeArrays(
        feature=np.asarray(feature, np.int32),
        threshold=np.asarray(threshold, np.float32),
        left=np.asarray(left, np.int32),
        right=np.asarray(right, np.int32),
        leaf_class=np.asarray(leaf_class, np.int32),
        max_depth=max_depth,
        n_classes=n_classes,
        n_features=x.shape[1],
    )
    return DecisionTreeModel(tree)
