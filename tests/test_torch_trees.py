"""repro_torch.core.trees, the CART trainer and the tree_ensemble kernel's
plain version against the reference package.

* The three ``ref`` layouts (iterative, ifelse, oblivious) against the JAX
  layouts on random and trained trees, on float and quantized inputs.
* ``build_oblivious`` and ``tree_memory_bytes`` equality.
* The port's CART against ``repro.models.train_decision_tree``, byte for
  byte.
* ``tree_ensemble_plain`` against ``tree_ensemble_pallas(..., interpret=True)``
  on float rows with NaN and +-inf values, and on fxp16/fxp32 rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro.core import fixedpoint as jfx
from repro.core import trees as jtrees
from repro.kernels.tree_ensemble import pack_tree, tree_ensemble_pallas
from repro.models import train_decision_tree as jtrain
from repro_torch.core import fixedpoint as tfx
from repro_torch.core import trees as ttrees
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tree_ensemble as tkern
from repro_torch.models import train_decision_tree as ttrain

FIELDS = ("feature", "threshold", "left", "right", "leaf_class")
LAYOUTS = ("iterative", "ifelse", "oblivious")


def random_tree(seed, depth=5, n_features=7, n_classes=4):
    """A random binary tree (numpy arrays), ragged: each internal node
    becomes a leaf early with probability 0.25."""
    rng = np.random.RandomState(seed)
    feature, threshold, left, right, leaf_class = [], [], [], [], []

    def grow(d):
        node = len(feature)
        for arr in (feature, threshold, left, right, leaf_class):
            arr.append(0)
        if d == depth or (d > 0 and rng.rand() < 0.25):
            feature[node], threshold[node] = -1, 0.0
            left[node] = right[node] = node
            leaf_class[node] = rng.randint(n_classes)
            return node
        feature[node] = rng.randint(n_features)
        threshold[node] = np.float32(rng.randn() * 1.5)
        leaf_class[node] = -1
        left[node] = grow(d + 1)
        right[node] = grow(d + 1)
        return node

    grow(0)
    arrays = dict(feature=np.asarray(feature, np.int32),
                  threshold=np.asarray(threshold, np.float32),
                  left=np.asarray(left, np.int32),
                  right=np.asarray(right, np.int32),
                  leaf_class=np.asarray(leaf_class, np.int32))
    meta = dict(max_depth=depth, n_classes=n_classes, n_features=n_features)
    return arrays, meta


def trained_tree(seed, depth=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(500, 8).astype(np.float32) * 2
    y = ((x[:, 0] > 0).astype(np.int32) + (x[:, 3] > 0.5)
         + (x[:, 5] < -1)).astype(np.int32)
    t = jtrain(x, y, 4, max_depth=depth).tree
    arrays = {k: np.asarray(getattr(t, k)) for k in FIELDS}
    return arrays, dict(max_depth=t.max_depth, n_classes=t.n_classes,
                        n_features=t.n_features)


def both(arrays, meta):
    return (jtrees.TreeArrays(**arrays, **meta),
            ttrees.TreeArrays(**{k: v.copy() for k, v in arrays.items()},
                              **meta))


TREES = [("random", 0), ("random", 1), ("trained", 3)]


def make(kind, seed):
    return both(*(random_tree(seed) if kind == "random"
                  else trained_tree(seed)))


def _rows(seed, n_features, n=97):
    x = np.random.RandomState(seed).randn(n, n_features).astype(np.float32)
    return x * 2


@pytest.mark.parametrize("fmt", [None, (16, 4), (32, 10), (8, 2)],
                         ids=["flt", "fxp16", "fxp32", "fxp8"])
@pytest.mark.parametrize("kind,seed", TREES)
def test_layouts_match_reference(kind, seed, fmt):
    jt, tt = make(kind, seed)
    x = _rows(seed, jt.n_features)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if fmt is not None:
        jf, tf = jfx.FxpFormat(*fmt), tfx.FxpFormat(*fmt)
        jt, tt = jt.quantized(jf), tt.quantized(tf)
        np.testing.assert_array_equal(tt.threshold, np.asarray(jt.threshold))
        assert tt.threshold.dtype == np.asarray(jt.threshold).dtype
        jx, tx = jfx.quantize(jx, jf), tfx.quantize(tx, tf)
    want = np.asarray(jtrees.predict_iterative(jt, jx))
    for layout in LAYOUTS:
        jgot = np.asarray(getattr(jtrees, f"predict_{layout}")(jt, jx))
        tgot = getattr(ttrees, f"predict_{layout}")(tt, tx)
        assert tgot.dtype == torch.int32
        np.testing.assert_array_equal(jgot, want, err_msg=layout)
        np.testing.assert_array_equal(tgot.numpy(), want, err_msg=layout)


@pytest.mark.parametrize("kind,seed", TREES)
def test_oblivious_form_and_memory_model_match(kind, seed):
    jt, tt = make(kind, seed)
    job, tob = jtrees.build_oblivious(jt), ttrees.build_oblivious(tt)
    for name in ("node_feature", "node_threshold", "path", "path_len",
                 "leaf_class"):
        a, b = getattr(job, name), getattr(tob, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for layout in LAYOUTS:
        for j, t in ((None, None), (jfx.FXP16, tfx.FXP16),
                     (jfx.FXP32, tfx.FXP32)):
            assert (ttrees.tree_memory_bytes(tt, layout, t)
                    == jtrees.tree_memory_bytes(jt, layout, j))
    assert "torch.where" in ttrees.codegen_ifelse(tt)


@pytest.mark.parametrize("case", ["plain", "deep", "max_features",
                                  "ties"])
def test_cart_matches_reference_byte_for_byte(case):
    rng = np.random.RandomState({"plain": 0, "deep": 1, "max_features": 2,
                                 "ties": 3}[case])
    x = rng.randn(600, 9).astype(np.float32)
    if case == "ties":  # few distinct values: the scan's tie handling
        x = np.round(x * 2) / 2
    y = ((x[:, 0] + 0.5 * x[:, 4] > 0).astype(np.int32)
         + (x[:, 7] > 0.7) + 2 * (rng.rand(600) < 0.1)).astype(np.int32)
    kw = dict(max_depth={"deep": 12}.get(case, 5), min_leaf=3, seed=7)
    if case == "max_features":
        kw["max_features"] = 4
    jt = jtrain(x, y, 5, **kw).tree
    tt = ttrain(x, y, 5, **kw).tree
    for name in FIELDS:
        a, b = np.asarray(getattr(jt, name)), getattr(tt, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert (jt.max_depth, jt.n_classes, jt.n_features) == \
        (tt.max_depth, tt.n_classes, tt.n_features)
    assert tt.n_nodes > 7


def _pallas(jt, x):
    packed = tuple(jnp.asarray(a) for a in pack_tree(jt))
    return np.asarray(tree_ensemble_pallas(jnp.asarray(x), *packed,
                                           block_batch=64, interpret=True))


@pytest.mark.parametrize("kind,seed", TREES)
def test_plain_matches_pallas_on_non_finite_rows(kind, seed):
    """Rows with NaN, +inf, -inf (alone and together) follow the TPU
    kernel, where x @ sel spreads inf * 0 = NaN over the row."""
    jt, tt = make(kind, seed)
    x = _rows(seed, jt.n_features, n=70)
    f = jt.n_features
    x[0, 0] = np.nan
    x[1, f - 1] = np.inf
    x[2, 1] = -np.inf
    x[3, int(jt.feature[0])] = -np.inf  # the root's feature
    x[4, [0, 2]] = -np.inf
    x[5, 1], x[5, 2] = -np.inf, np.nan
    x[6, :] = np.inf
    x[7, int(jt.feature[0])] = np.inf
    for i in range(f):  # one -inf at every feature in turn
        x[8 + i, i] = -np.inf
    want = _pallas(jt, x)
    got = tkern.tree_ensemble_plain(tt, torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # finite rows: the kernel's function is every layout's
    np.testing.assert_array_equal(
        want[8 + f:], np.asarray(jtrees.predict_iterative(
            jt, jnp.asarray(x[8 + f:]))))
    # a non-finite row that is not a single -inf takes the all-right leaf
    node = 0
    while tt.feature[node] >= 0:
        node = tt.right[node]
    assert (got.numpy()[[0, 1, 4, 5, 6, 7]] == tt.leaf_class[node]).all()


@pytest.mark.parametrize("bits,frac", [(16, 4), (32, 10), (32, 0)])
@pytest.mark.parametrize("kind,seed", TREES)
def test_plain_matches_pallas_on_quantized_rows(kind, seed, bits, frac):
    jt, tt = make(kind, seed)
    jf, tf = jfx.FxpFormat(bits, frac), tfx.FxpFormat(bits, frac)
    jt, tt = jt.quantized(jf), tt.quantized(tf)
    x = _rows(seed + 1, jt.n_features, n=131)
    x[:3] = 1e6  # saturates at fxp16
    qx = np.asarray(jfx.quantize(jnp.asarray(x), jf)).astype(np.float32)
    want = _pallas(jt, qx)
    tq = tfx.quantize(torch.from_numpy(x), tf).to(torch.float32)
    np.testing.assert_array_equal(tq.numpy(), qx)
    np.testing.assert_array_equal(
        tkern.tree_ensemble_plain(tt, tq).numpy(), want)
    np.testing.assert_array_equal(
        want, np.asarray(jtrees.predict_iterative(
            jt, jfx.quantize(jnp.asarray(x), jf))))


def test_tree_predict_routing():
    jt, tt = make("trained", 3)
    x = torch.from_numpy(_rows(0, tt.n_features, n=33))
    before = tkern.tree_ensemble_cuda.launches
    with tops.count_dispatches() as c:
        got = tops.tree_predict(tt, x)
        ref = tops.tree_predict(tt, x, impl="ref")
    assert c.count == 2
    assert tkern.tree_ensemble_cuda.launches == before  # CPU: plain version
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_array_equal(got.numpy(),
                                  tkern.tree_ensemble_plain(tt, x).numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkern.tree_ensemble_cuda(tt, x)
    with pytest.raises(KeyError):
        tops.tree_predict(tt, x, impl="pallas")
    # an empty batch and a one-leaf tree
    assert tkern.tree_ensemble_plain(tt, x[:0]).shape == (0,)
    leaf = ttrees.TreeArrays(np.array([-1], np.int32),
                             np.zeros(1, np.float32), np.zeros(1, np.int32),
                             np.zeros(1, np.int32), np.array([2], np.int32),
                             0, 3, tt.n_features)
    assert (tkern.tree_ensemble_plain(leaf, x).numpy() == 2).all()
