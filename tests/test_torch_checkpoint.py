"""The port's pytree checkpoints against the live JAX package's.

* The cases of ``tests/test_checkpoint.py``, mirrored in the port
  (``test_artifact_save_is_atomic``'s counterpart is in
  ``tests/test_torch_archive.py``): round trip, bfloat16 leaves, shape and
  leaf-count validation, the manager's latest step, retention,
  ``keep_period``, uncommitted steps, ``restore_or_init`` and the atomic
  writes.
* Cross-load in both directions, with ``like`` built by each package: a
  ``{"params", "opt"}`` tree with bfloat16 leaves and an adamw
  ``OptState``, and an sgd state whose ``nu`` is ``None``.  The port's
  leaf order equals ``jax.tree.flatten``'s and every array is equal bit for
  bit.
"""

import os
import threading

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
import jax
import jax.numpy as jnp
from repro.train import checkpoint as JC
from repro.train import optim as joptim
from repro_torch.train import checkpoint as C
from repro_torch.train import optim as toptim
from repro_torch.train.checkpoint import (CheckpointManager, restore_pytree,
                                          save_pytree)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"w": torch.from_numpy(rng.randn(4, 3).astype(np.float32)),
            "opt": {"mu": torch.from_numpy(rng.randn(4, 3).astype(np.float32)),
                    "step": torch.tensor(seed, dtype=torch.int32)}}


# --------------------------------------------------------------------------
# tests/test_checkpoint.py, mirrored
# --------------------------------------------------------------------------
def test_save_restore_roundtrip(tmp_path):
    t = _tree(0)
    p = os.path.join(tmp_path, "x.ckpt")
    save_pytree(p, t, metadata={"note": "hi"})
    got, meta = restore_pytree(p, like=t)
    assert meta["note"] == "hi"
    assert torch.equal(got["w"], t["w"])
    assert torch.equal(got["opt"]["mu"], t["opt"]["mu"])
    assert got["opt"]["step"] == 0 and got["opt"]["step"].dtype == torch.int32


def test_save_restore_bfloat16_leaf(tmp_path):
    t = {"w": torch.from_numpy(np.random.RandomState(0).randn(8, 4)).to(
        torch.bfloat16)}
    p = os.path.join(tmp_path, "bf16.ckpt")
    save_pytree(p, t)
    got, _ = restore_pytree(p, like=t)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), t["w"].view(torch.int16))


def test_restore_validates_shapes(tmp_path):
    p = os.path.join(tmp_path, "x.ckpt")
    save_pytree(p, {"w": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match=r"leaf 0: checkpoint shape \(2, 2\)"
                                         r" != expected \(3, 3\)"):
        restore_pytree(p, like={"w": torch.zeros(3, 3)})


def test_restore_validates_leaf_count(tmp_path):
    p = os.path.join(tmp_path, "x.ckpt")
    save_pytree(p, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="checkpoint has 1 leaves, "
                                         "expected 2"):
        restore_pytree(p, like={"w": torch.zeros(2), "b": torch.zeros(1)})


def test_manager_latest_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=10)
    assert mgr.latest_step() is None
    for s in (10, 20, 30):
        mgr.save(s, _tree(s))
    assert mgr.latest_step() == 30
    step, tree, meta = mgr.restore(_tree(0))
    assert step == 30 and meta["step"] == 30
    assert tree["opt"]["step"] == 30


def test_manager_retention_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]


def test_manager_keep_period(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, keep_period=100)
    for s in (100, 150, 200, 250):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [100, 200, 250]


def test_uncommitted_step_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, _tree(1))
    # A crash mid-save of step 2: files exist but no COMMIT marker.
    os.makedirs(os.path.join(tmp_path, "step_2"), exist_ok=True)
    with open(os.path.join(tmp_path, "step_2", "host_0.ckpt"), "wb") as f:
        f.write(b"garbage-partial-write")
    assert mgr.latest_step() == 1  # step 2 is invisible


def test_restore_or_init(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    init = _tree(7)
    step, tree = mgr.restore_or_init(init)
    assert step == 0 and tree is init
    mgr.save(5, _tree(5))
    step, tree = mgr.restore_or_init(init)
    assert step == 5 and tree["opt"]["step"] == 5


def test_atomic_no_tmp_left_behind(tmp_path):
    p = os.path.join(tmp_path, "x.ckpt")
    save_pytree(p, _tree(0))
    assert [f for f in os.listdir(tmp_path) if ".tmp-" in f] == []


def test_atomic_crash_at_publish_preserves_original(tmp_path, monkeypatch):
    path = tmp_path / "model.bin"
    C.atomic_write_bytes(str(path), b"v1-good")

    def boom(src, dst):
        raise OSError("simulated power loss at publish")

    monkeypatch.setattr(C.os, "replace", boom)
    with pytest.raises(OSError, match="power loss"):
        C.atomic_write_bytes(str(path), b"v2-half")
    monkeypatch.undo()
    assert path.read_bytes() == b"v1-good"
    assert [f for f in os.listdir(tmp_path) if ".tmp-" in f] == []


def test_atomic_write_failure_cleans_tmp(tmp_path, monkeypatch):
    def boom(fd):
        raise OSError("simulated disk full")

    monkeypatch.setattr(C.os, "fsync", boom)
    with pytest.raises(OSError, match="disk full"):
        C.atomic_write_bytes(str(tmp_path / "never.bin"), b"data")
    monkeypatch.undo()
    assert os.listdir(tmp_path) == []


def test_atomic_concurrent_writers_publish_one_intact_blob(tmp_path):
    path = str(tmp_path / "shared.bin")
    blobs = [bytes([i]) * (4096 + i) for i in range(8)]
    threads = [threading.Thread(target=C.atomic_write_bytes, args=(path, b))
               for b in blobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with open(path, "rb") as f:
        assert f.read() in blobs
    assert [f for f in os.listdir(tmp_path) if ".tmp-" in f] == []


# --------------------------------------------------------------------------
# cross-load with the reference
# --------------------------------------------------------------------------
def _params(rng):
    """A small LM-like parameter tree: dict keys out of sorted order, a
    bfloat16 leaf and nested lists (the reference's adamw takes no tuple
    subtrees)."""
    return {"layers": {"wq": rng.randn(2, 8, 4), "ln": rng.randn(2, 8)},
            "embed": {"table": rng.randn(16, 8)},
            "blocks": [rng.randn(3), [rng.randn(2, 2), rng.randn(1)]]}


def _as_jax(tree, bf16=("table",)):
    def conv(path, x):
        name = getattr(path[-1], "key", None)
        return jnp.asarray(x, jnp.bfloat16 if name in bf16 else jnp.float32)
    return jax.tree_util.tree_map_with_path(conv, tree)


def _as_torch(tree, bf16=("table",)):
    def walk(x, key=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        t = torch.from_numpy(np.asarray(x, np.float32))
        return t.to(torch.bfloat16) if key in bf16 else t
    return walk(tree)


def _states(kind):
    """(reference tree, port tree) holding the same values."""
    params = _params(np.random.RandomState(3))
    jp, tp = _as_jax(params), _as_torch(params)
    if kind == "adamw":
        jopt = joptim.adamw(1e-3, weight_decay=0.1, mu_dtype=jnp.float32)
        topt = toptim.adamw(1e-3, weight_decay=0.1, mu_dtype=torch.float32)
    else:
        jopt, topt = joptim.sgd(1e-2), toptim.sgd(1e-2)
    # one update so that the moments and the step are not zeros
    jg = jax.tree.map(lambda x: x * 0.5, jp)
    tg = toptim.tree_map(lambda x: x * 0.5, tp)
    _, jstate = jopt.update(jg, jopt.init(jp), jp)
    _, tstate = topt.update(tg, topt.init(tp), tp)
    return {"params": jp, "opt": jstate}, {"params": tp, "opt": tstate}


def _np_leaves_ref(tree):
    return [np.asarray(l) for l in jax.tree.leaves(tree)]


def _np_leaves_port(tree):
    out = []
    C._flatten(tree, out)
    return out


def _bits(x):
    """The raw bytes of an array leaf of either package."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes(), tuple(x.shape)
    x = np.asarray(x)
    return x.tobytes(), x.shape


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_leaf_order_is_jax_tree_flatten(kind):
    jtree, ttree = _states(kind)
    want = jax.tree.leaves(jtree)
    got = _np_leaves_port(ttree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _bits(g) == _bits(w)
    if kind == "sgd":
        assert ttree["opt"].nu is None and ttree["opt"].mu is None


def test_leaf_order_with_tuples_none_and_scalars(tmp_path):
    rng = np.random.RandomState(5)
    a, b, c = rng.randn(2), rng.randn(3, 1), rng.randn(1)
    jtree = {"z": (jnp.asarray(a), None, [jnp.asarray(b)]), "a": 7,
             "m": {"y": jnp.asarray(c), "x": None}}
    ttree = {"z": (torch.from_numpy(a), None, [torch.from_numpy(b)]), "a": 7,
             "m": {"y": torch.from_numpy(c), "x": None}}
    want = jax.tree.leaves(jtree)
    got = _np_leaves_port(ttree)
    assert [_bits(g) if hasattr(g, "shape") else g for g in got] == \
        [_bits(w) if hasattr(w, "shape") else w for w in want]
    p = str(tmp_path / "t.ckpt")
    save_pytree(p, ttree)
    back, _ = restore_pytree(p, like=ttree)
    assert back["z"][1] is None and back["m"]["x"] is None and back["a"] == 7
    assert list(back) == ["z", "a", "m"] and isinstance(back["z"], tuple)
    assert torch.equal(back["z"][2][0], ttree["z"][2][0])
    jback, _ = JC.restore_pytree(p, like=jtree)
    np.testing.assert_array_equal(jback["m"]["y"], c)


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_load(tmp_path, kind, writer):
    jtree, ttree = _states(kind)
    p = str(tmp_path / "state.ckpt")
    if writer == "reference":
        JC.save_pytree(p, jtree, metadata={"step": 1})
        got, meta = restore_pytree(p, like=ttree)
        flat = _np_leaves_port(got)
        assert type(got["opt"]) is toptim.OptState
        assert isinstance(got["params"]["blocks"][1], list)
        assert all(isinstance(l, torch.Tensor) for l in flat)
        assert got["params"]["embed"]["table"].dtype == torch.bfloat16
        # without ``like``: the leaf list, in the same order
        raw, _ = restore_pytree(p)
        assert [_bits(l) for l in raw] == [_bits(l) for l in flat]
    else:
        save_pytree(p, ttree, metadata={"step": 1})
        got, meta = JC.restore_pytree(p, like=jtree)
        flat = _np_leaves_ref(got)
        assert type(got["opt"]) is joptim.OptState
        assert str(np.asarray(got["params"]["embed"]["table"]).dtype) == \
            "bfloat16"
    assert meta == {"step": 1}
    want = jax.tree.leaves(jtree)
    assert len(flat) == len(want)
    for g, w in zip(flat, want):
        assert _bits(g) == _bits(w)


def test_restore_validates_like_from_the_other_package(tmp_path):
    jtree, ttree = _states("adamw")
    p = str(tmp_path / "state.ckpt")
    JC.save_pytree(p, jtree)
    _, sgd_tree = _states("sgd")
    n_adamw, n_sgd = len(jax.tree.leaves(jtree)), len(jax.tree.leaves(
        _states("sgd")[0]))
    with pytest.raises(ValueError) as terr:
        restore_pytree(p, like=sgd_tree)
    with pytest.raises(ValueError) as jerr:
        JC.restore_pytree(p, like=_states("sgd")[0])
    assert str(terr.value) == str(jerr.value) == (
        f"checkpoint has {n_adamw} leaves, expected {n_sgd}")
