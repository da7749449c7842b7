"""The port's Mamba2 (SSD) layer against the live JAX package, on the CPU.

Seeded numpy inputs, and parameters drawn by the reference's
``mamba2_params`` and carried over by ``lm_params_from_numpy``, go through
the reference's functions and the port's, at zamba2's ``reduced()`` SSM
config in float32.  Bounds (relative: max |diff| over max |reference|):

* ``_segsum``, ``_causal_conv``: 1e-6 (the same sums in the same order);
* ``_ssd_chunked`` and the layer's decode: 1e-5 — float32 einsums
  contracted in another order (the port's pairwise order is written down
  in ``repro_torch/lm/mamba2.py``), across chunk sizes too;
* the layer's forward over 64 tokens: 2e-5.  Its output is the RMS norm of
  ``y * silu(z)``, which lifts the rounding of the scan's small outputs
  (each package's float32 forward parts from a float64 run of the same
  function by up to about 1e-5 here), so two float32 runs may part by
  twice that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro.configs import get_config as jget_config
from repro.lm import mamba2 as jm
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.lm import layers as tlayers
from repro_torch.lm import mamba2 as tm

D_MODEL = 128


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssm():
    s = jget_config("zamba2-7b").reduced().ssm
    assert dataclasses.asdict(s) == dataclasses.asdict(
        tget_config("zamba2-7b").reduced().ssm)
    return s


def _params(seed=0):
    jp = jm.mamba2_params(jax.random.PRNGKey(seed), D_MODEL, _ssm(),
                          jnp.float32)
    # a nonzero conv bias, dt bias and norm scale, so that each is read
    rng = np.random.RandomState(seed)
    jp = dict(jp, conv_b=jnp.asarray(rng.randn(*jp["conv_b"].shape) * 0.1,
                                     jnp.float32),
              dt_bias=jnp.asarray(rng.randn(*jp["dt_bias"].shape) * 0.5,
                                  jnp.float32),
              norm_scale=jnp.asarray(rng.randn(*jp["norm_scale"].shape)
                                     * 0.1, jnp.float32))
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _ssd_inputs(seed, b=2, length=32, h=3, p=4, n=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, length, h, p).astype(np.float32)
    a = -np.log1p(np.exp(rng.randn(b, length, h))).astype(np.float32) * 0.5
    bm = rng.randn(b, length, h, n).astype(np.float32)
    cm = rng.randn(b, length, h, n).astype(np.float32)
    return x, a, bm, cm


@pytest.mark.parametrize("shape", [(7,), (2, 3, 16), (4, 33)])
def test_segsum_matches_reference(shape):
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    got = tm._segsum(_t(x)).numpy()
    want = np.asarray(jm._segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    assert _rel(got[finite], want[finite]) <= 1e-6
    assert (got[~finite] < 0).all()


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_reference(chunk):
    x, a, bm, cm = _ssd_inputs(chunk)
    want = np.asarray(jm._ssd_chunked(*map(jnp.asarray, (x, a, bm, cm)),
                                      chunk))
    got = tm._ssd_chunked(*map(_t, (x, a, bm, cm)), chunk)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel(got, want) <= 1e-5


def test_ssd_chunked_is_one_function_across_chunk_sizes():
    """The chunk length is a blocking of one scan: every chunk size gives
    the same output, and so does the reference at another size."""
    x, a, bm, cm = _ssd_inputs(5, length=48)
    outs = {c: tm._ssd_chunked(*map(_t, (x, a, bm, cm)), c)
            for c in (4, 8, 16, 48)}
    for c in (8, 16, 48):
        assert _rel(outs[c], outs[4]) <= 1e-5, c
    want = np.asarray(jm._ssd_chunked(*map(jnp.asarray, (x, a, bm, cm)), 16))
    assert _rel(outs[4], want) <= 1e-5


def test_causal_conv_matches_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 19, 11).astype(np.float32)
    w = rng.randn(4, 11).astype(np.float32)
    b = rng.randn(11).astype(np.float32)
    got = tm._causal_conv(_t(x), _t(w), _t(b))
    want = jm._causal_conv(*map(jnp.asarray, (x, w, b)))
    assert _rel(got, want) <= 1e-6
    # causal: the first position sees only itself
    np.testing.assert_allclose(got[:, 0].numpy(), x[:, 0] * w[-1] + b,
                               rtol=1e-6)


@pytest.mark.parametrize("gate", ["exact", "pwl4"])
def test_mamba2_forward_matches_reference(gate):
    s = _ssm()
    jp, tp = _params(1)
    x = np.random.RandomState(2).randn(2, 64, D_MODEL).astype(np.float32)
    want = jm.mamba2_forward(jp, jnp.asarray(x), D_MODEL, s, gate)
    got = tm.mamba2_forward(tp, _t(x), D_MODEL, s, gate)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got, want) <= 2e-5


@pytest.mark.parametrize("gate", ["exact", "pwl4"])
def test_mamba2_decode_matches_reference_and_forward(gate):
    """Twelve decode steps from a zero state: each step's output and the
    final conv and SSM states within 1e-5 of the reference's; the buffers
    are updated in place; and the steps equal the port's forward over the
    same tokens."""
    s = _ssm()
    jp, tp = _params(3)
    x = np.random.RandomState(4).randn(2, 12, D_MODEL).astype(np.float32)
    jc = jm.init_mamba_cache(2, D_MODEL, s, jnp.float32)
    tc = tm.init_mamba_cache(2, D_MODEL, s, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    buffers = dict(tc)
    outs = []
    for i in range(x.shape[1]):
        jo, jc = jm.mamba2_decode(jp, jnp.asarray(x[:, i:i + 1]), jc,
                                  D_MODEL, s, gate)
        to, tc = tm.mamba2_decode(tp, _t(x[:, i:i + 1]), tc, D_MODEL, s,
                                  gate)
        assert _rel(to, jo) <= 1e-5, i
        outs.append(to)
    for k in ("conv", "ssm"):
        assert tc[k] is buffers[k]
        assert _rel(tc[k], jc[k]) <= 1e-5, k
    fwd = tm.mamba2_forward(tp, _t(x), D_MODEL, s, gate)
    assert _rel(torch.cat(outs, 1), fwd) <= 1e-5


def test_pwl4_gates_are_one_kernel_dispatch_each_on_the_card(monkeypatch):
    """On the card's route a pwl4 layer makes two ``pwl_activation``
    dispatches (``silu_pwl4``: the conv output's gate and the output gate),
    in the forward and in a decode step; the training route (``fused``
    False) makes none.  Here the kernel's plain version runs."""
    s = _ssm()
    _, tp = _params(5)
    variants = []
    wrapper = tops.pwl_activation

    def spy(x, variant="pwl4", *args, **kw):
        variants.append(variant)
        return wrapper(x, variant, *args, **kw)

    monkeypatch.setattr(tops, "pwl_activation", spy)
    monkeypatch.setattr(tlayers, "on_card", lambda x: True)
    x = _t(np.random.RandomState(6).randn(1, 32, D_MODEL).astype(np.float32))
    fused = tm.mamba2_forward(tp, x, D_MODEL, s, "pwl4")
    assert variants == ["silu_pwl4"] * 2
    eager = tm.mamba2_forward(tp, x, D_MODEL, s, "pwl4", fused=False)
    assert len(variants) == 2
    assert _rel(fused, eager) <= 1e-6
    cache = tm.init_mamba_cache(1, D_MODEL, s, torch.float32, "cpu")
    tm.mamba2_decode(tp, x[:, :1], cache, D_MODEL, s, "pwl4")
    assert variants == ["silu_pwl4"] * 4


def test_params_keep_the_reference_layout_and_float32_leaves():
    """``mamba2_params`` draws the reference's leaves at their shapes and
    init scales; ``A_log``, ``dt_bias`` and ``D`` are float32 in a bf16
    layer, as the reference keeps them."""
    s = _ssm()
    jp = jm.mamba2_params(jax.random.PRNGKey(0), D_MODEL, s, jnp.bfloat16)
    tp = tm.mamba2_params(torch.Generator().manual_seed(0), D_MODEL, s,
                          torch.bfloat16, lead=(3,))
    assert sorted(tp) == sorted(jp)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = tuple(k.key for k in path)
        got = tp[keys[0]] if len(keys) == 1 else tp[keys[0]][keys[1]]
        assert tuple(got.shape) == (3,) + leaf.shape, keys
        assert str(got.dtype).replace("torch.", "") == str(leaf.dtype), keys
    assert len(flat_j) == 8
    for name in tm.FLOAT32_LEAVES:
        assert tp[name].dtype == torch.float32
        # log(linspace) in two libms: within an ulp
        np.testing.assert_allclose(tp[name][1].numpy(), np.asarray(jp[name]),
                                   rtol=2e-7, atol=0)
    w = tp["conv_w"].float()
    assert abs(float(w.std()) * np.sqrt(s.d_conv) - 1.0) < 0.05
