"""The port's RWKV-6 layer against the live JAX package, on the CPU.

The reference scans the whole layer over time (``lax.scan``); the port
computes everything but the WKV recurrence as (B, L, ...) tensor ops and
loops over time for the recurrence alone (``repro_torch/lm/rwkv6.py``).
Seeded numpy inputs, and parameters drawn by the reference's
``rwkv6_params`` (with the zero- and constant-initialized leaves
perturbed, so that each is read) and carried over by
``lm_params_from_numpy``, go through both, at rwkv6's ``reduced()`` widths
in float32.  Bound: 1e-5 relative (max |diff| over max |reference|) — the
same function with its sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro.configs import get_config as jget_config
from repro.lm import rwkv6 as jr
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.lm import layers as tlayers
from repro_torch.lm import rwkv6 as tr

CFG = jget_config("rwkv6-1.6b").reduced()
D, D_FF, HEADS = CFG.d_model, CFG.d_ff, CFG.n_heads
PERTURBED = ("mu", "mu_x", "w0", "u", "ln_x_scale", "cm_mu_k", "cm_mu_r",
             "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(seed=0):
    jp = jr.rwkv6_params(jax.random.PRNGKey(seed), D, D_FF, HEADS,
                         jnp.float32)
    rng = np.random.RandomState(seed)
    jp = dict(jp, **{k: jp[k] + jnp.asarray(
        rng.randn(*jp[k].shape) * 0.2, jnp.float32) for k in PERTURBED})
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(seed, b, length):
    return np.random.RandomState(seed).randn(b, length, D).astype(np.float32)


def test_ddlerp_and_decay_match_reference():
    jp, tp = _params(1)
    x, x_prev = _x(2, 3, 5), _x(3, 3, 5)
    got = tr._ddlerp(tp, _t(x), _t(x_prev))
    want = jr._ddlerp(jp, jnp.asarray(x), jnp.asarray(x_prev))
    assert got.shape == (5, 3, 5, D)
    assert _rel(got, want) <= 1e-6
    assert _rel(tr._decay(tp, got[4]), jr._decay(jp, want[4])) <= 1e-6


@pytest.mark.parametrize("chunk", [4, 64])
def test_wkv_recurrence_matches_the_reference_step(chunk):
    """The port's loop (``r_t . S`` with the bonus hoisted, then ``S * w_t +
    k_t v_t^T``, the outer products formed ``chunk`` tokens at a time)
    against the reference's ``_wkv_step`` scanned step by step from a
    nonzero state: outputs and the final state."""
    rng = np.random.RandomState(4)
    b, length, n = 2, 9, D // HEADS
    r, k, v = (rng.randn(b, length, HEADS, n).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.randn(b, length, HEADS, n))).astype(np.float32)
    u = rng.randn(HEADS, n).astype(np.float32)
    s0 = rng.randn(b, HEADS, n, n).astype(np.float32)
    got, got_s = tr._wkv(*map(_t, (r, k, v, w, u, s0)), chunk=chunk)
    state, want = jnp.asarray(s0), []
    for t in range(length):
        state, out = jr._wkv_step(state, *(jnp.asarray(a[:, t])
                                           for a in (r, k, v, w)),
                                  jnp.asarray(u), HEADS)
        want.append(out)
    assert _rel(got, jnp.stack(want, 1)) <= 1e-5
    assert _rel(got_s, state) <= 1e-5


@pytest.mark.parametrize("gate", ["exact", "pwl4"])
@pytest.mark.parametrize("length", [1, 48])
def test_forward_matches_the_reference_scan(gate, length):
    jp, tp = _params(5)
    x = _x(6, 2, length)
    want = jr.rwkv6_forward(jp, jnp.asarray(x), HEADS, gate)
    got = tr.rwkv6_forward(tp, _t(x), HEADS, gate)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("gate", ["exact", "pwl4"])
def test_decode_carries_the_state(gate):
    """Sixteen decode steps from a zero cache in both packages: every step's
    output and the final WKV state and token shifts within 1e-5 of the
    reference's, the buffers updated in place; and the steps equal the
    port's forward over the same inputs."""
    jp, tp = _params(7)
    x = _x(8, 2, 16)
    jc = jr.init_rwkv_cache(2, D, HEADS, jnp.float32)
    tc = tr.init_rwkv_cache(2, D, HEADS, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    buffers = dict(tc)
    outs = []
    for i in range(x.shape[1]):
        jo, jc = jr.rwkv6_decode(jp, jnp.asarray(x[:, i:i + 1]), jc, HEADS,
                                 gate)
        to, tc = tr.rwkv6_decode(tp, _t(x[:, i:i + 1]), tc, HEADS, gate)
        assert _rel(to, jo) <= 1e-5, i
        outs.append(to)
    for k in ("wkv", "shift_tm", "shift_cm"):
        assert tc[k] is buffers[k]
        assert _rel(tc[k], jc[k]) <= 1e-5, k
    fwd = tr.rwkv6_forward(tp, _t(x), HEADS, gate)
    assert _rel(torch.cat(outs, 1), fwd) <= 1e-5


def test_pwl4_gates_launch_the_kernel_on_the_card(monkeypatch):
    """On the card's route a pwl4 layer makes two ``pwl_activation``
    dispatches: the time mix's SiLU gate (``silu_pwl4``) and the channel
    mix's receptance (``pwl4``), in the forward and in a decode step; the
    training route (``fused`` False) makes none.  Here the kernel's plain
    version runs, so the two routes agree to float32 rounding."""
    _, tp = _params(9)
    variants = []
    wrapper = tops.pwl_activation

    def spy(x, variant="pwl4", *args, **kw):
        variants.append(variant)
        return wrapper(x, variant, *args, **kw)

    monkeypatch.setattr(tops, "pwl_activation", spy)
    monkeypatch.setattr(tlayers, "on_card", lambda x: True)
    x = _t(_x(10, 2, 12))
    fused = tr.rwkv6_forward(tp, x, HEADS, "pwl4")
    assert variants == ["silu_pwl4", "pwl4"]
    eager = tr.rwkv6_forward(tp, x, HEADS, "pwl4", fused=False)
    assert len(variants) == 2
    assert _rel(fused, eager) <= 1e-6
    cache = tr.init_rwkv_cache(2, D, HEADS, torch.float32, "cpu")
    tr.rwkv6_decode(tp, x[:, :1], cache, HEADS, "pwl4")
    assert variants == ["silu_pwl4", "pwl4"] * 2


def test_params_keep_the_reference_layout_and_float32_leaves():
    jp = jr.rwkv6_params(jax.random.PRNGKey(0), D, D_FF, HEADS, jnp.bfloat16)
    tp = tr.rwkv6_params(torch.Generator().manual_seed(0), D, D_FF, HEADS,
                         torch.bfloat16, lead=(2,))
    assert sorted(tp) == sorted(jp)
    for name, leaf in jp.items():
        assert tuple(tp[name].shape) == (2,) + leaf.shape, name
        assert str(tp[name].dtype).replace("torch.", "") == \
            str(leaf.dtype), name
        if name in tr.FLOAT32_LEAVES:
            assert tp[name].dtype == torch.float32, name
            np.testing.assert_array_equal(tp[name][0].numpy(),
                                          np.asarray(leaf), err_msg=name)
    assert sorted(n for n, l in jp.items() if l.dtype == jnp.float32) == \
        sorted(tr.FLOAT32_LEAVES)
    # init scales: N(0, 1/d_in), the loras' second factor 0.1 of that
    for name, d_in, scale in (("wr", D, 1.0), ("lora_b", 320, 0.1)):
        std = float(tp[name].float().std()) * np.sqrt(d_in) / scale
        assert abs(std - 1.0) < 0.05, name


def test_a_float64_layer_runs_in_float64():
    """A float64 model computes in float64 (products, the WKV state, the
    norms), so its decode and forward agree to float64 rounding: the check
    that the two are one function where float32 rounding, amplified by a
    deep model, parts them (``chip_smoke.py`` path J)."""
    _, tp = _params(11)
    p64 = {k: v.double() for k, v in tp.items()}
    x = torch.from_numpy(_x(12, 2, 10)).double()
    fwd = tr.rwkv6_forward(p64, x, HEADS)
    assert fwd.dtype == torch.float64
    cache = tr.init_rwkv_cache(2, D, HEADS, torch.float64, "cpu")
    assert cache["wkv"].dtype == torch.float64
    outs = [tr.rwkv6_decode(p64, x[:, i:i + 1], cache, HEADS)[0]
            for i in range(x.shape[1])]
    assert _rel(torch.cat(outs, 1), fwd) <= 1e-12
    # and the float32 layer is the float64 one to float32 rounding
    assert _rel(tr.rwkv6_forward(tp, x.float(), HEADS), fwd) <= 1e-5
