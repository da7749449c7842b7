"""The port's Multi-head Latent Attention against the live JAX package, on
the CPU.

Seeded numpy inputs and the reference's ``mla_params`` (carried across by
``lm_params_from_numpy``) go through ``repro.lm.mla`` and
``repro_torch.lm.mla`` at two shapes: deepseek-v3's ``reduced()`` dims (q/k
16 + 16 rotary, v 32: no padding) and deepseek-v3's own head dims at small
ranks (q/k 128 + 64 = 192, v 128 zero-padded to 192, the kernel's new
instance).  Bounds (relative: max |diff| over max |reference|):

* ``mla_attention`` within 1e-5 through the host's branches (``"cuda"``
  on a CPU tensor and ``"train"``: the reference's full and blockwise
  attention) and through the card's route taken on the host (one
  ``flash_attention`` dispatch over (B*H, S, 192), whose plain version runs
  here);
* ``mla_decode`` step by step within 1e-4 of the reference (the dense
  decode's bound in ``tests/test_torch_lm.py``), with a native and an int8
  latent cache; the int8 entries within 1 of the reference's (a rounding
  its inputs decide), the scales within 1e-6;
* decode against prefill in the port alone: 2e-3, 0.07 with the int8
  cache (the reference's own bounds, ``tests/test_decode_consistency.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro.configs.base import MLAConfig as JMLAConfig
from repro.lm import mla as jmla
from repro_torch.configs.base import MLAConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.lm import mla as tmla

SHAPES = {
    "reduced": dict(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=16,
                    qk_rope_head_dim=16, v_head_dim=32),
    "dh192": dict(q_lora_rank=32, kv_lora_rank=24, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
}
D, HEADS, THETA = 64, 2, 10_000.0


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _setup(shape, seed=0):
    jm, tm = JMLAConfig(**SHAPES[shape]), MLAConfig(**SHAPES[shape])
    jp = jmla.mla_params(jax.random.PRNGKey(seed), D, HEADS, jm, jnp.float32)
    # nonzero norm scales, so that they count
    rng = np.random.RandomState(seed)
    for k in ("q_norm", "kv_norm"):
        jp[k]["scale"] = jnp.asarray(
            rng.randn(*jp[k]["scale"].shape).astype(np.float32) * 0.1)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, tm, jp, tp


def _x(seed, b, s):
    return np.random.RandomState(seed + 50).randn(b, s, D).astype(np.float32)


def _ref(jp, x, jm, chunk):
    return np.asarray(jmla.mla_attention(jp, jnp.asarray(x), n_heads=HEADS,
                                         m=jm, rope_theta=THETA, chunk=chunk))


@pytest.mark.parametrize("impl", ["cuda", "train"])
@pytest.mark.parametrize("s", [12, 16])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_mla_attention_matches_reference(shape, s, impl):
    """Chunk 8: S 16 takes the blockwise branch (two chunks), S 12 the
    full one, in both packages."""
    jm, tm, jp, tp = _setup(shape)
    x = _x(s, 2, s)
    want = _ref(jp, x, jm, 8)
    with tops.count_dispatches() as c:
        got = tmla.mla_attention(tp, torch.from_numpy(x), n_heads=HEADS,
                                 m=tm, rope_theta=THETA, chunk=8, impl=impl)
    assert c.count == 0 and got.shape == x.shape
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("impl", ["cuda", "ref"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_mla_kernel_route_matches_reference(shape, impl, monkeypatch):
    """The card's route taken on the host: q and k of qk_nope + qk_rope
    dims, v zero-padded to them, one ``flash_attention`` dispatch over
    (B*H, S, dh) with K/V ungrouped (the rotary key repeated to every
    head), the output sliced back to v's dims."""
    jm, tm, jp, tp = _setup(shape, seed=1)
    shapes = []
    plain = tfa.flash_attention_plain

    def spy(q, k, v, causal=True, scale=None, window=None):
        assert window is None  # MLA has no sliding window
        shapes.append((tuple(q.shape), tuple(k.shape), causal))
        return plain(q, k, v, causal, scale, window=window)

    monkeypatch.setattr(tmla, "on_card", lambda x: True)
    monkeypatch.setattr(tops, "flash_attention_plain", spy)
    x = _x(3, 2, 21)
    want = _ref(jp, x, jm, 8)
    with tops.count_dispatches() as c:
        got = tmla.mla_attention(tp, torch.from_numpy(x), n_heads=HEADS,
                                 m=tm, rope_theta=THETA, chunk=8, impl=impl)
    dh = tm.qk_nope_head_dim + tm.qk_rope_head_dim
    assert c.count == 1
    assert shapes == [((2 * HEADS, 21, dh), (2 * HEADS, 21, dh), True)]
    assert _rel(got, want) <= 1e-5


def _decode(mla, p, m, x, cache, steps, torch_side):
    out = []
    for i in range(steps):
        xi = x[:, i:i + 1]
        if torch_side:
            y, cache = mla.mla_decode(p, torch.from_numpy(xi), cache,
                                      torch.tensor(i, dtype=torch.int32),
                                      n_heads=HEADS, m=m, rope_theta=THETA)
            out.append(y.numpy().copy())
        else:
            y, cache = jax.jit(lambda p, x, c, pos: mla.mla_decode(
                p, x, c, pos, n_heads=HEADS, m=m, rope_theta=THETA))(
                    p, jnp.asarray(xi), cache, jnp.int32(i))
            out.append(np.asarray(y))
    return np.concatenate(out, 1), cache


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_mla_decode_matches_reference(shape, quantized):
    jm, tm, jp, tp = _setup(shape, seed=2)
    x = _x(4, 3, 6)
    jc = jmla.init_mla_cache(3, 8, jm, jnp.float32, quantized=quantized)
    tc = tmla.init_mla_cache(3, 8, tm, torch.float32, "cpu",
                             quantized=quantized)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
        assert str(tc[k].dtype).replace("torch.", "") == str(jc[k].dtype)
    want, jc = _decode(jmla, jp, jm, x, jc, 6, False)
    got, tc = _decode(tmla, tp, tm, x, tc, 6, True)
    assert _rel(got, want) <= 1e-4
    if quantized:
        jq = np.asarray(jc["c_kv_q"]).astype(np.int32)
        assert np.max(np.abs(tc["c_kv_q"].numpy().astype(np.int32) - jq)) <= 1
        assert _rel(tc["c_kv_scale"], jc["c_kv_scale"]) <= 1e-6
    assert _rel(tc["k_rope"], jc["k_rope"]) <= 1e-5


@pytest.mark.parametrize("quantized,atol", [(False, 2e-3), (True, 0.07)])
def test_mla_decode_matches_prefill(quantized, atol):
    """The absorbed decode over the latent cache against the materialized
    prefill, in the port alone (deepseek-v3's head dims)."""
    _, tm, _, tp = _setup("dh192", seed=3)
    x = _x(5, 2, 10)
    fwd = tmla.mla_attention(tp, torch.from_numpy(x), n_heads=HEADS, m=tm,
                             rope_theta=THETA)
    cache = tmla.init_mla_cache(2, 12, tm, torch.float32, "cpu",
                                quantized=quantized)
    dec, _ = _decode(tmla, tp, tm, x, cache, 10, True)
    assert _rel(dec, fwd.numpy()) < atol
