"""The port's MoE layer against the live JAX package, on the CPU.

Seeded numpy inputs and the reference's ``moe_params`` (carried across by
``lm_params_from_numpy``) go through ``repro.lm.moe`` and
``repro_torch.lm.moe``.  What is held, and how closely:

* the routing: the experts equal, in order, the reference's ``_route``
  (``jax.lax.top_k``; ties to the lower expert), the weights within 1e-6
  relative (the k-term sum in another order);
* the integer routing tables (``slot_token``, ``token_slots``) equal, bit for
  bit, the reference's own lines run on the same weights and experts, and
  ``token_weights`` too (the port moves the weights, it does not compute
  them) — with overflowing experts, where the reference's CPU scatter lets
  the dropped write to an expert's last slot land after the kept one;
* ``apply_moe``'s output within 1e-5 relative (float32), at the reduced
  configs' capacity factor 8 (nothing drops), at the published 1.25 and at
  1.0 (experts overflow), for both router kinds, with and without shared
  experts, glu with silu and with gelu, and at a decode-sized t = 4 with
  capacity 1;
* ``quantize_lm_params`` on (L, E, d, f) expert weights bit for bit, the
  router never quantized; ``lm_params_from_numpy`` keeping the router
  float32 when it casts the rest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro.configs import get_config as jget_config
from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import quantize as jquant
from repro.lm import model as JM
from repro.lm import moe as jmoe
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import quantize as tquant
from repro_torch.lm import moe as tmoe

OUT_RTOL = 1e-5
WEIGHT_RTOL = 1e-6


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(**kw):
    return JMoEConfig(**kw), MoEConfig(**kw)


def _layer(jcfg, d, mlp_type, seed, bias_scale=0.3):
    """The reference's MoE parameters, with a nonzero aux-free bias (so it
    moves the selection), and the port's copy."""
    jp = jmoe.moe_params(jax.random.PRNGKey(seed), d, jcfg, mlp_type,
                         jnp.float32)
    if jcfg.router_aux_free:
        rng = np.random.RandomState(seed)
        jp["router"]["bias"] = jnp.asarray(
            (rng.randn(jcfg.n_experts) * bias_scale).astype(np.float32))
    return jp, lm_params_from_numpy(_np(jp), "cpu")


def _x(seed, b, s, d):
    return np.random.RandomState(seed + 100).randn(b, s, d).astype(np.float32)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_tables(weights, experts, e, cap):
    """The reference's routing tables, its lines
    (``src/repro/lm/moe.py`` ``apply_moe``) on given weights and experts."""
    t, k = experts.shape
    tk = t * k
    flat_expert = experts.reshape(tk)
    flat_token = jnp.repeat(jnp.arange(t), k)
    flat_weight = weights.reshape(tk)
    order = jnp.argsort(flat_expert)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_weight = flat_weight[order]
    counts = jnp.bincount(flat_expert, length=e)
    seg_start = jnp.cumsum(counts) - counts
    pos_in_expert = jnp.arange(tk) - seg_start[sorted_expert]
    keep = pos_in_expert < cap
    slot = sorted_expert * cap + jnp.minimum(pos_in_expert, cap - 1)
    oob_tok = jnp.int32(t)
    slot_token = jnp.full((e * cap,), oob_tok, jnp.int32)
    slot_token = slot_token.at[slot].set(
        jnp.where(keep, sorted_token, oob_tok).astype(jnp.int32), mode="drop")
    oob_slot = jnp.int32(e * cap)
    token_slots = jnp.full((t, k), oob_slot, jnp.int32)
    token_slots = token_slots.at[sorted_token, (order % k)].set(
        jnp.where(keep, slot, oob_slot).astype(jnp.int32), mode="drop")
    token_weights = jnp.zeros((t, k), jnp.float32)
    token_weights = token_weights.at[sorted_token, (order % k)].set(
        jnp.where(keep, sorted_weight, 0.0), mode="drop")
    return slot_token, token_slots, token_weights, counts


# the reference's functions, compiled once per config (eager JAX compiles
# each op anew for every new shape)
_jroute = jax.jit(jmoe._route, static_argnums=2)
_japply = jax.jit(jmoe.apply_moe, static_argnums=(2, 3, 4))


ROUTERS = {"aux_free": True, "softmax": False}
FFNS = [("glu", "silu"), ("glu", "gelu")]
FACTORS = [8.0, 1.25, 1.0]


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("mlp_type,activation", FFNS)
@pytest.mark.parametrize("router", list(ROUTERS))
def test_apply_moe_matches_reference(router, mlp_type, activation, n_shared,
                                     cf):
    """Routing, tables and output at t = 2 x 24 tokens over 8 experts (top
    2, d 32, d_ff 16)."""
    jcfg, tcfg = _cfgs(n_experts=8, top_k=2, d_ff_expert=16,
                       n_shared=n_shared, router_aux_free=ROUTERS[router],
                       capacity_factor=cf)
    d = 32
    jp, tp = _layer(jcfg, d, mlp_type, seed=len(router) + n_shared)
    x = _x(int(cf * 4), 2, 24, d)
    xf = x.reshape(-1, d)
    jw, je = _jroute(jp, jnp.asarray(xf), jcfg)
    tw, te = tmoe.route(tp, torch.from_numpy(xf), tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert _rel(tw, jw) <= WEIGHT_RTOL
    cap = tmoe.capacity(xf.shape[0], tcfg)
    slot_token, token_slots, token_weights, counts = _jax_tables(
        jnp.asarray(tw.numpy()), jnp.asarray(te.numpy()), 8, cap)
    got = tmoe.dispatch(tw, te, 8, cap)
    for g, w in zip(got, (slot_token, token_slots, token_weights)):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype
        np.testing.assert_array_equal(g.numpy(), w)
    if cf == 1.0:
        assert counts.max() > cap  # an expert overflows
    if cf == 8.0:
        assert counts.max() <= cap  # nothing drops
    want = _japply(jp, jnp.asarray(x), jcfg, mlp_type, activation)
    out = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg, mlp_type, activation)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert _rel(out, want) <= OUT_RTOL


def test_overflow_overwrites_the_last_slot_as_the_reference():
    """Five assignments to expert 0 at capacity 2 (t 6, top 1): the
    reference's table is [0, 6, 5, 6], not [0, 1, 5, 6] — the dropped
    writes land on slot 1 after token 1's — so token 1 reads the zero row
    and gets nothing from expert 0, like the dropped tokens 2-4."""
    jcfg, tcfg = _cfgs(n_experts=2, top_k=1, d_ff_expert=8,
                       router_aux_free=False, capacity_factor=0.6)
    d = 4
    jp, tp = _layer(jcfg, d, "glu", seed=3)
    w = np.zeros((d, 2), np.float32)
    w[0, 0] = w[1, 1] = 4.0
    jp["router"]["w"] = jnp.asarray(w)
    tp["router"]["w"] = torch.from_numpy(w)
    x = np.zeros((1, 6, d), np.float32)
    x[0, :5, 0] = 1.0 + np.arange(5)
    x[0, 5, 1] = 1.0
    x[0, :, 2:] = np.random.RandomState(0).randn(6, 2)
    cap = tmoe.capacity(6, tcfg)
    assert cap == 2
    weights, experts = tmoe.route(tp, torch.from_numpy(x[0]), tcfg)
    assert experts[:, 0].tolist() == [0, 0, 0, 0, 0, 1]
    slot_token, token_slots, token_weights = tmoe.dispatch(weights, experts,
                                                           2, cap)
    assert slot_token.tolist() == [0, 6, 5, 6]
    assert token_slots[:, 0].tolist() == [0, 1, 4, 4, 4, 2]
    want_tables = _jax_tables(jnp.asarray(weights.numpy()),
                              jnp.asarray(experts.numpy()), 2, cap)
    np.testing.assert_array_equal(slot_token.numpy(), want_tables[0])
    want = np.asarray(_japply(jp, jnp.asarray(x), jcfg, "glu",
                                     "silu"))
    out = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg, "glu", "silu").numpy()
    assert not out[0, 1:5].any() and np.abs(out[0, [0, 5]]).min() > 0
    assert _rel(out, want) <= OUT_RTOL


@pytest.mark.parametrize("router", list(ROUTERS))
def test_decode_sized_moe_at_capacity_one(router):
    """t = 4 tokens, 32 experts, top 4: capacity 1, so two tokens on one
    expert collide and that expert keeps none (its slot reads the zero
    row)."""
    jcfg, tcfg = _cfgs(n_experts=32, top_k=4, d_ff_expert=8, n_shared=1,
                       router_aux_free=ROUTERS[router])
    d = 16
    jp, tp = _layer(jcfg, d, "glu", seed=11, bias_scale=0.0)
    x = _x(5, 4, 1, d)
    assert tmoe.capacity(4, tcfg) == 1
    tw, te = tmoe.route(tp, torch.from_numpy(x.reshape(4, d)), tcfg)
    tables = tmoe.dispatch(tw, te, 32, 1)
    want_tables = _jax_tables(jnp.asarray(tw.numpy()),
                              jnp.asarray(te.numpy()), 32, 1)
    for g, w in zip(tables, want_tables):
        np.testing.assert_array_equal(g.numpy(), w)
    assert want_tables[3].max() > 1  # a collision
    want = _japply(jp, jnp.asarray(x), jcfg, "glu", "silu")
    out = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg, "glu", "silu")
    assert _rel(out, want) <= OUT_RTOL


@pytest.mark.parametrize("router", list(ROUTERS))
def test_equal_scores_pick_the_lower_expert_first(router):
    """A zero router gives every expert the same score: the top k are the
    k lowest experts in order, as ``jax.lax.top_k`` gives them."""
    jcfg, tcfg = _cfgs(n_experts=8, top_k=3, d_ff_expert=8,
                       router_aux_free=ROUTERS[router])
    jp, tp = _layer(jcfg, 16, "glu", seed=2, bias_scale=0.0)
    jp["router"]["w"] = jnp.zeros((16, 8), jnp.float32)
    tp["router"]["w"] = torch.zeros(16, 8)
    x = _x(7, 1, 5, 16).reshape(5, 16)
    _, je = _jroute(jp, jnp.asarray(x), jcfg)
    tw, te = tmoe.route(tp, torch.from_numpy(x), tcfg)
    assert te.tolist() == [[0, 1, 2]] * 5
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tw.numpy(), np.full((5, 3), 1 / 3,
                                                      np.float32))


def test_dispatch_keeps_the_assignments_of_each_expert_in_token_order():
    """The sort is stable: within an expert's segment the assignments keep
    their token order, so the same tokens are dropped on every device (an
    unstable sort may keep a later token and drop an earlier one)."""
    experts = torch.tensor([[1, 0], [1, 2], [0, 1], [1, 3], [2, 1]])
    weights = torch.full((5, 2), 0.5)
    slot_token, token_slots, token_weights = tmoe.dispatch(weights, experts,
                                                           4, 2)
    # expert 1 takes tokens 0, 1, 2, 3, 4 in order: 0 kept, 1 overwritten
    assert slot_token.view(4, 2).tolist() == [[0, 2], [0, 5], [1, 4],
                                              [3, 5]]
    assert token_weights[:, 0].tolist() == [0.5, 0.5, 0.5, 0.0, 0.5]


_DEEPSEEK = {}


def _deepseek_params():
    """deepseek-v3 at ``reduced()``: the reference's parameters, drawn
    once."""
    if not _DEEPSEEK:
        jcfg = jget_config("deepseek-v3-671b").reduced()
        _DEEPSEEK["p"] = jax.jit(JM.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
    return _DEEPSEEK["p"]


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("mode", ["qnm", "per_channel"])
def test_quantize_expert_weights_bit_for_bit(mode, bits):
    """deepseek-v3 at ``reduced()``: its (L, E, d, f) experts get
    per-(layer, expert, channel) or one qnm scale of shape (..., 1, f), as
    the reference's; the router stays float."""
    jp = _deepseek_params()
    spec = dict(bits=bits, mode=mode, min_size=4096)
    want = jquant.quantize_lm_params(jp, jquant.QuantSpec(**spec))
    got = tquant.quantize_lm_params(lm_params_from_numpy(_np(jp), "cpu"),
                                    tquant.QuantSpec(**spec))
    moe_w, moe_g = want["layers"]["moe"], got["layers"]["moe"]
    assert moe_g["wi"]["scale"].shape == (3, 4, 1, 64)
    assert "w" in moe_g["router"] and "w_q" not in moe_g["router"]
    flat_w, flat_g = {}, {}
    for tree, out in ((_np(want), flat_w), (got, flat_g)):
        def walk(t, path):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{path}/{k}")
            else:
                out[path] = np.asarray(t)
        walk(tree, "")
    assert sorted(flat_w) == sorted(flat_g)
    for path, w in flat_w.items():
        assert flat_g[path].dtype == w.dtype, path
        np.testing.assert_array_equal(flat_g[path], w, err_msg=path)
    assert np.asarray(moe_w["wi"]["w_q"]).dtype == np.dtype(f"int{bits}")


def test_lm_params_from_numpy_keeps_the_router_float32():
    """A dtype cast of the whole tree leaves the router's weight and its
    aux-free bias float32, as the reference keeps them."""
    jp = _np(_deepseek_params())
    tp = lm_params_from_numpy(jp, "cpu", dtype=torch.bfloat16)
    router = tp["layers"]["moe"]["router"]
    assert router["w"].dtype == router["bias"].dtype == torch.float32
    np.testing.assert_array_equal(router["w"].numpy(),
                                  jp["layers"]["moe"]["router"]["w"])
    assert tp["layers"]["moe"]["wi"]["w"].dtype == torch.bfloat16
    assert tp["dense_layers"]["mlp"]["wi"]["w"].dtype == torch.bfloat16
    assert tp["embed"]["table"].dtype == torch.bfloat16


def test_moe_params_tree_matches_reference():
    """The port's seeded tree has the reference's keys, shapes and dtypes
    (bf16 experts, a float32 router)."""
    kw = dict(n_experts=4, top_k=2, d_ff_expert=8, n_shared=1)
    jcfg, tcfg = _cfgs(**kw)
    jp = jmoe.moe_params(jax.random.PRNGKey(0), 16, jcfg, "glu",
                         jnp.bfloat16)
    tp = tmoe.moe_params(torch.Generator().manual_seed(0), 16, tcfg, "glu",
                         torch.bfloat16)
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            got[path] = t
    walk(tp, ())
    assert len(want) == len(got)
    for path, leaf in want:
        key = tuple(p.key for p in path)
        assert tuple(got[key].shape) == leaf.shape, key
        assert str(got[key].dtype).replace("torch.", "") == str(leaf.dtype)
