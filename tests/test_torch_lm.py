"""The port's dense LM stack against the live JAX package, on the CPU.

Seeded inputs made with numpy, and parameters drawn by the reference's
``init_params`` and carried over by ``lm_params_from_numpy``, go through
the reference's function and the port's.  Tolerances (relative: max |diff|
over max |reference|):

* layers (norms, RoPE, MLPs, linears): 1e-5 — float32 functions that differ
  only in the order of sums and in libm's last bits;
* weight quantization and ``_quantize_kv``: bit for bit;
* ``forward`` and ``serve_step`` logits: 1e-4 — four layers of the above;
* decode against forward (the port alone): 2e-3, 0.07 with an int8 KV
  cache (the reference's own bounds, ``tests/test_decode_consistency.py``);
* greedy tokens: equal on every row until the first step whose float64
  top-2 logit gap (in the reference) is under 1e-4.

On the CPU the port's prefill takes the reference's blockwise or full
attention branch; the card's route (``_kernel_attention``: one grouped
``flash_attention`` dispatch per layer) is also taken here, through the
kernel's plain version, and its kernel is tested in
``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro import compile as jcompile
from repro.configs import get_config as jget_config
from repro.core import quantize as jquant
from repro.lm import attention as jattn
from repro.lm import layers as jlayers
from repro.lm import model as JM
from repro_torch import compile as tcompile
from repro_torch.compile.fingerprint import fingerprint_params
from repro_torch.configs import ARCH_IDS, ArchConfig, MoEConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import quantize as tquant
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve_cli
from repro_torch.lm import attention as tattn
from repro_torch.lm import layers as tlayers
from repro_torch.lm import model as TM
from repro_torch.serve import InferenceService

GATES = ("exact", "rational", "pwl2", "pwl4")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch):
    jcfg = jget_config(arch).reduced()
    tcfg = tget_config(arch).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


_PARAMS = {}


def _params(arch, jcfg, seed=1):
    """(reference params, port params) of one reduced config, drawn once."""
    key = (arch, jcfg, seed)
    if key not in _PARAMS:
        jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
        _PARAMS[key] = (jp, lm_params_from_numpy(_np(jp), "cpu"))
    return _PARAMS[key]


def _tokens(cfg, b, s, seed=0):
    return np.random.RandomState(seed).randint(1, cfg.vocab_size,
                                               (b, s)).astype(np.int32)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def test_norms_match_reference():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 64) * 2).astype(np.float32)
    scale = (rng.randn(64) * 0.1).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    assert _rel(tlayers.rmsnorm(_t(x), _t(scale)),
                jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(scale))) <= 1e-5
    assert _rel(tlayers.layernorm(_t(x), _t(scale), _t(bias)),
                jlayers.layernorm(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias))) <= 1e-5


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("dh", [32, 64])
def test_rope_matches_reference(theta, dh):
    rng = np.random.RandomState(dh)
    x = rng.randn(2, 48, 3, dh).astype(np.float32)
    pos = np.broadcast_to(np.arange(48)[None], (2, 48)) + np.array([[0], [37]])
    got = tlayers.apply_rope(_t(x), _t(pos), theta)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("activation", ["silu", "gelu", "relu2"])
@pytest.mark.parametrize("mlp_type", ["glu", "standard"])
def test_mlp_matches_reference(mlp_type, activation, gate):
    rng = np.random.RandomState(len(mlp_type) + len(activation))
    x = rng.randn(2, 7, 32).astype(np.float32)
    p = {k: {"w": (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32)}
         for k, s in (("wi", (32, 48)), ("wg", (32, 48)), ("wo", (48, 32)))}
    if mlp_type == "standard":
        del p["wg"]
    tp = {k: {"w": _t(v["w"])} for k, v in p.items()}
    got = tlayers.apply_mlp(tp, _t(x), mlp_type, activation, gate)
    want = jlayers.apply_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             mlp_type, activation, gate)
    assert _rel(got, want) <= 1e-5


def _kernel_gate(monkeypatch):
    """Route every pwl4 SiLU gate through ``ops.pwl_activation(x,
    "silu_pwl4")`` (the card's route; on these CPU tensors, the kernel's
    plain version)."""
    def route(x, gate="exact"):
        if gate == "pwl4":
            return tops.pwl_activation(x, "silu_pwl4")
        return x * tlayers.get_sigmoid(gate)(x)

    monkeypatch.setattr(tlayers, "gated_silu", route)


def _bf16(tree):
    """Floating leaves rounded to bfloat16 (the reference's arrays)."""
    return jax.tree.map(
        lambda a: a.astype(jnp.bfloat16)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _f32(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def test_pwl4_gate_kernel_route_equals_the_op_by_op_route():
    """In float32 the one-launch gate is ``x * sigmoid_pwl4(x)`` bit for bit
    (no subnormal result here, the one place the kernel flushes); on a CPU
    tensor every gate, pwl4 too, keeps the op-by-op route."""
    rng = np.random.RandomState(4)
    x = _t((rng.randn(3, 7, 48) * 4).astype(np.float32))
    eager = x * tlayers.get_sigmoid("pwl4")(x)
    with tops.count_dispatches() as c:
        fused = tops.pwl_activation(x, "silu_pwl4")
    assert c.count == 1
    assert torch.equal(fused.view(torch.int32), eager.view(torch.int32))
    with tops.count_dispatches() as c:
        for gate in GATES:
            tlayers.gated_silu(x, gate)
    assert c.count == 0
    assert torch.equal(tlayers.gated_silu(x, "pwl4"), eager)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_type", ["glu", "standard"])
def test_pwl4_gate_kernel_route_mlp_matches_reference(mlp_type, dtype,
                                                      monkeypatch):
    """The LM's MLP block with the pwl4 SiLU gate through the kernel route
    against the reference's op-by-op block.  float32: within the layers'
    1e-5.  bfloat16: the reference rounds each of the gate's ops to bf16,
    the kernel computes in float32 and rounds once; both are held to the
    block computed in float32 from the same bf16 values, the kernel route no
    further from it than 1.5x the reference's own bf16 route."""
    _kernel_gate(monkeypatch)
    rng = np.random.RandomState(len(mlp_type))
    x = (rng.randn(2, 7, 32) * 2).astype(np.float32)
    p = {k: {"w": (rng.randn(*s) / np.sqrt(s[0]) * 2).astype(np.float32)}
         for k, s in (("wi", (32, 48)), ("wg", (32, 48)), ("wo", (48, 32)))}
    if mlp_type == "standard":
        del p["wg"]
    jp, jx = jax.tree.map(jnp.asarray, p), jnp.asarray(x)
    if dtype == "bfloat16":
        jp, jx = _bf16(jp), jx.astype(jnp.bfloat16)
    tp = lm_params_from_numpy(_np(jp), "cpu")
    tx = lm_params_from_numpy(np.asarray(jx), "cpu")
    with tops.count_dispatches() as c:
        got = tlayers.apply_mlp(tp, tx, mlp_type, "silu", "pwl4")
    assert c.count == 1 and got.dtype == tx.dtype
    want = jlayers.apply_mlp(jp, jx, mlp_type, "silu", "pwl4")
    if dtype == "float32":
        assert _rel(got, want) <= 1e-5
        return
    exact = jlayers.apply_mlp(_f32(jp), jx.astype(jnp.float32), mlp_type,
                              "silu", "pwl4")
    rel_k = _rel(got.float(), exact)
    rel_o = _rel(np.asarray(want.astype(jnp.float32)), exact)
    assert 0 < rel_k <= 1.5 * rel_o, (rel_k, rel_o)


@pytest.mark.parametrize("mode", [None, "qnm", "per_channel"])
def test_linear_matches_reference(mode):
    rng = np.random.RandomState(5)
    x = rng.randn(4, 64).astype(np.float32)
    p = {"w": (rng.randn(64, 96) * 0.1).astype(np.float32),
         "b": rng.randn(96).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p)
    if mode is not None:
        spec = jquant.QuantSpec(bits=8, mode=mode, min_size=1)
        q = jquant.quantize_linear(jp["w"], spec)
        jp = {"w_q": q["w_q"], "scale": q["scale"], "b": jp["b"]}
    tp = {k: _t(v) for k, v in _np(jp).items()}
    got = tlayers.apply_linear(tp, _t(x))
    want = jlayers.apply_linear(jp, jnp.asarray(x))
    assert _rel(got, want) <= 1e-5
    if mode is not None:
        assert _rel(tlayers.wval(tp), jlayers.wval(jp)) == 0.0


# --------------------------------------------------------------------------
# weight and KV quantization, bit for bit
# --------------------------------------------------------------------------
def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{path}/{k}"))
        return out
    return {path: tree}


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("mode", ["qnm", "per_channel"])
def test_quantize_lm_params_bit_for_bit(mode, bits):
    jcfg, _ = _cfgs("qwen2-0.5b")
    jp, tp = _params("qwen2-0.5b", jcfg)
    spec_kw = dict(bits=bits, mode=mode, min_size=4096)
    want = _flat(_np(jquant.quantize_lm_params(jp, jquant.QuantSpec(**spec_kw))))
    got = _flat(tquant.quantize_lm_params(tp, tquant.QuantSpec(**spec_kw)))
    assert sorted(got) == sorted(want)
    assert any(p.endswith("/w_q") for p in got)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)
    assert (tquant.quantized_param_bytes(tquant.quantize_lm_params(
        tp, tquant.QuantSpec(**spec_kw)))
        == tuple(jquant.quantized_param_bytes(
            jquant.quantize_lm_params(jp, jquant.QuantSpec(**spec_kw)))))


def test_quantize_kv_bit_for_bit():
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 1, 2, 64) * np.exp(rng.randn(4, 1, 2, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero head: the 1e-8 floor
    x[1, 0, 1, :3] = [1.27, -1.28, 0.635]  # ties at the rounding boundary
    jq, js = jattn._quantize_kv(jnp.asarray(x))
    tq, ts = tattn._quantize_kv(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# --------------------------------------------------------------------------
# forward and decode
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch, jcfg)
    tok = _tokens(jcfg, 2, 12)
    want = jax.jit(lambda p, t: JM.forward(p, {"tokens": t}, jcfg))(
        jp, jnp.asarray(tok))
    got = TM.forward(tp, {"tokens": _t(tok)}, tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_pwl4_gate_kernel_route_matches_reference(dtype,
                                                               monkeypatch):
    """``forward`` at the pwl4 gate with every layer's gate one
    ``pwl_activation`` dispatch (path E's route on the card): float32
    logits within 1e-4 of the reference; in bfloat16 no further from the
    reference's float32 logits (same bf16 weights) than 1.5x the
    reference's own bf16 forward."""
    _kernel_gate(monkeypatch)
    jcfg, tcfg = (dataclasses.replace(c, gate_sigmoid="pwl4", dtype=dtype)
                  for c in _cfgs("qwen2-0.5b"))
    jp, _ = _params("qwen2-0.5b", _cfgs("qwen2-0.5b")[0])
    if dtype == "bfloat16":
        jp = _bf16(jp)
    tp = lm_params_from_numpy(_np(jp), "cpu")
    tok = _tokens(jcfg, 2, 12, seed=3)
    fwd = jax.jit(lambda p, t, cfg: JM.forward(p, {"tokens": t}, cfg),
                  static_argnums=2)
    want = fwd(jp, jnp.asarray(tok), jcfg)
    with tops.count_dispatches() as c:
        got = TM.forward(tp, {"tokens": _t(tok)}, tcfg)
    assert c.count == tcfg.n_layers
    if dtype == "float32":
        assert _rel(got, want) <= 1e-4
        return
    exact = fwd(_f32(jp), jnp.asarray(tok),
                dataclasses.replace(jcfg, dtype="float32"))
    rel_k, rel_o = _rel(got, exact), _rel(want, exact)
    assert rel_k <= 1.5 * rel_o, (rel_k, rel_o)


@pytest.mark.parametrize("s", [12, 16])
def test_forward_blockwise_and_full_attention(s):
    """attn_chunk 8: S=16 takes the streaming blockwise branch (two chunks),
    S=12 the materialized one, in both packages."""
    jcfg, tcfg = (dataclasses.replace(c, attn_chunk=8)
                  for c in _cfgs("qwen2-0.5b"))
    jp, tp = _params("qwen2-0.5b", jcfg)
    tok = _tokens(jcfg, 2, s, seed=s)
    want = jax.jit(lambda p, t: JM.forward(p, {"tokens": t}, jcfg))(
        jp, jnp.asarray(tok))
    assert _rel(TM.forward(tp, {"tokens": _t(tok)}, tcfg), want) <= 1e-4


@pytest.mark.parametrize("s", [12, 77])
def test_forward_through_kernel_attention_matches_reference(s, monkeypatch):
    """The card's attention route, ``_kernel_attention`` (one grouped
    ``flash_attention`` dispatch per layer over (B*Hq, S, dh) queries and
    (B*Hkv, S, dh) keys and values, nothing repeated), taken on the host,
    where the dispatch runs the kernel's plain version."""
    jcfg, tcfg = _cfgs("qwen2-0.5b")
    assert tcfg.n_heads > tcfg.n_kv_heads  # G > 1 reaches the kernel
    jp, tp = _params("qwen2-0.5b", jcfg)
    shapes = []

    def kernel_route(q, k, v, causal, *args):
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return tattn._kernel_attention(q, k, v, causal, "cuda")

    monkeypatch.setattr(tattn, "blockwise_attention", kernel_route)
    monkeypatch.setattr(tattn, "full_attention", kernel_route)
    tok = _tokens(jcfg, 2, s, seed=s)
    want = jax.jit(lambda p, t: JM.forward(p, {"tokens": t}, jcfg))(
        jp, jnp.asarray(tok))
    with tops.count_dispatches() as c:
        got = TM.forward(tp, {"tokens": _t(tok)}, tcfg)
    assert c.count == tcfg.n_layers
    assert shapes == [((2, s, tcfg.n_heads, tcfg.head_dim),
                       (2, s, tcfg.n_kv_heads, tcfg.head_dim))] * tcfg.n_layers
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_branches_agree(causal, window):
    """Blockwise and full attention compute one function in the port, as
    the windowed mask does in both packages."""
    rng = np.random.RandomState(11)
    q = rng.randn(2, 32, 4, 32).astype(np.float32)
    k, v = (rng.randn(2, 32, 2, 32).astype(np.float32) for _ in range(2))
    block = tattn.blockwise_attention(_t(q), _t(k), _t(v), causal, 8, window)
    full = tattn.full_attention(_t(q), _t(k), _t(v), causal, window)
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal, 8,
                                     window)
    assert _rel(block, want) <= 1e-5 and _rel(full, want) <= 1e-5


def _decode(cfg, params, tok, device="cpu"):
    cache = TM.init_cache(cfg, tok.shape[0], tok.shape[1] + 2, device)
    out = []
    for i in range(tok.shape[1]):
        logits, cache = TM.serve_step(params, cache,
                                      {"token": _t(tok[:, i])}, cfg)
        out.append(logits)
    return torch.stack(out, 1), cache


@pytest.mark.parametrize("arch,kv,atol", [(a, "bfloat16", 2e-3) for a in ARCH_IDS]
                         + [("qwen2-0.5b", "int8", 0.07)])
def test_decode_matches_forward(arch, kv, atol):
    _, tcfg = _cfgs(arch)
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    params = TM.init_params(tcfg, torch.Generator().manual_seed(1))
    tok = _tokens(tcfg, 2, 12)
    fwd = TM.forward(params, {"tokens": _t(tok)}, tcfg)
    dec, cache = _decode(tcfg, params, tok)
    assert int(cache["pos"]) == 12
    assert _rel(dec, fwd) < atol


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_serve_step_matches_reference(kv):
    jcfg, tcfg = (dataclasses.replace(c, kv_cache_dtype=kv)
                  for c in _cfgs("qwen2-0.5b"))
    jp, tp = _params("qwen2-0.5b", jcfg)
    tok = _tokens(jcfg, 3, 6, seed=2)
    step = jax.jit(lambda p, c, b: JM.serve_step(p, c, b, jcfg))
    jc = JM.init_cache(jcfg, 3, 8)
    tc = TM.init_cache(tcfg, 3, 8, "cpu")
    for i in range(tok.shape[1]):
        jl, jc = step(jp, jc, {"token": jnp.asarray(tok[:, i])})
        tl, tc = TM.serve_step(tp, tc, {"token": _t(tok[:, i])}, tcfg)
        assert _rel(tl, jl) <= 1e-4, i
    # the int8 cache's entries equal the reference's wherever the rounding
    # of its inputs does not decide
    if kv == "int8":
        jk = np.asarray(jc["layers"]["k_q"]).astype(np.int32)
        tk = tc["layers"]["k_q"].numpy().astype(np.int32)
        assert np.max(np.abs(jk - tk)) <= 1


def test_unported_families_raise():
    cfg = dataclasses.replace(
        tget_config("qwen2-0.5b").reduced(),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64))
    with pytest.raises(NotImplementedError, match="A13"):
        TM.init_params(cfg, torch.Generator())
    rwkv = ArchConfig(name="x", family="ssm", n_layers=1, d_model=64,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=32,
                      block_pattern="rwkv")
    with pytest.raises(NotImplementedError, match="rwkv"):
        TM.init_cache(rwkv, 1, 4, "cpu")


def test_bf16_params_round_trip_bit_for_bit():
    jcfg = dataclasses.replace(jget_config("qwen2-0.5b").reduced(),
                               dtype="bfloat16")
    jp = _np(JM.init_params(jcfg, jax.random.PRNGKey(3)))
    tp = lm_params_from_numpy(jp, "cpu")
    want, got = _flat(jp), _flat(tp)
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        assert w.dtype.name == "bfloat16" and got[path].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[path].view(torch.int16).numpy(),
                                      w.view(np.int16), err_msg=path)
    as32 = lm_params_from_numpy(jp, "cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in _flat(as32).values())


def test_fingerprint_hashes_bf16_tensors():
    a = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(torch.bfloat16)
    fp = fingerprint_params("lm", {"w": a})
    assert fp == fingerprint_params("lm", {"w": a.clone()})
    b = a.clone()
    b[1, 2] += 1
    assert fp != fingerprint_params("lm", {"w": b})
    assert fp != fingerprint_params("lm", {"w": a.float()})
    assert fp != fingerprint_params("lm", {"w": a.reshape(4, 3)})
    # numpy leaves hash as before, whatever a tensor beside them does
    n = np.arange(4, dtype=np.int32)
    assert fingerprint_params("x", {"n": n}) == fingerprint_params(
        "x", {"n": n.copy()})


# --------------------------------------------------------------------------
# compile and serve
# --------------------------------------------------------------------------
LM_TARGETS = {
    "fxp8_qnm_kv8_pwl4": dict(number_format="fxp8", weight_scale="qnm",
                              kv_cache="int8", sigmoid="pwl4"),
    "fxp8_perchannel": dict(number_format="fxp8", weight_scale="per_channel"),
    "flt": dict(number_format="flt"),
}


def _lm_models(seed=0):
    jcfg, tcfg = _cfgs("qwen2-0.5b")
    jp, tp = _params("qwen2-0.5b", jcfg, seed)
    return jcompile.LMModel(jcfg, jp), tcompile.LMModel(tcfg, tp)


@pytest.mark.parametrize("tag", list(LM_TARGETS))
def test_compiled_lm_matches_reference(tag):
    jm, tm = _lm_models()
    jart = jcompile.compile(jm, jcompile.Target(**LM_TARGETS[tag]))
    tart = tcompile.compile(tm, tcompile.Target(**LM_TARGETS[tag]),
                            device="cpu")
    assert tart.kind == "lm"
    assert tart.extras["quantized_bytes"] == jart.extras["quantized_bytes"]
    assert tart.memory_report() == jart.memory_report()
    assert (dataclasses.asdict(tart.extras["cfg"])
            == dataclasses.asdict(jart.extras["cfg"]))
    start = np.array([3, 7, 11, 500], np.int32)
    n = 6
    jseq = jart.extras["generate"](start, n)
    tseq = tart.extras["generate"](start, n)
    assert tseq.shape == jseq.shape == (4, n + 1)
    # the reference's logits along its own sequence decide which steps are
    # clear-cut (float64 top-2 gap of at least 1e-4)
    jcfg = jart.extras["cfg"]
    cache = jart.extras["init_cache"](4, n + 4)
    clear = np.ones(4, bool)
    for i in range(n):
        logits, cache = jart.extras["serve_step"](
            jart.extras["params"], cache, {"token": jnp.asarray(jseq[:, i])})
        top2 = np.sort(np.asarray(logits, np.float64), -1)[:, -2:]
        for r in range(4):
            if clear[r]:
                assert tseq[r, i + 1] == jseq[r, i + 1], (r, i)
        clear &= (top2[:, 1] - top2[:, 0]) >= 1e-4
    assert jcfg.gate_sigmoid == tart.extras["cfg"].gate_sigmoid
    np.testing.assert_array_equal(tart.predict(start), tseq[:, 1])


@pytest.mark.parametrize("number_format", ["fxp32", "auto8"])
def test_lm_rejects_what_the_reference_rejects(number_format):
    jm, tm = _lm_models()
    for cal in (None, np.zeros((4, 3), np.float32)):
        with pytest.raises(Exception) as jerr:
            jcompile.compile(jm, jcompile.Target(number_format=number_format),
                             calibration=cal)
        with pytest.raises(Exception) as terr:
            tcompile.compile(tm, tcompile.Target(number_format=number_format),
                             calibration=cal, device="cpu")
        assert type(terr.value) is type(jerr.value)
        assert str(terr.value) == str(jerr.value)
    for kw in (dict(weight_scale="pow2"), dict(kv_cache="fp8")):
        with pytest.raises(KeyError) as jerr:
            jcompile.Target(**kw)
        with pytest.raises(KeyError) as terr:
            tcompile.Target(**kw)
        assert str(terr.value) == str(jerr.value)


def test_service_generate_records_stats():
    _, tm = _lm_models()
    target = tcompile.Target(**LM_TARGETS["fxp8_qnm_kv8_pwl4"])
    art = tcompile.compile(tm, target, device="cpu")
    start = np.array([5, 9], np.int32)
    with InferenceService(device="cpu") as svc:
        ep = svc.register("lm", tm, target)
        assert ep.artifact.fingerprint == art.fingerprint
        assert svc.register("alias", tm, target).artifact is ep.artifact
        seqs = svc.generate("lm", start, 4)
        np.testing.assert_array_equal(seqs, art.extras["generate"](start, 4))
        snap = svc.stats()["lm"]
        assert snap["batches"] == 1 and snap["rows"] == 2 * 4
    with InferenceService(device="cpu") as svc:
        from repro_torch.models import init_mlp
        svc.register("mlp", init_mlp([4, 3, 2], seed=0),
                     tcompile.Target(number_format="fxp16", backend="cuda"))
        with pytest.raises(TypeError, match="no generate"):
            svc.generate("mlp", start, 2)


def test_serve_cli_runs_reduced_on_the_host(capsys):
    tserve_cli.main(["--arch", "qwen2-0.5b", "--device", "cpu", "--tokens",
                     "3", "--batch", "2", "--weights", "qnm", "--kv", "int8",
                     "--gate-sigmoid", "pwl4", "--stats"])
    out = capsys.readouterr().out
    assert "ms/token" in out and "MB ->" in out and "3 tokens x batch 2" in out
    # ported since: classifier mode (tests/test_torch_serve_net.py serves
    # it over HTTP)
    tserve_cli.main(["--classifier", "tree", "--device", "cpu",
                     "--requests", "64"])
    assert "64 rows:" in capsys.readouterr().out
