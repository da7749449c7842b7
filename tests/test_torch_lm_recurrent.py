"""The port's recurrent LM families against the live JAX package, on the
CPU: the Mamba2 hybrid (zamba2: groups of Mamba2 layers, one shared
attention block with a sliding window of 64 at ``reduced()``) and RWKV-6,
each at its ``reduced()`` config in float32.

The reference's ``init_params`` draws the weights, carried across by
``lm_params_from_numpy``; the batches come from each package's
``synthetic_token_stream``.  Bounds, as for the attention families
(``tests/test_torch_lm_families.py``, PERF.md §2):

* ``forward`` and ``serve_step`` logits within 1e-4 relative (max |diff|
  over max |logit|), at S 128 and 192, so that the window bites, and in
  decode past the window (the shared block's cache a shift buffer);
* ``loss_fn`` within 1e-6 relative, every gradient leaf within 1e-4 of the
  largest value in its leaf;
* decode against forward in the port alone within 2e-3;
* the quantized ``lm`` artifact (fxp8/qnm/int8-KV/pwl4): greedy tokens
  equal the reference's ``generate`` until the first step whose float64
  top-2 logit gap in the reference is under 1e-4.
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
from repro.lm import model as JM
from repro.train import trainer as JT
from repro_torch import compile as tcompile
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve_cli
from repro_torch.launch import train as ttrain_cli
from repro_torch.lm import attention as tattn
from repro_torch.lm import layers as tlayers
from repro_torch.lm import model as TM
from repro_torch.train import trainer as TT
from repro_torch.train.checkpoint import _flatten

RECURRENT = ("zamba2-7b", "rwkv6-1.6b")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _cfgs(arch, **kw):
    jc = dataclasses.replace(jget_config(arch).reduced(), **kw)
    tc = dataclasses.replace(tget_config(arch).reduced(), **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


_PARAMS = {}


def _params(arch):
    """(reference params, port params) of one reduced config, drawn once."""
    if arch not in _PARAMS:
        jp = jax.jit(JM.init_params, static_argnums=0)(
            jget_config(arch).reduced(), jax.random.PRNGKey(1))
        _PARAMS[arch] = (jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                                  "cpu"))
    return _PARAMS[arch]


def _batches(jc, tc, batch, seq, seed=1):
    jb = next(JT.synthetic_token_stream(jc, batch, seq, seed=seed))
    tb = next(TT.synthetic_token_stream(tc, batch, seq, seed=seed))
    return jb, tb


def _tokens(cfg, b, s, seed=0):
    return np.random.RandomState(seed).randint(1, cfg.vocab_size,
                                               (b, s)).astype(np.int32)


def _leaves(tree):
    out = []
    _flatten(tree, out)
    return [l.detach().numpy() for l in out]


# --------------------------------------------------------------------------
# forward, loss, gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seq", [128, 192])
@pytest.mark.parametrize("arch", RECURRENT)
def test_forward_matches_reference(arch, seq):
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    jb, tb = _batches(jc, tc, 2, seq)
    want = jax.jit(lambda p, b: JM.forward(p, b, jc))(jp, jb)
    got = TM.forward(tp, tb, tc)
    assert got.dtype == torch.float32 and got.shape == (2, seq, tc.vocab_size)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("arch", RECURRENT)
def test_loss_and_gradients_match_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    jb, tb = _batches(jc, tc, 2, 128, seed=2)
    want, jgrads = jax.value_and_grad(JM.loss_fn)(jp, jb, jc)
    got, tgrads = TT.loss_and_grads(tp, tb, tc)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    want_leaves = [np.asarray(l) for l in jax.tree.leaves(jgrads)]
    got_leaves = _leaves(tgrads)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert w.any()  # every leaf reaches the loss
        assert _rel(g, w) <= 1e-4


def test_hybrid_calls_the_one_shared_block_after_each_group(monkeypatch):
    """zamba2's forward runs each group's Mamba2 layers and then the same
    ``shared_attn`` parameters, then the tail: 2 x (2 + shared) + 1 at the
    reduced config's 7 layers, ``shared_attn_every`` 3."""
    _, tc = _cfgs("zamba2-7b")
    _, tp = _params("zamba2-7b")
    calls = [(b.__name__, p is tp["shared_attn"])
             for b, p in TM._layer_calls(tc, tp)]
    mamba, shared = ("_mamba_block", False), ("_dense_block", True)
    assert calls == [mamba, mamba, shared, mamba, mamba, shared, mamba]


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
def _int8_entries(cache):
    return {(key, k): np.asarray(v).astype(np.int32)
            for key, sub in cache.items() if key != "pos"
            for k, v in sub.items() if str(v.dtype).endswith("int8")}


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_step_matches_reference(arch, kv):
    """Six steps from a fresh cache, every step's logits within 1e-4 of the
    reference's.  With an int8 KV cache an entry may round the other way
    where its float32 input lies within rounding of a half step (zamba2's
    shared block at step 1 here: one ``v_q`` entry of group 0); the entries
    stay within 1 of the reference's, and from the first such flip on the
    logits are held to the int8 cache's own decode bound, 0.07
    (``tests/test_decode_consistency.py``)."""
    jc, tc = _cfgs(arch, kv_cache_dtype=kv)
    jp, tp = _params(arch)
    tok = _tokens(jc, 3, 6, seed=2)
    step = jax.jit(lambda p, c, b: JM.serve_step(p, c, b, jc))
    jcache = JM.init_cache(jc, 3, 8)
    tcache = TM.init_cache(tc, 3, 8, "cpu")
    assert sorted(tcache) == sorted(jcache)
    for key in tcache:
        if key != "pos":
            assert {k: tuple(v.shape) for k, v in tcache[key].items()} == \
                {k: v.shape for k, v in jcache[key].items()}, key
    flipped = False
    for i in range(tok.shape[1]):
        jl, jcache = step(jp, jcache, {"token": jnp.asarray(tok[:, i])})
        tl, tcache = TM.serve_step(tp, tcache,
                                   {"token": torch.from_numpy(tok[:, i])}, tc)
        want, got = _int8_entries(jcache), _int8_entries(tcache)
        assert sorted(got) == sorted(want)
        for key in want:
            assert np.max(np.abs(got[key] - want[key])) <= 1, (i, key)
            flipped |= not np.array_equal(got[key], want[key])
        assert _rel(tl, jl) <= (0.07 if flipped else 1e-4), i
    assert int(tcache["pos"]) == 6
    # RWKV keeps no KV cache: the setting changes nothing there
    assert bool(_int8_entries(tcache)) == (kv == "int8" and tc.ssm is not None)


def test_decode_past_the_window_matches_reference():
    """zamba2's shared block keeps ``min(sliding_window, max_len)`` = 64
    slots at max_len 80: past 64 steps its cache shifts left one slot a
    step (the reference's shift buffer).  Every step's logits within 1e-4
    of the reference's, over 72 steps, and the shifted K cache too."""
    jc, tc = _cfgs("zamba2-7b")
    jp, tp = _params("zamba2-7b")
    assert tc.sliding_window == 64
    tok = _tokens(jc, 2, 72, seed=3)
    step = jax.jit(lambda p, c, b: JM.serve_step(p, c, b, jc))
    jcache = JM.init_cache(jc, 2, 80)
    tcache = TM.init_cache(tc, 2, 80, "cpu")
    assert tcache["shared_attn"]["k"].shape[2] == 64
    for i in range(tok.shape[1]):
        jl, jcache = step(jp, jcache, {"token": jnp.asarray(tok[:, i])})
        tl, tcache = TM.serve_step(tp, tcache,
                                   {"token": torch.from_numpy(tok[:, i])}, tc)
        assert _rel(tl, jl) <= 1e-4, i
    assert _rel(tcache["shared_attn"]["k"], jcache["shared_attn"]["k"]) <= 1e-5


@pytest.mark.parametrize("arch,steps", [("zamba2-7b", 96), ("rwkv6-1.6b", 24)])
def test_decode_matches_forward(arch, steps):
    """In the port alone: decode over the caches against the forward over
    the same tokens (zamba2 past its window of 64), within 2e-3."""
    _, tc = _cfgs(arch)
    params = TM.init_params(tc, torch.Generator().manual_seed(1))
    tok = _tokens(tc, 2, steps)
    fwd = TM.forward(params, {"tokens": torch.from_numpy(tok)}, tc)
    cache = TM.init_cache(tc, 2, steps + 2, "cpu")
    dec = []
    for i in range(tok.shape[1]):
        logits, cache = TM.serve_step(params, cache,
                                      {"token": torch.from_numpy(tok[:, i])},
                                      tc)
        dec.append(logits)
    assert _rel(torch.stack(dec, 1), fwd) < 2e-3


# --------------------------------------------------------------------------
# the card's routes on the host
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", RECURRENT)
def test_kernel_routes_dispatch_once_per_call(monkeypatch, arch):
    """The card's routes patched in, at the pwl4 gate: zamba2's windowed
    prefill makes one ``flash_attention`` dispatch per shared-block call
    (window 64, S 128), and each Mamba2 layer two ``silu_pwl4``; an RWKV
    layer one ``silu_pwl4`` and one ``pwl4``.  The logits within 1e-4 of
    the reference's."""
    jc, tc = _cfgs(arch, gate_sigmoid="pwl4")
    jp, tp = _params(arch)
    seen = {"flash_attention": [], "pwl_activation": []}
    flash, pwl = tops.flash_attention, tops.pwl_activation

    def flash_spy(q, k, v, causal=True, impl="cuda", window=None):
        seen["flash_attention"].append((tuple(q.shape), causal, window))
        return flash(q, k, v, causal, impl=impl, window=window)

    def pwl_spy(x, variant="pwl4", *args, **kw):
        seen["pwl_activation"].append(variant)
        return pwl(x, variant, *args, **kw)

    monkeypatch.setattr(tops, "flash_attention", flash_spy)
    monkeypatch.setattr(tops, "pwl_activation", pwl_spy)
    monkeypatch.setattr(tattn, "on_card", lambda x: True)
    monkeypatch.setattr(tlayers, "on_card", lambda x: True)
    jb, tb = _batches(jc, tc, 2, 128, seed=4)
    want = jax.jit(lambda p, b: JM.forward(p, b, jc))(jp, jb)
    got = TM.forward(tp, tb, tc)
    if arch == "zamba2-7b":
        n_groups = tc.n_layers // tc.ssm.shared_attn_every
        assert seen["flash_attention"] == [
            ((2 * tc.n_heads, 128, tc.head_dim), True, 64)] * n_groups
        assert seen["pwl_activation"] == ["silu_pwl4"] * 2 * (
            tc.n_layers - n_groups)
    else:
        assert seen["flash_attention"] == []
        assert seen["pwl_activation"] == ["silu_pwl4", "pwl4"] * tc.n_layers
    assert _rel(got, want) <= 1e-4


# --------------------------------------------------------------------------
# float32 leaves in a bf16 model
# --------------------------------------------------------------------------
def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: l for k, v in tree.items()
                for p, l in _paths(v, prefix + (k,)).items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_float32_leaves_are_the_reference_s(arch):
    """In a bf16 model the reference keeps some leaves in float32 (a MoE
    router's, Mamba2's ``A_log``/``dt_bias``/``D``, RWKV-6's anchors, decay
    base, bonus and norms): ``float32_leaf`` names exactly those of every
    arch, and the port's ``init_params`` keeps them float32."""
    jc, tc = _cfgs(arch, dtype="bfloat16")
    want = {p: str(l.dtype) for p, l in _paths(jax.tree.map(
        lambda l: l, jax.eval_shape(lambda: JM.init_params(
            jc, jax.random.PRNGKey(0))))).items()}
    got = _paths(TM.init_params(tc, torch.Generator().manual_seed(0)))
    assert sorted(got) == sorted(want)
    for path, dtype in want.items():
        assert TM.float32_leaf(path) == (dtype == "float32"), path
        assert str(got[path].dtype).replace("torch.", "") == dtype, path


@pytest.mark.parametrize("arch", RECURRENT)
def test_float32_leaves_survive_convert_and_a_bf16_cast(arch):
    """``lm_params_from_numpy(..., dtype=bf16)`` and ``cast_params_`` to
    bf16 turn every floating leaf to bf16 but the float32 ones, which keep
    their values bit for bit."""
    _, tc = _cfgs(arch)
    jp, tp = _params(arch)
    converted = _paths(lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu", torch.bfloat16))
    cast = _paths(TM.cast_params_({k: v for k, v in
                                   jax.tree.map(lambda l: l, tp).items()},
                                  torch.bfloat16))
    n32 = 0
    for path, leaf in _paths(tp).items():
        for tree in (converted, cast):
            if TM.float32_leaf(path):
                assert tree[path].dtype == torch.float32, path
                assert torch.equal(tree[path], leaf), path
            else:
                assert tree[path].dtype == torch.bfloat16, path
        n32 += TM.float32_leaf(path)
    assert n32 == (3 * 2 if arch == "zamba2-7b" else 11)


# --------------------------------------------------------------------------
# the lowering and the CLIs
# --------------------------------------------------------------------------
QUANT = dict(number_format="fxp8", weight_scale="qnm", kv_cache="int8",
             sigmoid="pwl4")


@pytest.mark.parametrize("arch", RECURRENT)
def test_quantized_artifact_matches_reference_generate(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    jart = jcompile.compile(jcompile.LMModel(jc, jp),
                            jcompile.Target(**QUANT))
    tart = tcompile.compile(tcompile.LMModel(tc, tp), tcompile.Target(**QUANT),
                            device="cpu")
    assert tart.extras["quantized_bytes"] == jart.extras["quantized_bytes"]
    assert tart.memory_report() == jart.memory_report()
    start = np.array([3, 7, 11, 500], np.int32)
    n = 5
    jseq = jart.extras["generate"](start, n)
    tseq = tart.extras["generate"](start, n)
    assert tseq.shape == jseq.shape == (4, n + 1)
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
    assert clear.any()


@pytest.mark.parametrize("arch", RECURRENT)
def test_clis_run_the_recurrent_families_on_the_host(arch, tmp_path, capsys):
    tserve_cli.main(["--arch", arch, "--device", "cpu", "--tokens", "4",
                     "--batch", "2", "--weights", "qnm", "--kv", "int8",
                     "--gate-sigmoid", "pwl4"])
    out = capsys.readouterr().out
    assert "4 tokens x batch 2 on cpu" in out and "(qnm)" in out
    metrics = ttrain_cli.main(["--arch", arch, "--device", "cpu",
                               "--steps", "3", "--batch", "2", "--seq", "64",
                               "--ckpt-dir", str(tmp_path)])
    assert "done at step 3 on cpu" in capsys.readouterr().out
    assert metrics["final_step"] == 3
    assert all(np.isfinite(metrics["history"]))
