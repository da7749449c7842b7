"""The port's attention families served, against the live JAX package on
the CPU: ``serve_step`` of grok-1, deepseek-v3 (MLA's latent cache) and
llava-next at their ``reduced()`` configs in float32, decode against
forward, the quantized ``lm`` artifact against the reference's
``generate``, hubert's refusal (encoder-only) and the two CLIs.

Weights and bounds as in ``tests/test_torch_lm_families.py``:

* ``serve_step`` logits within 1e-4 over six steps, with a native and an
  int8 cache (its int8 entries within 1 of the reference's);
* decode against forward in the port alone within 2e-3: the reduced MoE
  configs' capacity factor 8 drops nothing, so decode equals prefill; with
  deepseek-v3's int8 latent cache within 0.5, the reference's own bound
  (``tests/test_decode_consistency.py``: the latent is already a
  compression of K/V, and int8 on it is lossier than on per-head KV);
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
from repro_torch import compile as tcompile
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as tserve_cli
from repro_torch.launch import train as ttrain_cli
from repro_torch.lm import model as TM

DECODERS = ("grok-1-314b", "deepseek-v3-671b", "llava-next-mistral-7b")


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


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
def _tokens(cfg, b, s, seed=0):
    return np.random.RandomState(seed).randint(1, cfg.vocab_size,
                                               (b, s)).astype(np.int32)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch", DECODERS)
def test_serve_step_matches_reference(arch, kv):
    jc, tc = _cfgs(arch, kv_cache_dtype=kv)
    jp, tp = _params(arch)
    tok = _tokens(jc, 3, 6, seed=2)
    step = jax.jit(lambda p, c, b: JM.serve_step(p, c, b, jc))
    jcache = JM.init_cache(jc, 3, 8)
    tcache = TM.init_cache(tc, 3, 8, "cpu")
    assert sorted(tcache) == sorted(jcache)
    for i in range(tok.shape[1]):
        jl, jcache = step(jp, jcache, {"token": jnp.asarray(tok[:, i])})
        tl, tcache = TM.serve_step(tp, tcache,
                                   {"token": torch.from_numpy(tok[:, i])}, tc)
        assert _rel(tl, jl) <= 1e-4, i
    assert int(tcache["pos"]) == 6
    if kv == "int8":
        key = "c_kv_q" if tc.mla is not None else "k_q"
        jq = np.asarray(jcache["layers"][key]).astype(np.int32)
        tq = tcache["layers"][key].numpy().astype(np.int32)
        assert np.max(np.abs(jq - tq)) <= 1


@pytest.mark.parametrize("arch,kv,atol", [(a, "bfloat16", 2e-3)
                                          for a in DECODERS]
                         + [("deepseek-v3-671b", "int8", 0.5)])
def test_decode_matches_forward(arch, kv, atol):
    _, tc = _cfgs(arch, kv_cache_dtype=kv)
    params = TM.init_params(tc, torch.Generator().manual_seed(1))
    tok = _tokens(tc, 2, 12)
    fwd = TM.forward(params, {"tokens": torch.from_numpy(tok)}, tc)
    cache = TM.init_cache(tc, 2, 14, "cpu")
    dec = []
    for i in range(tok.shape[1]):
        logits, cache = TM.serve_step(params, cache,
                                      {"token": torch.from_numpy(tok[:, i])},
                                      tc)
        dec.append(logits)
    assert _rel(torch.stack(dec, 1), fwd) < atol


QUANT = dict(number_format="fxp8", weight_scale="qnm", kv_cache="int8",
             sigmoid="pwl4")


@pytest.mark.parametrize("arch", DECODERS)
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


def test_encoder_only_has_no_decode_serving():
    """hubert compiles to no ``lm`` artifact, in either package (the same
    error), and the serve CLI refuses it."""
    jc, tc = _cfgs("hubert-xlarge")
    jp, tp = _params("hubert-xlarge")
    with pytest.raises(ValueError) as jerr:
        jcompile.compile(jcompile.LMModel(jc, jp),
                         jcompile.Target(number_format="flt"))
    with pytest.raises(ValueError) as terr:
        tcompile.compile(tcompile.LMModel(tc, tp),
                         tcompile.Target(number_format="flt"),
                         device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve_cli.main(["--arch", "hubert-xlarge", "--device", "cpu"])


def test_clis_run_the_new_families_reduced_on_the_host(tmp_path, capsys):
    tserve_cli.main(["--arch", "deepseek-v3-671b", "--device", "cpu",
                     "--tokens", "4", "--batch", "2"])
    assert "4 tokens x batch 2 on cpu" in capsys.readouterr().out
    metrics = ttrain_cli.main(["--arch", "hubert-xlarge", "--device", "cpu",
                               "--steps", "3", "--batch", "2", "--seq", "16",
                               "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "done at step 3 on cpu" in out
    assert metrics["final_step"] == 3
    assert all(np.isfinite(metrics["history"]))


def test_fingerprint_hashes_chunks_and_sees_every_write():
    """A full-width model's parameters are hashed in 64 MiB chunks in
    parallel threads, every registration: equal bytes give one
    fingerprint, and any write changes it, also one the tensor's version
    counter does not see (through a numpy view or ``.data``)."""
    from repro_torch.compile import fingerprint as fp

    g = torch.Generator().manual_seed(0)
    w = torch.randn((1 << 25) + 7, generator=g).to(torch.bfloat16)
    assert w.numel() * w.element_size() > fp._CHUNK
    first = fp.fingerprint_params("lm", {"w": w})
    assert fp.fingerprint_params("lm", {"w": w}) == first
    assert fp.fingerprint_params("lm", {"w": w.clone()}) == first
    w.view(torch.int16).numpy()[-1] += 1
    second = fp.fingerprint_params("lm", {"w": w})
    assert second != first
    w.data[0] += 1
    assert fp.fingerprint_params("lm", {"w": w}) not in (first, second)
    with torch.inference_mode():
        frozen = w.clone()
    assert fp.fingerprint_params("lm", {"w": frozen}) == \
        fp.fingerprint_params("lm", {"w": w})
