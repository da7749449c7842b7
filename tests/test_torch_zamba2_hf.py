"""Zamba2-7B as published (``block_pattern "zamba2"``) against the plain
reference the benchmark judges it by (``bench/reference/hybrid.py``), on
the CPU at ``reduced()`` widths: 7 Mamba2 layers with shared-block calls
at 1, 3 and 5 (block 0, 1, 0), SSD chunks of 32 with 2 groups, dh 64 at
the published scale rule (dh / 2)^-1/2, eps 1e-5, float32, weights drawn
as the benchmark draws them (mamba_ssm's dt and A, so the state carries
across chunks).

* the forward at a length that is a multiple of the chunk and at two that
  are not, and a prefill followed by decode steps against the reference's
  full forward: each row's ``|p - r| / |r|`` within 1e-4 (float32 summed
  in other orders; the readings are ~1e-5);
* the calls follow ``layers_block_type``: the blocks in turn, one adapter
  and one linear a call;
* faults each read far above that bound (0.39-1.34): the embedding
  dropped from the block's input, the scale 1/sqrt(dh), an ungrouped gated
  norm, the padded positions given a nonzero dt (the last one's).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from bench.programs import hybrid as prog
from bench.reference import hybrid as ref
from repro_torch.configs import get_config
from repro_torch.lm import mamba2 as mamba_mod
from repro_torch.lm import model as M
from repro_torch.lm import zamba2 as zamba2_mod

TOL = 1e-4
CFG = get_config("zamba2-7b-hf").reduced()


def _hf(cfg) -> dict:
    """The reference's keys (HF's ``Zamba2Config``) for a port config."""
    s, sh = cfg.ssm, cfg.shared
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "attention_head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.norm_eps, "num_hidden_layers": cfg.n_layers,
            "hybrid_layer_ids": list(sh.layers),
            "num_mem_blocks": sh.n_blocks, "mamba_expand": s.expand,
            "mamba_headdim": s.head_dim,
            "n_mamba_heads": s.expand * cfg.d_model // s.head_dim,
            "mamba_ngroups": s.n_groups, "mamba_d_state": s.d_state}


@pytest.fixture(scope="module")
def weights():
    gen = torch.Generator().manual_seed(7)
    params = prog.draw_params(CFG, gen, torch.device("cpu"))
    tokens = torch.randint(0, CFG.vocab_size, (100,), generator=gen)
    return params, tokens


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


def _prefill_decode(params, tokens, prompt: int, steps: int, cfg=CFG):
    """The port's logits at every position: ``prefill`` over ``prompt``
    tokens, then ``steps`` decode steps."""
    logits, cache = M.prefill(params, {"tokens": tokens[None, :prompt]},
                              cfg, prompt + steps)
    dec = []
    for i in range(prompt, prompt + steps):
        step, cache = M.serve_step(params, cache,
                                   {"token": tokens[None, i]}, cfg)
        dec.append(step)
    return torch.cat([logits[0], torch.cat(dec)])


def test_published_file_is_the_port_config():
    """The benchmark's file, through its program's ``arch``, is the port's
    registered ``zamba2-7b-hf`` (its name aside)."""
    cfg = json.loads((Path(__file__).resolve().parents[1] / "bench"
                      / "configs" / "zamba2-7b.json").read_text())
    full = get_config("zamba2-7b-hf")
    assert dataclasses.replace(prog.arch(cfg), name=full.name,
                               remat=full.remat, source=full.source) == full
    assert round(full.param_count() / 1e9, 2) == 7.36


@pytest.mark.parametrize("length", [64, 45, 77])
def test_forward_matches_reference(weights, length):
    """At 2 chunks of 32 and at two ragged lengths (the last chunk partial:
    the scan's input padded and counted)."""
    params, tokens = weights
    before = mamba_mod.ssd_scan.padded_positions
    got = M.forward(params, {"tokens": tokens[None, :length]}, CFG)[0]
    assert mamba_mod.ssd_scan.padded_positions - before == \
        CFG.n_layers * (-length % CFG.ssm.chunk if length > CFG.ssm.chunk
                        else 0)
    want = ref.forward_rows(_hf(CFG), params, tokens[:length], None,
                            torch.arange(length))
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("prompt", [45, 64])
def test_prefill_then_decode_matches_reference(weights, prompt):
    """A prefill (the cache filled from the forward: each layer's conv
    history and SSM state after the last position, each call's keys and
    values) and 5 decode steps against the reference's forward over all
    the tokens."""
    params, tokens = weights
    got = _prefill_decode(params, tokens, prompt, 5)
    want = ref.forward_rows(_hf(CFG), params, tokens[:prompt + 5], None,
                            torch.arange(prompt + 5))
    assert _err(got, want) <= TOL


def test_calls_follow_the_layer_types(weights, monkeypatch):
    """A call before the mixer of each hybrid layer, the blocks in turn,
    each call with its own adapter and linear."""
    params, tokens = weights
    seen = []
    call = zamba2_mod.shared_call

    def spy(cfg, block, hybrid, *args, **kw):
        seen.append((block["attn"]["wq"]["w"].data_ptr(),
                     hybrid["linear"]["w"].data_ptr(),
                     hybrid["adapter"]["wa"]["w"].data_ptr()))
        return call(cfg, block, hybrid, *args, **kw)

    monkeypatch.setattr(zamba2_mod, "shared_call", spy)
    M.forward(params, {"tokens": tokens[None, :40]}, CFG)
    blocks = [params["shared"]["attn"]["wq"]["w"][b].data_ptr()
              for b in range(CFG.shared.n_blocks)]
    assert [blocks.index(b) for b, _, _ in seen] == [0, 1, 0]
    assert len({lin for _, lin, _ in seen}) == len({a for _, _, a in seen}) \
        == len(CFG.shared.layers) == 3
    assert [lin for _, lin, _ in seen] == [
        params["hybrid"]["linear"]["w"][c].data_ptr() for c in range(3)]


def _no_emb(monkeypatch):
    call = zamba2_mod.shared_call
    monkeypatch.setattr(zamba2_mod, "shared_call",
                        lambda cfg, b, c, x, emb, *a: call(cfg, b, c, x, x,
                                                           *a))


def _ungrouped(monkeypatch):
    norm = mamba_mod._gated_norm
    monkeypatch.setattr(mamba_mod, "_gated_norm",
                        lambda y, scale, groups, eps: norm(y, scale, 1, eps))


def _pad_with_dt(monkeypatch):
    """The scan's padding given the last position's dt (x still zero)."""
    scan = mamba_mod._ssd_chunks

    def padded(x, a, b, c, chunk):
        n = a.shape[1]
        real = int((x.abs().sum((0, 2, 3)) > 0).nonzero().max()) + 1
        if real < n:
            a = torch.cat([a[:, :real], a[:, real - 1:real].expand(
                -1, n - real, -1)], 1)
        return scan(x, a, b, c, chunk)

    monkeypatch.setattr(mamba_mod, "_ssd_chunks", padded)


@pytest.mark.parametrize("fault", ["embedding_dropped", "scale_1_over_sqrt_dh",
                                   "ungrouped_norm", "padded_dt"])
def test_faults_fail_the_tolerance(weights, monkeypatch, fault):
    """Each fault, through a prefill of 45 (ragged) and 5 decode steps,
    reads far above the bound the clean route keeps."""
    params, tokens = weights
    cfg = CFG
    if fault == "embedding_dropped":
        _no_emb(monkeypatch)
    elif fault == "scale_1_over_sqrt_dh":
        cfg = dataclasses.replace(CFG, shared=dataclasses.replace(
            CFG.shared, attn_scale=CFG.head_dim ** -0.5))
    elif fault == "ungrouped_norm":
        _ungrouped(monkeypatch)
    else:
        _pad_with_dt(monkeypatch)
    got = _prefill_decode(params, tokens, 45, 5, cfg)
    want = ref.forward_rows(_hf(CFG), params, tokens[:50], None,
                            torch.arange(50))
    assert _err(got, want) > 100 * TOL, fault
