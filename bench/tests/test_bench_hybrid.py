"""The zamba2-7b cell's own files on the CPU: its counts, a yardstick that
loads nothing of the port, and a run at small widths that is correct under
the cell's limits, with the control in the program's place that is not."""

from __future__ import annotations

import copy
import json
import types

import pytest
import torch

from conftest import ROOT
from test_bench_imports import _modules_after

from bench import harness
from bench.flops import hybrid as counts
from bench.programs import hybrid as program
from bench.reference import hybrid as reference

NAME = "zamba2-7b.doc-prefill"
SEED = 2**31 + 3303
CONFIG = json.loads((ROOT / "bench" / "configs" / "zamba2-7b.json")
                    .read_text())
# the published keys at small widths: 7 Mamba2 layers, calls at 1, 3, 5
SMALL = dict(hidden_size=128, attention_hidden_size=256,
             attention_head_dim=64, num_attention_heads=4,
             num_key_value_heads=4, intermediate_size=256,
             ffn_hidden_size=256, vocab_size=512, num_hidden_layers=7,
             hybrid_layer_ids=[1, 3, 5], mamba_d_state=16, mamba_headdim=32,
             n_mamba_heads=8, chunk_size=32, adapter_rank=16,
             layers_block_type=["mamba", "hybrid", "mamba", "hybrid",
                                "mamba", "hybrid", "mamba"])
MIX = {"text": {"min": 24, "max": 96, "strata": 4, "round_to": 1},
       "in_flight": 2, "trace_requests": 4, "attribution_requests": 2}


def _cell(dtype="float32"):
    cell = harness.load_cell(NAME)
    limits = cell.checks["limits"]
    if any(v is None for v in limits.values()):
        pytest.skip(f"{NAME}'s limits are not set yet")
    cell.cfg = dict(copy.deepcopy(CONFIG), **SMALL, torch_dtype=dtype)
    cell.mix = copy.deepcopy(MIX)
    cell.checks = {"check": {"requests": 2, "rows": 16}, "limits": limits}
    return cell


def test_counts_of_the_published_model():
    """~22.8 Gflop a token at the mix's mean length (GEMMs 22.06, the rest
    attention, the SSD and the head); 13 attention calls; the SSD counts
    real positions only (a ragged length costs less than its padding)."""
    per_token = counts.request_flops(CONFIG, 0, 2216) / 2216
    assert 22.0e9 < per_token < 23.5e9
    calls = counts.attention_calls(CONFIG, 0, 2216)
    assert len(calls) == 13 and calls[0][1] == 4 * 32 * 2216 * 224 * 2
    assert counts._ssd_flops(CONFIG, 1000) < counts._ssd_flops(CONFIG, 1024)


def test_the_yardstick_loads_nothing_of_the_port():
    names = _modules_after("import bench.reference.hybrid, "
                           "bench.flops.hybrid\n")
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_a_sound_run_is_correct():
    res = harness.run(_cell(), SEED, 0.0, False, "cpu", stop_after=6)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 6


def test_the_control_is_not_correct():
    """The reference with float8 products in the program's place."""

    def fp8(params, inputs, a, attn_impl=None):
        tok = inputs["tokens"][0]
        return reference.forward_rows(cell.cfg, params, tok, None,
                                      torch.arange(tok.shape[0]),
                                      precision="fp8")[None]

    cell = _cell()
    fake = types.ModuleType("fake_program")
    for k in ("arch", "draw_params", "draw_pools", "batch", "KERNELS"):
        setattr(fake, k, getattr(program, k))
    fake.run = fp8
    cell.program = fake
    res = harness.run(cell, SEED, 0.0, False, "cpu", stop_after=6)
    assert not res["correct"], res["checks"]
