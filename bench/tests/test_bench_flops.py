"""The frozen counts against the port's analytic cost model, and the
attention pairs by brute force."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import CONFIG, small_cfg

from bench.flops import causal_pairs
from bench.flops import dense as flops
from bench.programs import dense as program


def _analytic(cfg, s):
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.roofline.analytic import analytic_cost

    a = program.arch(cfg)
    return analytic_cost(a, ShapeSpec("bench", s, 1, "prefill"), chips=1,
                         tp=1, dp_in_pod=1, pods=1).detail["flops_fwd"]


@pytest.mark.parametrize("which", ["small", "full"])
@pytest.mark.parametrize("n_image,n_text", [(0, 1), (0, 4096), (2880, 1216),
                                            (1728, 41), (0, 30080)])
def test_request_flops_is_analytic_cost_with_exact_terms(which, n_image,
                                                         n_text):
    cfg = small_cfg() if which == "small" else json.loads(CONFIG.read_text())
    s = n_image + n_text
    h, dh, layers = (cfg["num_attention_heads"], cfg["head_dim"],
                     cfg["num_hidden_layers"])
    # analytic_cost counts S^2 / 2 pairs and no image projection
    exact_pairs = 2 * (s * (s + 1) / 2 - s * s / 2) * h * 2 * dh * layers
    proj = 2 * n_image * cfg["projector_hidden_size"] * cfg["hidden_size"]
    got = flops.request_flops(cfg, n_image, n_text)
    assert got == pytest.approx(_analytic(cfg, s) + exact_pairs + proj,
                                rel=1e-12)


@pytest.mark.parametrize("s,window", [(1, None), (7, None), (64, None),
                                      (64, 1), (64, 9), (64, 64), (64, 100),
                                      (129, 32)])
def test_causal_pairs_by_brute_force(s, window):
    q = torch.arange(s)[:, None]
    k = torch.arange(s)[None, :]
    keep = k <= q
    if window is not None:
        keep &= (q - k) < window
    assert causal_pairs(s, window) == int(keep.sum())


@pytest.mark.parametrize("window", [None, 5])
def test_attention_calls_count_each_layers_kernel(window):
    cfg = small_cfg(sliding_window=window)
    calls = flops.attention_calls(cfg, 16, 20)
    s, h, hkv, dh = 36, 4, 2, 32
    assert len(calls) == cfg["num_hidden_layers"]
    f, b = calls[0]
    assert f == 4 * causal_pairs(s, window) * h * dh
    assert b == (2 * h + 2 * hkv) * s * dh * 2  # bf16: q, o; k, v once


def test_the_counts_import_nothing_of_the_port():
    import ast
    import pathlib

    for path in pathlib.Path(flops.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)}
        assert not any(m.split(".")[0] in ("repro_torch", "repro", "jax")
                       for m in names), path
