"""The output check on the CPU at small widths: a sound run is correct;
the control in the program's place, and each fault the cells can have,
are not.  The limits are the cells' own."""

from __future__ import annotations

import dataclasses
import types

import pytest
import torch

from conftest import small_cell

from bench import check, harness
from bench.programs import dense as program
from bench.reference import dense as reference

CELLS = ["llava-next-mistral-7b.vqa-prefill",
         "llava-next-mistral-7b.longdoc-prefill"]
SEED = 2**31 + 1001


def _run(cell, **kw):
    return harness.run(cell, SEED, 0.0, False, "cpu", stop_after=8, **kw)


def _with_run(cell, run):
    """The cell with the program's timed entry replaced by ``run``."""
    fake = types.ModuleType("fake_program")
    for k in ("arch", "draw_params", "draw_pools", "batch", "KERNELS"):
        setattr(fake, k, getattr(program, k))
    fake.run = run
    cell.program = fake
    return cell


def _limits(name):
    limits = harness.load_cell(name).checks["limits"]
    if any(v is None for v in limits.values()):
        pytest.skip(f"{name}'s limits are not set yet")
    return limits


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = _run(small_cell(name=name, limits=_limits(name)))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] == 8 and res["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference in float8 in the program's place."""

    def fp8(params, inputs, a, attn_impl=None):
        n = inputs["tokens"].shape[1] + (inputs["image_embeds"].shape[1]
                                         if "image_embeds" in inputs else 0)
        image = inputs["image_embeds"][0] if "image_embeds" in inputs \
            else None
        return reference.forward_rows(cell.cfg, params, inputs["tokens"][0],
                                      image, torch.arange(n),
                                      precision="fp8")[None]

    cell = small_cell(name=name, limits=_limits(name))
    res = _run(_with_run(cell, fp8))
    assert not res["correct"], res["checks"]


def _altered_answer(params, inputs, a, attn_impl=None):
    out = program.run(params, inputs, a, attn_impl).clone()
    out[0, -1] = out[0, -1].roll(1)  # one position's answer altered
    return out


def _layer_unchanged(params, inputs, a, attn_impl=None):
    """A layer that hands its input on unchanged (its step skipped)."""
    skip = {k: v for k, v in params.items()}
    layers = params["layers"]
    keep = [i for i in range(a.n_layers) if i != 1]

    def pick(t):
        return {k: pick(v) if isinstance(v, dict) else v[keep]
                for k, v in t.items()}

    skip["layers"] = pick(layers)
    return program.run(skip, inputs, dataclasses.replace(
        a, n_layers=a.n_layers - 1), attn_impl)


def _image_left_out(params, inputs, a, attn_impl=None):
    """Half the input (the image activations) left out of the forward."""
    if "image_embeds" not in inputs:
        half = dict(inputs, tokens=torch.cat(
            [inputs["tokens"][:, : inputs["tokens"].shape[1] // 2],
             torch.zeros_like(inputs["tokens"][:, inputs["tokens"]
                                               .shape[1] // 2:])], 1))
        return program.run(params, half, a, attn_impl)
    zero = dict(inputs, image_embeds=torch.zeros_like(inputs["image_embeds"]))
    return program.run(params, zero, a, attn_impl)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_altered_answer, _layer_unchanged,
                                   _image_left_out],
                         ids=lambda f: f.__name__.strip("_"))
def test_each_fault_is_not_correct(name, fault):
    res = _run(_with_run(small_cell(name=name, limits=_limits(name)), fault))
    assert not res["correct"], res["checks"]


def test_numbers_read_a_non_finite_logit_as_infinite():
    r = torch.randn(4, 10)
    p = r.clone()
    p[2, 3] = float("nan")
    assert check.numbers(p, r) == {"logit_err": float("inf"),
                                   "token_gap": float("inf")}
    assert check.numbers(r, r) == {"logit_err": 0.0, "token_gap": 0.0}


def test_judge_fails_without_a_value_or_a_limit():
    vals = {"logit_err": 0.1, "token_gap": 0.2}
    assert check.judge(vals, {"logit_err": 0.2})[0]
    assert not check.judge(vals, {"logit_err": 0.05})[0]
    assert not check.judge(vals, {"logit_err": None})[0]
    assert not check.judge(None, {"logit_err": 0.2})[0]
    assert not check.judge(vals, {})[0]


def test_the_sample_holds_the_longest_request_and_the_edges():
    from bench import traffic

    cell = small_cell()
    s = traffic.Schedule(cell.mix, cell.cfg, 3, 4096, 512)
    cyc = s.first_cycle()
    got = check.sample(cyc, 3, 16, 3, "cpu")
    longest = max(cyc, key=lambda r: r.positions)
    assert longest.index in got and len(got) == 3
    for idx, rows in got.items():
        r = s[idx]
        pos = set(rows.tolist())
        assert {r.positions - 1, r.n_image} <= pos
        assert len(pos) == min(16, r.positions)
