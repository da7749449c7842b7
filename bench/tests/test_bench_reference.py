"""The plain reference against the port's plain route, on the CPU at small
widths: the same weights and inputs give the same logits."""

from __future__ import annotations

import pytest
import torch

from conftest import small_cfg

from bench.programs import dense as program
from bench.reference import dense as reference


def _draw(cfg, seed):
    a = program.arch(cfg)
    gen = torch.Generator().manual_seed(seed)
    params = program.draw_params(a, gen, torch.device("cpu"))
    pools = program.draw_pools(a, 512, 256, gen, torch.device("cpu"))
    return a, params, pools


@pytest.mark.parametrize("n_image,n_text", [(0, 37), (32, 5), (48, 64)])
def test_reference_matches_the_ports_plain_route(n_image, n_text):
    cfg = small_cfg("float32")
    a, params, pools = _draw(cfg, 7)
    b = program.batch(pools, n_image, n_text, 3, 11)
    got = program.run(params, b, a, attn_impl="ref")[0]
    rows = torch.arange(n_image + n_text)
    image = b["image_embeds"][0] if n_image else None
    want = reference.forward_rows(cfg, params, b["tokens"][0], image, rows)
    err = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max()
    assert float(err) < 1e-5


def test_reference_rows_are_the_whole_forwards_rows():
    cfg = small_cfg("float32")
    _, params, pools = _draw(cfg, 3)
    b = program.batch(pools, 16, 20, 0, 0)
    whole = reference.forward_rows(cfg, params, b["tokens"][0],
                                   b["image_embeds"][0], torch.arange(36))
    rows = torch.tensor([0, 15, 16, 35])
    part = reference.forward_rows(cfg, params, b["tokens"][0],
                                  b["image_embeds"][0], rows)
    torch.testing.assert_close(part, whole[rows], rtol=0, atol=0)


def test_query_blocks_do_not_change_the_attention(monkeypatch):
    cfg = small_cfg("float32", sliding_window=None)
    _, params, pools = _draw(cfg, 5)
    b = program.batch(pools, 0, 50, 0, 0)
    rows = torch.arange(50)
    one = reference.forward_rows(cfg, params, b["tokens"][0], None, rows)
    monkeypatch.setattr(reference, "_SCORE_BLOCK", 4 * 50 * 7)  # 7 rows
    blocked = reference.forward_rows(cfg, params, b["tokens"][0], None, rows)
    torch.testing.assert_close(blocked, one, rtol=1e-5, atol=1e-5)


def test_the_window_masks_as_the_port_does():
    cfg = small_cfg("float32", sliding_window=9)
    a, params, pools = _draw(cfg, 9)
    b = program.batch(pools, 0, 40, 0, 0)
    got = program.run(params, b, a, attn_impl="ref")[0]
    want = reference.forward_rows(cfg, params, b["tokens"][0], None,
                                  torch.arange(40))
    assert float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max()) < 1e-5


def test_the_control_is_not_the_reference():
    cfg = small_cfg("float32")
    _, params, pools = _draw(cfg, 1)
    b = program.batch(pools, 16, 30, 0, 0)
    rows = torch.arange(46)
    ref = reference.forward_rows(cfg, params, b["tokens"][0],
                                 b["image_embeds"][0], rows)
    low = reference.forward_rows(cfg, params, b["tokens"][0],
                                 b["image_embeds"][0], rows, precision="fp8")
    err = float(((low - ref).norm(dim=-1) / ref.norm(dim=-1)).max())
    assert 0.02 < err < 1.0


def test_the_files_eps_is_the_ports():
    """The port's RMSNorm has no eps option: a file stating another eps
    than the one it runs is refused, not run as something it is not."""
    import inspect

    from repro_torch.lm.layers import rmsnorm

    port = inspect.signature(rmsnorm).parameters["eps"].default
    assert program.PORT_RMS_EPS == port
    assert small_cfg()["rms_norm_eps"] == port
    with pytest.raises(ValueError):
        program.arch(small_cfg(rms_norm_eps=1e-5))
