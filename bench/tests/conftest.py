"""Puts the checkout's root and ``src/`` on the path, and builds the small
cells the CPU tests drive: the real configuration's keys at small widths,
and a small mix of the same shape."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

CONFIG = ROOT / "bench" / "configs" / "llava-next-mistral-7b.json"
SMALL = dict(num_hidden_layers=4, hidden_size=128, num_attention_heads=4,
             num_key_value_heads=2, head_dim=32, intermediate_size=256,
             vocab_size=512, image_token_index=500, projector_hidden_size=128,
             # the anyres tiling at a twelfth of the size: a 2 x 2 patch tile
             vision_config={"image_size": 28, "patch_size": 14,
                            "hidden_size": 64},
             image_grid_pinpoints=[[28, 56], [56, 28], [56, 56], [84, 28],
                                   [28, 84]])
# small mixes of the shape of each traffic file: by the traffic's name
SMALL_MIXES = {
    "vqa": {"image": {"sizes": [[56, 40], [40, 56], [56, 56]]},
            "text": {"min": 8, "max": 96, "strata": 3, "round_to": 1},
            "in_flight": 2, "trace_requests": 4, "attribution_requests": 2},
    "longdoc": {"text": {"lengths": [48, 160, 72, 104]},
                "in_flight": 2, "trace_requests": 4,
                "attribution_requests": 2},
}


def small_cfg(dtype: str = "bfloat16", **over) -> dict:
    cfg = json.loads(CONFIG.read_text())
    cfg.update(SMALL, torch_dtype=dtype, **over)
    return cfg


def small_cell(dtype: str = "bfloat16", name: str =
               "llava-next-mistral-7b.vqa-prefill", mix=None, limits=None,
               **over):
    """A cell of BENCHMARK.json with its configuration cut to small widths
    (its limits and metrics as the real cell has them)."""
    from bench import harness

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix_name = {w["name"]: w["traffic"] for w in manifest["workloads"]}[name]
    cell = harness.load_cell(name, manifest=manifest)
    cell.cfg = small_cfg(dtype, **over)
    cell.mix = copy.deepcopy(mix or SMALL_MIXES[mix_name])
    cell.checks = {"check": {"requests": 3, "rows": 16},
                   "limits": limits or cell.checks["limits"]}
    return cell


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, not at
    import, so every worker collects the same tests)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
