"""The output check that decides ``correct``.

Before the window the seed draws which requests of the schedule's first
cycle are checked (the cycle's longest always among them) and, for each,
which positions: its last, its first text token, its last image
activation, and the rest at random.  During the window the program's
float32 logits at those positions are kept (one gather a checked
request); once the window has closed the reference recomputes them from
the same weights and inputs, and two numbers are compared, each the worst
over every checked row:

* ``logit_err``: the row's RMS difference from the reference over the
  reference's RMS, ``|p - r| / |r|``;
* ``token_gap``: how far the reference's logit of the program's top token
  lies below the reference's best, ``max(r) - r[argmax(p)]``, in logits.

A non-finite logit reads as an infinite gap.  ``correct`` holds where every
number that the cell's file (``cells/<cell>.json``) gives a limit is at
or under it; a limit not yet set fails.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["sample", "numbers", "worst", "judge", "NUMBERS"]

NUMBERS = ("logit_err", "token_gap")


def sample(cycle: Sequence, requests: int, rows: int, seed: int,
           device) -> Dict[int, torch.Tensor]:
    """{request index: positions} for the checked requests of ``cycle``."""
    rng = np.random.default_rng((int(seed) + 0x5EED) % 2**64)
    longest = max(cycle, key=lambda r: (r.positions, -r.index))
    others = [r for r in cycle if r.index != longest.index]
    picked = [longest] + [others[i] for i in rng.choice(
        len(others), size=min(requests - 1, len(others)), replace=False)]
    out = {}
    for r in picked:
        must = {r.positions - 1, r.n_image}
        if r.n_image:
            must.add(r.n_image - 1)
        must = {p for p in must if 0 <= p < r.positions}
        rest = [p for p in range(r.positions) if p not in must]
        extra = rng.choice(len(rest), size=min(rows - len(must), len(rest)),
                           replace=False)
        pos = sorted(must | {rest[i] for i in extra})
        out[r.index] = torch.tensor(pos, dtype=torch.long, device=device)
    return out


def numbers(program: torch.Tensor, reference: torch.Tensor
            ) -> Dict[str, float]:
    """The compared numbers of one request's rows (rows x vocab each)."""
    p = program.to(torch.float64)
    r = reference.to(torch.float64)
    if not torch.isfinite(p).all():
        return {"logit_err": float("inf"), "token_gap": float("inf")}
    err = (p - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
    gap = r.amax(-1) - r.gather(-1, p.argmax(-1, keepdim=True))[:, 0]
    return {"logit_err": float(err.max()), "token_gap": float(gap.max())}


def worst(per_request: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(n[k] for n in per_request) for k in NUMBERS}


def judge(values: Optional[Dict[str, float]], limits: Dict
          ) -> Tuple[bool, Dict[str, Dict[str, object]]]:
    """(correct, {number: {"value", "limit"}}) over the numbers that
    ``limits`` names.  No value (nothing was checked), no number named, or
    a limit not yet set (null) fails."""
    table = {k: {"value": None if values is None else values[k],
                 "limit": lim} for k, lim in limits.items()}
    ok = values is not None and bool(table) and all(
        t["limit"] is not None and t["value"] <= t["limit"]
        for t in table.values())
    return ok, table
