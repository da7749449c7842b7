"""Per-layer metric readers, one module a metric (``metrics/<name>.py``).

Each module has ``read(ctx) -> float | None``: the metric's value from a
traced run's :class:`Context`, or None where it finds nothing to read (no
trace, no request, no kernel of its name, no peak for this card); the
harness then leaves the metric out of the result line.
"""

from __future__ import annotations

import dataclasses
import importlib
from types import ModuleType
from typing import Dict, List, Optional

__all__ = ["Context", "read"]


@dataclasses.dataclass
class Context:
    """What a traced run hands the readers: the reduced trace of the
    traced part of the window, the requests completed in it (``(n_image,
    n_text)`` each), the requests completed in the untraced rest of the
    window and its seconds (None where there is no rest), the
    configuration file's dict with its counting module, and the card's row
    of ``peaks.json`` (None for a card not in it)."""
    trace: Optional[object]
    requests: List[tuple]
    untraced_requests: List[tuple]
    untraced_s: Optional[float]
    cfg: Dict
    flops: ModuleType
    peak: Optional[Dict]


def read(name: str, ctx: Context) -> Optional[float]:
    module = importlib.import_module(f"bench.metrics.{name}")
    return module.read(ctx)
