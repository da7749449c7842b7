"""Puts a ``torch.profiler`` trace's card time down to the program's own
spans (``repro_torch.spans``: records of the LM forward's layers, on the
profiler's clock), and reads the span metrics from the result.

* Each device activity (kernel, copy, set) counts to the innermost span
  open on the host when it was launched: its correlation id names its
  runtime launch call (``cudaLaunchKernel``, ``cuLaunchKernelEx``, ...),
  whose start is looked up among the spans.  A trace of the card alone
  carries those calls (CUPTI's records of the CUDA API); an activity whose
  launch the trace lacks counts to :data:`UNLAUNCHED`.
* Each idle gap of a window given on that clock counts to the innermost
  span open at its middle, or to :data:`OUTSIDE` (the caller's own code
  between forwards); its overlap with the forwards is the idle that the
  forward's own dispatch leaves.

:data:`METRICS` reads the per-layer numbers from a :class:`SpanTable`.
"""

from __future__ import annotations

import bisect
import dataclasses
import statistics
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

from bench.tracing import _COPY_PREFIXES, _merge

__all__ = ["Event", "SpanTable", "events_of", "by_span", "add", "METRICS",
           "FORWARD", "OUTSIDE", "UNLAUNCHED"]

FORWARD = "lm.forward"  # the program's span of one whole forward
OUTSIDE = "outside lm.forward"  # where no span was open
UNLAUNCHED = "no launch record"  # device work whose launch the trace lacks


class Event(NamedTuple):
    """One profiler event: ``device`` True on the card; times in ns;
    ``correlation`` ties a device activity to its runtime launch call."""
    name: str
    start: int
    end: int
    device: bool
    annotation: bool
    correlation: int


@dataclasses.dataclass
class SpanTable:
    """A trace's time by the program's spans: ``device`` maps each span's
    name to its device activities' ``[seconds, launches]`` (copies and
    sets count their seconds, not a launch), over ``busy_s`` (the union
    of their intervals); over a window of ``window_s``, ``idle`` maps each
    span to the card's idle seconds, and ``dispatch_idle_s`` is the idle
    time while the host was inside a forward; ``forward_s`` holds each
    forward's host seconds."""
    device: Dict[str, List]
    busy_s: float
    idle: Dict[str, float]
    dispatch_idle_s: float
    window_s: float
    forward_s: List[float]

    def device_s(self, span: str) -> float:
        return self.device.get(span, [0.0, 0])[0]


def events_of(prof) -> List[Event]:
    """A finished ``torch.profiler.profile``'s events (its device-side
    mirrors of host annotations left out)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = []
    for e in prof.profiler.kineto_results.events():
        on_card, note = e.device_type() == cuda, bool(e.is_user_annotation())
        if on_card and note:
            continue
        start = e.start_ns()
        events.append(Event(e.name(), start, start + e.duration_ns(),
                            on_card, note, e.correlation_id()))
    return events


def _innermost(spans: List) -> Callable[[int], str]:
    """The name of the innermost of ``spans`` (records in the order they
    opened, each naming its parent's index) open at a time, else
    :data:`OUTSIDE`.  Spans nest, so a span open at ``t`` encloses the last
    one opened by ``t``: walk up from that one."""
    starts = [sp.start_ns for sp in spans]

    def at(t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i].end_ns < t:
            i = spans[i].parent
        return spans[i].name if i >= 0 else OUTSIDE

    return at


def _gaps(busy: List[Tuple[int, int]], w0: int, w1: int
          ) -> List[Tuple[int, int]]:
    """The stretches of ``[w0, w1]`` that the merged ``busy`` leaves."""
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, min(a, w1)))
        t = max(t, b)
        if t >= w1:
            break
    if t < w1:
        gaps.append((t, w1))
    return gaps


def _overlap(intervals: List[Tuple[int, int]], a: int, b: int) -> int:
    """Nanoseconds of ``[a, b]`` inside the sorted, disjoint
    ``intervals``."""
    i = max(bisect.bisect_right(intervals, (a,)) - 1, 0)
    total = 0
    while i < len(intervals) and intervals[i][0] < b:
        total += max(min(intervals[i][1], b) - max(intervals[i][0], a), 0)
        i += 1
    return total


def by_span(events: Iterable[Event], spans: List,
            bounds: Optional[Tuple[int, int]] = None) -> SpanTable:
    """``events``' device time by the innermost of ``spans`` open at each
    launch call (:data:`UNLAUNCHED` where the trace holds no launch of its
    correlation id); with ``bounds`` (ns, the spans' clock) also the
    window's idle gaps, each by the innermost span open at its middle, and
    their overlap with the forwards."""
    events = list(events)
    at = _innermost(spans)
    launched = {e.correlation: e.start for e in events
                if not e.device and not e.annotation
                and e.name.startswith("cu")}
    dev = [e for e in events if e.device]
    device: Dict[str, List] = defaultdict(lambda: [0.0, 0])
    for e in dev:
        t = launched.get(e.correlation)
        row = device[UNLAUNCHED if t is None else at(t)]
        row[0] += (e.end - e.start) / 1e9
        if not e.name.startswith(_COPY_PREFIXES):
            row[1] += 1
    busy = _merge([(e.start, e.end) for e in dev])
    forwards = [(sp.start_ns, sp.end_ns) for sp in spans
                if sp.name == FORWARD and sp.end_ns]
    idle: Dict[str, float] = defaultdict(float)
    dispatch_ns, window_s = 0, 0.0
    if bounds is not None:
        w0, w1 = bounds
        window_s = (w1 - w0) / 1e9
        for a, b in _gaps(busy, w0, w1):
            idle[at((a + b) // 2)] += (b - a) / 1e9
            dispatch_ns += _overlap(forwards, a, b)
    return SpanTable(device=dict(device),
                     busy_s=sum(b - a for a, b in busy) / 1e9,
                     idle=dict(idle), dispatch_idle_s=dispatch_ns / 1e9,
                     window_s=window_s,
                     forward_s=[(b - a) / 1e9 for a, b in forwards])


def add(a: SpanTable, b: SpanTable) -> SpanTable:
    """Two windows' tables as one."""
    device: Dict[str, List] = {k: list(v) for k, v in a.device.items()}
    for k, (s, n) in b.device.items():
        row = device.setdefault(k, [0.0, 0])
        row[0] += s
        row[1] += n
    idle = dict(a.idle)
    for k, s in b.idle.items():
        idle[k] = idle.get(k, 0.0) + s
    return SpanTable(device=device, busy_s=a.busy_s + b.busy_s, idle=idle,
                     dispatch_idle_s=a.dispatch_idle_s + b.dispatch_idle_s,
                     window_s=a.window_s + b.window_s,
                     forward_s=a.forward_s + b.forward_s)


def _readable(t: Optional[SpanTable]) -> Optional[SpanTable]:
    """``t`` where it has something to read: device work, and the
    program's forwards (a port without spans records none)."""
    if t is None or t.busy_s <= 0 or not t.forward_s:
        return None
    return t


def _share(span: str) -> Callable[[Optional[SpanTable]], Optional[float]]:
    def read(t):
        t = _readable(t)
        return None if t is None else 100.0 * t.device_s(span) / t.busy_s
    return read


def _forward_host_ms(t: Optional[SpanTable]) -> Optional[float]:
    t = _readable(t)
    return None if t is None else 1e3 * statistics.median(t.forward_s)


def _dispatch_idle_share(t: Optional[SpanTable]) -> Optional[float]:
    t = _readable(t)
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * t.dispatch_idle_s / t.window_s


# each metric: its value from a table, None where there is nothing to read
METRICS: Dict[str, Callable[[Optional[SpanTable]], Optional[float]]] = {
    # the device time of the kernels launched inside the span (no span
    # inside it open) over the busy time, in %
    "norm_device_share": _share("lm.norm"),
    "rope_device_share": _share("lm.rope"),
    "gate_device_share": _share("lm.gate"),
    "logits_device_share": _share("lm.logits"),
    # the median forward's host time, entry to return (its dispatch, plus
    # any wait on a full launch queue), in ms
    "forward_host_ms": _forward_host_ms,
    # the window's idle seconds while the host was inside a forward over
    # the window, in %
    "dispatch_idle_share": _dispatch_idle_share,
}
