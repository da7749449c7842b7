"""Reduces a ``torch.profiler`` trace of a traced window to what the
per-layer metrics read.

Device activities (kernels, copies, sets) inside the window give the busy
time (the union of their intervals), the kernel launches and the time by
kernel name.  Two kinds of trace:

* of the card alone (the per-layer metrics' trace, which leaves the host's
  dispatch nearly as fast as untraced): the window is the whole trace, and
  its length is the host's reading, passed in as ``window_s``;
* of the host's operations too: the window is the span of a user
  annotation the harness opens before the requests and closes after the
  card has finished them, and each idle gap is put down to the innermost
  host operation running at its middle (host and device times come from
  the profiler's one clock).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Trace", "Event", "reduce", "from_profiler", "WINDOW"]

WINDOW = "bench.traced_window"
_COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclasses.dataclass(frozen=True)
class Event:
    """One profiler event: ``device`` True on the card; times in ns."""
    name: str
    start: int
    end: int
    device: bool
    annotation: bool = False


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    launches: int
    device_s_by_name: Dict[str, float]
    idle_by_host_op: Dict[str, float]

    def top(self, table: Dict[str, float], n: int = 10
            ) -> List[List[object]]:
        return [[k, v] for k, v in sorted(table.items(),
                                          key=lambda kv: -kv[1])[:n]]


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _host_op_at(points: List[int], host: List[Event]) -> List[str]:
    """The innermost (latest-starting) host event running at each of the
    sorted ``points``, or "no host op (Python)"."""
    host = sorted(host, key=lambda e: e.start)
    heap: List[Tuple[int, int, str]] = []
    names, j = [], 0
    for p in points:
        while j < len(host) and host[j].start <= p:
            e = host[j]
            heapq.heappush(heap, (-e.start, e.end, e.name))
            j += 1
        while heap and heap[0][1] < p:  # ended before p: never needed again
            heapq.heappop(heap)
        names.append(heap[0][2] if heap else "no host op (Python)")
    return names


def reduce(events: Iterable[Event], window: str = WINDOW,
           window_s: Optional[float] = None) -> Optional[Trace]:
    """The window's summary: the annotation ``window``'s span, or, in a
    trace without it, all of the trace, ``window_s`` long; None when the
    trace holds no annotation and no ``window_s`` is given."""
    events = list(events)
    spans = [e for e in events if e.annotation and e.name == window]
    if spans:
        w0, w1 = spans[0].start, spans[0].end
    elif window_s is not None:
        dev = [e for e in events if e.device]
        return _summary(dev, window_s, None, [])
    else:
        return None
    dev = [Event(e.name, max(e.start, w0), min(e.end, w1), True)
           for e in events if e.device and e.end > w0 and e.start < w1]
    host = [e for e in events if not e.device and not e.annotation
            and e.end > w0 and e.start < w1]
    return _summary(dev, (w1 - w0) / 1e9, (w0, w1), host)


def _summary(dev: List[Event], window_s: float,
             bounds: Optional[Tuple[int, int]], host: List[Event]) -> Trace:
    """Busy time, launches and time by name of the device events ``dev``;
    with ``bounds`` (ns) also the idle gaps by the ``host`` op at each."""
    busy = _merge([(e.start, e.end) for e in dev])
    by_name: Dict[str, float] = defaultdict(float)
    launches = 0
    for e in dev:
        by_name[e.name] += (e.end - e.start) / 1e9
        if not e.name.startswith(_COPY_PREFIXES):
            launches += 1
    idle: Dict[str, float] = defaultdict(float)
    if bounds is not None:
        w0, w1 = bounds
        gaps, t = [], w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < w1:
            gaps.append((t, w1))
        mids = [(a + b) // 2 for a, b in gaps]
        order = sorted(range(len(gaps)), key=lambda i: mids[i])
        names = _host_op_at([mids[i] for i in order], host)
        for i, name in zip(order, names):
            a, b = gaps[i]
            idle[name] += (b - a) / 1e9
    return Trace(window_s=window_s,
                 busy_s=sum(b - a for a, b in busy) / 1e9,
                 launches=launches, device_s_by_name=dict(by_name),
                 idle_by_host_op=dict(idle))


def from_profiler(prof, window: str = WINDOW,
                  window_s: Optional[float] = None) -> Optional[Trace]:
    """:func:`reduce` over a finished ``torch.profiler.profile``'s raw
    events (the profiler's own C++ records: no per-event Python objects
    beyond these)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = []
    for e in prof.profiler.kineto_results.events():
        on_card, note = e.device_type() == cuda, bool(e.is_user_annotation())
        if on_card and note:
            continue  # an annotation's mirror on the device timeline
        start = e.start_ns()
        events.append(Event(e.name(), start, start + e.duration_ns(),
                            on_card, note))
    return reduce(events, window, window_s)
