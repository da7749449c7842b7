"""Per-endpoint SLO tracking: rolling-window histograms + violation counters.

A copy of :mod:`repro.serve.net.slo` for the PyTorch port.
:class:`~repro_torch.serve.router.EndpointStats` keeps a bounded deque of raw
latencies — fine for in-process dashboards, but an SLO is a statement about
*recent* behavior ("p99 under 50ms over the last minute"), which a
count-bounded window cannot express under varying load (4096 samples is
4 seconds at 1k QPS and an hour at 1 QPS).  The tracker here is
time-bounded: a :class:`RollingHistogram` of log-spaced buckets whose
counts age out slice by slice, so percentiles always describe the
configured window no matter the request rate — and it costs O(buckets)
memory instead of O(requests).

Percentiles are read at a bucket *upper* edge (nearest-rank over the
merged counts): conservative by at most one bucket ratio (~15%), never an
interpolation past the largest observed bucket.

The HTTP front end records full request latency (admission + queueing +
compute + serialization) here — the number a client actually experiences —
and surfaces it in ``/v1/stats`` next to each endpoint's scheduler stats.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Optional

import numpy as np

__all__ = ["RollingHistogram", "SLOTracker"]

# Log-spaced latency buckets: 10us ... ~12s at ratio 1.15, overflow last.
_EDGE_START = 1e-5
_EDGE_RATIO = 1.15
_N_BUCKETS = 100
BUCKET_EDGES_S = _EDGE_START * _EDGE_RATIO ** np.arange(_N_BUCKETS)


class RollingHistogram:
    """Latency histogram over a sliding time window.

    The window is split into ``slices`` sub-intervals; each recorded value
    lands in the slice covering ``now`` and whole slices age out as time
    advances — O(buckets x slices) memory, O(1) record, no per-request
    allocation.
    """

    def __init__(self, window_s: float = 60.0, slices: int = 12):
        if window_s <= 0 or slices < 1:
            raise ValueError("window_s must be > 0 and slices >= 1")
        self.window_s = float(window_s)
        self.slices = int(slices)
        self._slice_s = self.window_s / self.slices
        self._counts = np.zeros((self.slices, _N_BUCKETS + 1), np.int64)
        self._epoch = np.full(self.slices, -1, np.int64)  # abs slice index
        self._lock = threading.Lock()

    def _slot(self, now: float) -> int:
        """Ring slot for ``now``, cleared if it held an expired slice."""
        epoch = int(now // self._slice_s)
        s = epoch % self.slices
        if self._epoch[s] != epoch:
            self._counts[s] = 0
            self._epoch[s] = epoch
        return s

    def record(self, value_s: float, now: Optional[float] = None) -> None:
        if now is None:
            now = time.perf_counter()
        b = int(np.searchsorted(BUCKET_EDGES_S, value_s, side="left"))
        with self._lock:
            self._counts[self._slot(now)][b] += 1

    def merged(self, now: Optional[float] = None) -> np.ndarray:
        """Bucket counts over the live window (expired slices dropped).

        The strict ``>`` is load-bearing: with E = ``now``'s absolute slice
        index, the oldest live slice is E - slices + 1, whose records are at
        most ``window_s`` old (a record in slice e was made in
        [e*slice_s, (e+1)*slice_s), so its age at ``now`` is strictly below
        ``(E - e + 1) * slice_s``).  A ``>=`` here would keep slice
        E - slices too and report up to ``window_s + slice_s`` of history —
        letting an ended load spike skew percentiles past the window.  The
        boundary slice instead ages out *whole* (dropped up to one slice_s
        early), so the merged counts never over-include.
        """
        if now is None:
            now = time.perf_counter()
        epoch = int(now // self._slice_s)
        with self._lock:
            live = self._epoch > epoch - self.slices
            return self._counts[live].sum(axis=0)

    def count(self, now: Optional[float] = None) -> int:
        return int(self.merged(now).sum())

    def overflow(self, now: Optional[float] = None) -> int:
        """Live-window count of values beyond the last finite bucket edge
        (~12 s).  :meth:`percentile` reports *at* that edge for these —
        ">= last_edge" semantics — so a nonzero overflow count is the
        signal that a reported tail percentile is saturated, not exact."""
        return int(self.merged(now)[_N_BUCKETS])

    def percentile(self, q: float, now: Optional[float] = None) -> float:
        """Nearest-rank percentile (seconds) at a bucket upper edge; 0.0
        when the window is empty.  When the rank lands in the overflow
        bucket the last finite edge is returned with ">= edge" semantics —
        check :meth:`overflow` to detect that saturation (dashboards and
        the benchmark gates surface it as ``window_overflow``)."""
        counts = self.merged(now)
        total = int(counts.sum())
        if total == 0:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * total))
        b = int(np.searchsorted(np.cumsum(counts), rank))
        # Overflow bucket reports the last finite edge (conservative floor;
        # the overflow() count marks the value as ">= edge").
        return float(BUCKET_EDGES_S[min(b, _N_BUCKETS - 1)])


class _EndpointWindow:
    def __init__(self, slo_ms: Optional[float], window_s: float, slices: int):
        self.slo_ms = slo_ms
        self.hist = RollingHistogram(window_s, slices)
        self.n_requests = 0
        self.n_violations = 0  # lifetime count of requests over slo_ms


class SLOTracker:
    """Rolling latency windows + SLO-violation counters, keyed by endpoint.

    ``targets`` maps endpoint name -> p99 target in ms; endpoints not
    listed fall back to ``default_slo_ms`` (``None`` = track percentiles,
    count no violations).
    """

    def __init__(self, window_s: float = 60.0, slices: int = 12,
                 default_slo_ms: Optional[float] = None,
                 targets: Optional[Dict[str, float]] = None):
        self.window_s = window_s
        self.slices = slices
        self.default_slo_ms = default_slo_ms
        self.targets = dict(targets or {})
        self._lock = threading.Lock()
        self._windows: Dict[str, _EndpointWindow] = {}

    def _window(self, name: str) -> _EndpointWindow:
        with self._lock:
            w = self._windows.get(name)
            if w is None:
                w = _EndpointWindow(
                    self.targets.get(name, self.default_slo_ms),
                    self.window_s, self.slices)
                self._windows[name] = w
            return w

    def record(self, name: str, latency_s: float,
               now: Optional[float] = None) -> None:
        w = self._window(name)
        w.hist.record(latency_s, now)
        with self._lock:
            w.n_requests += 1
            if w.slo_ms is not None and latency_s * 1e3 > w.slo_ms:
                w.n_violations += 1

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Dict]:
        if now is None:
            now = time.perf_counter()
        with self._lock:
            windows = dict(self._windows)
        out = {}
        for name, w in windows.items():
            p99_ms = w.hist.percentile(99, now) * 1e3
            snap = {
                "window_s": self.window_s,
                "window_requests": w.hist.count(now),
                # Nonzero => some window percentiles are ">= last edge"
                # floors, not exact values (see RollingHistogram.overflow).
                "window_overflow": w.hist.overflow(now),
                "requests": w.n_requests,
                "p50_ms": w.hist.percentile(50, now) * 1e3,
                "p95_ms": w.hist.percentile(95, now) * 1e3,
                "p99_ms": p99_ms,
                "slo_ms": w.slo_ms,
                "violations": w.n_violations,
            }
            if w.slo_ms is not None:
                snap["violation_fraction"] = (
                    w.n_violations / w.n_requests if w.n_requests else 0.0)
                snap["p99_under_slo"] = p99_ms <= w.slo_ms
            out[name] = snap
        return out
