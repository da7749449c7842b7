"""Load-adaptive precision: the degradation state machine.

A copy of :mod:`repro.serve.degrade` for the PyTorch port.

EmbML trades bits for memory at compile time; under overload a serving
plane can make the same trade at *run* time — shed precision before
shedding load.  An endpoint hosting a calibrated ``auto16`` artifact keeps
the ``auto8`` artifact of the same model warm (both coexist in the
:class:`~repro_torch.serve.cache.ArtifactCache`, keyed by plan descriptor) and
the :class:`PrecisionGovernor` decides, batch by batch, which one serves.

The governor is a two-state hysteresis machine driven by *observations*
(queue depth and rolling p99 latency), not wall-clock callbacks, so it is
deterministic under test: callers pass ``now`` explicitly.

* **engage** when queue depth reaches ``queue_high`` OR rolling p99
  reaches ``p99_high_ms`` — the scheduler is falling behind;
* **recover** only when depth has fallen to ``queue_low`` AND p99 (if
  watched) to ``p99_low_ms`` — separate watermarks so the state does not
  chatter around a single threshold;
* either transition must additionally be ``min_hold_s`` after the previous
  one — bounded flap rate even under adversarial load oscillation.

Transport-independent on purpose: :class:`repro_torch.serve.router.Endpoint`
consults the governor inside its dispatch path, so every caller shares one
policy.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional

__all__ = ["DegradationPolicy", "PrecisionGovernor"]


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """Watermarks + hysteresis for one endpoint's precision governor.

    * ``queue_high`` / ``queue_low`` — scheduler queue depth (requests) at
      which to engage / below which to recover.
    * ``p99_high_ms`` / ``p99_low_ms`` — optional rolling-p99 watermarks;
      ``None`` disables the latency trigger.  ``p99_low_ms`` defaults to
      half of ``p99_high_ms``.
    * ``min_hold_s`` — minimum dwell time in a state before the next
      transition (both directions), bounding the flap rate.
    """

    queue_high: int = 64
    queue_low: int = 4
    p99_high_ms: Optional[float] = None
    p99_low_ms: Optional[float] = None
    min_hold_s: float = 2.0

    def __post_init__(self):
        if self.queue_high < 1:
            raise ValueError("queue_high must be >= 1")
        if not 0 <= self.queue_low <= self.queue_high:
            raise ValueError("queue_low must be in [0, queue_high]")
        if self.p99_high_ms is not None:
            if self.p99_high_ms <= 0:
                raise ValueError("p99_high_ms must be > 0")
            if self.p99_low_ms is None:
                object.__setattr__(self, "p99_low_ms", self.p99_high_ms / 2)
            elif not 0 < self.p99_low_ms <= self.p99_high_ms:
                raise ValueError("p99_low_ms must be in (0, p99_high_ms]")
        elif self.p99_low_ms is not None:
            raise ValueError("p99_low_ms requires p99_high_ms")
        if self.min_hold_s < 0:
            raise ValueError("min_hold_s must be >= 0")


class PrecisionGovernor:
    """Hysteresis state machine deciding full-precision vs degraded serving.

    Thread-safe; ``observe`` is called from the scheduler's dispatch thread,
    ``degraded``/``snapshot`` from anywhere (the stats surface).
    """

    def __init__(self, policy: Optional[DegradationPolicy] = None):
        self.policy = policy or DegradationPolicy()
        self._lock = threading.Lock()
        self._degraded = False
        # Last transition time; -inf so the first engage is never held back.
        self._since = float("-inf")
        self.observations = 0
        self.engagements = 0
        self.recoveries = 0

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def observe(self, queue_depth: int, p99_ms: Optional[float],
                now: Optional[float] = None,
                overload_hint: bool = False) -> bool:
        """Feed one load observation; returns the (possibly new) state.

        ``p99_ms=None`` means the latency signal is *unknown* (the rolling
        window holds no completed requests — e.g. everything is queued, or
        the endpoint just started).  Unknown never engages the latency
        trigger, and — when the trigger is armed — never satisfies
        recovery either: an endpoint at peak overload whose requests are
        all waiting must not flap back to full precision just because
        nothing has completed to prove the latency is still bad.

        ``overload_hint`` lets other health machinery vote "this endpoint
        is struggling" (the circuit breaker passes True while open or
        half-open): a hint engages degradation like a watermark breach and
        blocks recovery while asserted, so probes after a trip run on the
        cheap artifact first.
        """
        if now is None:
            now = time.perf_counter()
        p = self.policy
        overloaded = overload_hint or queue_depth >= p.queue_high or (
            p.p99_high_ms is not None and p99_ms is not None
            and p99_ms >= p.p99_high_ms)
        recovered = not overload_hint and queue_depth <= p.queue_low and (
            p.p99_high_ms is None
            or (p99_ms is not None and p99_ms <= p.p99_low_ms))
        with self._lock:
            self.observations += 1
            may_switch = now - self._since >= p.min_hold_s
            if not self._degraded and overloaded and may_switch:
                self._degraded, self._since = True, now
                self.engagements += 1
            elif self._degraded and recovered and may_switch:
                self._degraded, self._since = False, now
                self.recoveries += 1
            return self._degraded

    def force(self, degraded: bool, now: Optional[float] = None) -> None:
        """Pin the state (operator override / tests); hysteresis restarts."""
        with self._lock:
            if degraded and not self._degraded:
                self.engagements += 1
            elif not degraded and self._degraded:
                self.recoveries += 1
            self._degraded = degraded
            self._since = time.perf_counter() if now is None else now

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                "degraded": self._degraded,
                "observations": self.observations,
                "engagements": self.engagements,
                "recoveries": self.recoveries,
            }
