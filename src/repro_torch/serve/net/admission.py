"""Admission control: bound the queue instead of growing it unboundedly.

A copy of :mod:`repro.serve.net.admission` for the PyTorch port.

Two independent gates, checked in order at the service boundary (before a
request ever reaches the micro-batching scheduler):

* **token bucket** — a sustained requests/s limit with a burst allowance.
  Refusals are 429s with a ``Retry-After`` telling the client exactly when
  the bucket will hold a token again (open-loop clients that honor it
  converge on the configured rate instead of hammering).
* **queue-depth watermark** — when the endpoint's scheduler queue reaches
  ``queue_high`` the endpoint is saturated; admitting more requests only
  buys them a longer wait, so they are refused with 503 + ``Retry-After``
  estimated from the queue's observed drain rate.

Deterministic on purpose: no probabilistic shedding, and every method takes
an explicit ``now`` so the watermark/bucket math is unit-testable without
sleeping.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional

__all__ = ["AdmissionPolicy", "Admission", "AdmissionController"]


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Admission knobs for one endpoint.

    * ``rate_limit`` — sustained requests/s (``None`` = unlimited).
    * ``burst`` — token-bucket capacity: how many requests above the
      sustained rate may arrive back-to-back before 429s start.
    * ``queue_high`` — scheduler queue depth at which new requests are
      refused with 503 (``None`` = unbounded queue).
    * ``retry_after_floor_s`` — minimum Retry-After ever advertised, so
      refused clients back off a measurable amount.
    """

    rate_limit: Optional[float] = None
    burst: int = 32
    queue_high: Optional[int] = 256
    retry_after_floor_s: float = 0.05

    def __post_init__(self):
        if self.rate_limit is not None and self.rate_limit <= 0:
            raise ValueError("rate_limit must be > 0 (or None)")
        if self.burst < 1:
            raise ValueError("burst must be >= 1")
        if self.queue_high is not None and self.queue_high < 1:
            raise ValueError("queue_high must be >= 1 (or None)")


@dataclasses.dataclass(frozen=True)
class Admission:
    """One admission decision."""

    ok: bool
    status: int = 200          # 429 (rate) or 503 (queue) when refused
    retry_after_s: float = 0.0
    reason: str = ""


class AdmissionController:
    """Token bucket + queue watermark for one endpoint.  Thread-safe."""

    def __init__(self, policy: Optional[AdmissionPolicy] = None,
                 now: Optional[float] = None):
        self.policy = policy or AdmissionPolicy()
        self._lock = threading.Lock()
        self._tokens = float(self.policy.burst)
        self._refill_t = time.perf_counter() if now is None else now
        # Exponentially-smoothed drain rate (rows the scheduler retires per
        # second) backing the 503 Retry-After estimate.
        self._drain_rate: Optional[float] = None
        self.admitted = 0
        self.rejected_rate = 0
        self.rejected_queue = 0

    def record_drain(self, requests: int, elapsed_s: float) -> None:
        """Feed scheduler progress (a served batch) into the drain-rate
        estimate used for 503 Retry-After."""
        if elapsed_s <= 0 or requests <= 0:
            return
        rate = requests / elapsed_s
        with self._lock:
            self._drain_rate = (rate if self._drain_rate is None
                                else 0.8 * self._drain_rate + 0.2 * rate)

    def admit(self, queue_depth: int = 0,
              now: Optional[float] = None) -> Admission:
        if now is None:
            now = time.perf_counter()
        p = self.policy
        with self._lock:
            if p.rate_limit is not None:
                self._tokens = min(
                    float(p.burst),
                    self._tokens + (now - self._refill_t) * p.rate_limit)
                self._refill_t = now
                if self._tokens < 1.0:
                    self.rejected_rate += 1
                    wait = (1.0 - self._tokens) / p.rate_limit
                    return Admission(False, 429,
                                     max(wait, p.retry_after_floor_s),
                                     "rate limit")
            if p.queue_high is not None and queue_depth >= p.queue_high:
                self.rejected_queue += 1
                drain = self._drain_rate or p.rate_limit or 1.0
                wait = max(queue_depth / max(drain, 1e-9) / 2,
                           p.retry_after_floor_s)
                return Admission(False, 503, min(wait, 30.0), "queue full")
            if p.rate_limit is not None:
                self._tokens -= 1.0
            self.admitted += 1
            return Admission(True)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "admitted": self.admitted,
                "rejected_rate": self.rejected_rate,
                "rejected_queue": self.rejected_queue,
                "tokens": round(self._tokens, 3),
                "drain_rate": self._drain_rate or 0.0,
            }
