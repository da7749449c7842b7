"""Fault-tolerance primitives for the serving plane.

A copy of :mod:`repro.serve.reliability` for the PyTorch port (the module
imports neither JAX nor anything else of the reference package).

EmbML's deployments are unattended field sensors: nobody restarts the smart
trap when a dispatch throws.  This module makes failure a *structured*
output of the serving stack instead of an unhandled exception:

* **Structured errors** — every way a request can fail maps to a
  :class:`ServeError` subclass carrying an HTTP status and a stable machine
  code, so the scheduler, the router, and the HTTP front end all speak one
  failure vocabulary.  :class:`TransientError` is the retryability marker:
  anything deriving from it (injected faults, device loss) is fair game for
  the retry layer; everything else fails fast.
* **Deadlines** — a request may carry an absolute deadline (monotonic
  clock).  The scheduler resolves requests that expire *in queue* with
  :class:`DeadlineExceeded` (HTTP 504) without dispatching them: computing
  an answer nobody is waiting for only delays the requests behind it.
* **Bounded retry** — :class:`RetryPolicy`: exponential backoff with
  multiplicative jitter, capped per attempt and bounded in attempt count.
  Pure math over an injected RNG/clock, so the timing is unit-testable
  without sleeping.
* **Circuit breaking** — :class:`CircuitBreaker`: the classic
  closed/open/half-open machine per endpoint.  Trips on consecutive
  failures OR a rolling error rate; while open, submissions fail fast with
  :class:`CircuitOpenError` (503 + Retry-After) instead of queueing onto a
  known-bad dispatcher; half-open admits a bounded number of probe
  requests whose outcomes decide reopen vs close.  Deterministic under
  test: the clock is injectable and every transition is counter-surfaced
  in ``stats()``.

The scheduler-side consumers live in :mod:`repro_torch.serve.batching` (deadline
skipping, retry, poison-batch bisection) and :mod:`repro_torch.serve.router`
(breaker gating, composition with the :class:`PrecisionGovernor`).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

__all__ = [
    "ServeError", "DeadlineExceeded", "CircuitOpenError", "DispatchError",
    "TransientError", "RetryPolicy", "BreakerPolicy", "CircuitBreaker",
]


# ---------------------------------------------------------------------------
# structured errors
# ---------------------------------------------------------------------------
class TransientError(RuntimeError):
    """Marker base for failures worth retrying (the fault is expected to
    clear on its own: a flaky dispatch, a replica dropping off the mesh).
    The retry layer only ever retries exceptions deriving from this."""


class ServeError(RuntimeError):
    """A request failure with a stable machine ``code`` and HTTP ``status``.

    The scheduler resolves futures with these; the HTTP front end maps them
    to typed responses (``{"error": ..., "code": ...}``) instead of a
    generic 500.
    """

    status: int = 500
    code: str = "internal"

    def __init__(self, detail: str, retry_after_s: Optional[float] = None):
        super().__init__(detail)
        self.detail = detail
        self.retry_after_s = retry_after_s


class DeadlineExceeded(ServeError):
    """The request's deadline passed before it could be served (usually:
    expired while queued — the scheduler never dispatched it)."""

    status = 504
    code = "deadline_exceeded"


class CircuitOpenError(ServeError):
    """The endpoint's circuit breaker is open: recent dispatches failed and
    the breaker is failing fast instead of queueing onto a broken path."""

    status = 503
    code = "circuit_open"


class DispatchError(ServeError):
    """Dispatch failed for this request after retries (and, in a batch,
    after bisection isolated it from its batchmates).

    ``isolated`` is True when poison-batch bisection narrowed a failing
    multi-request batch down to this request — its batchmates were served
    normally.  ``cause`` keeps the original exception.
    """

    status = 500
    code = "dispatch_failed"

    def __init__(self, detail: str, cause: Optional[BaseException] = None,
                 isolated: bool = False):
        super().__init__(detail)
        self.cause = cause
        self.isolated = isolated


# ---------------------------------------------------------------------------
# bounded retry with exponential backoff + jitter
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry knobs for transient dispatch failures.

    Attempt ``a`` (0-based) that fails and is retried sleeps

        ``min(backoff_max_s, backoff_base_s * multiplier**a) * U``

    with ``U`` uniform in ``[1 - jitter, 1 + jitter]`` — bounded above by
    ``backoff_max_s * (1 + jitter)`` no matter the attempt count, and
    jittered so retry storms from many clients decorrelate.
    """

    max_attempts: int = 3
    backoff_base_s: float = 0.01
    multiplier: float = 2.0
    backoff_max_s: float = 0.5
    jitter: float = 0.25

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff bounds must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")

    def retryable(self, exc: BaseException) -> bool:
        """Only transient-marked failures are retried; a deterministic
        failure (bad rows, a poisoned request) would fail identically on
        every attempt and must go straight to isolation."""
        return isinstance(exc, (TransientError, ConnectionError,
                                TimeoutError))

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Sleep before retry number ``attempt + 1`` (``attempt`` 0-based)."""
        cap = min(self.backoff_max_s,
                  self.backoff_base_s * self.multiplier ** max(0, attempt))
        return cap * (1.0 - self.jitter + 2.0 * self.jitter * rng.random())


# ---------------------------------------------------------------------------
# per-endpoint circuit breaker
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    """Trip/recovery knobs for one endpoint's circuit breaker.

    * ``consecutive_failures`` — trip after this many dispatch failures in
      a row (fast trigger for hard-down endpoints).
    * ``error_rate`` / ``window`` / ``min_samples`` — trip when the failure
      fraction over the last ``window`` dispatch outcomes reaches
      ``error_rate`` (with at least ``min_samples`` observed) — the slow
      trigger for flapping endpoints that never fail N times in a row.
    * ``open_s`` — how long the breaker stays open before admitting probes.
    * ``half_open_probes`` — concurrent in-flight probes while half-open.
    * ``close_after`` — consecutive probe successes required to close.
    """

    consecutive_failures: int = 5
    error_rate: float = 0.5
    window: int = 32
    min_samples: int = 8
    open_s: float = 5.0
    half_open_probes: int = 1
    close_after: int = 2

    def __post_init__(self):
        if self.consecutive_failures < 1:
            raise ValueError("consecutive_failures must be >= 1")
        if not 0.0 < self.error_rate <= 1.0:
            raise ValueError("error_rate must be in (0, 1]")
        if self.window < 1 or self.min_samples < 1:
            raise ValueError("window and min_samples must be >= 1")
        if self.min_samples > self.window:
            raise ValueError("min_samples must be <= window")
        if self.open_s < 0:
            raise ValueError("open_s must be >= 0")
        if self.half_open_probes < 1 or self.close_after < 1:
            raise ValueError("half_open_probes and close_after must be >= 1")


class CircuitBreaker:
    """Closed / open / half-open breaker over dispatch outcomes.

    ``allow()`` gates request admission (the router calls it in
    ``submit``); ``record_success``/``record_failure`` are fed dispatch
    outcomes by the scheduler.  Thread-safe; the clock is injectable so the
    open->half-open timing is unit-testable.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, policy: Optional[BreakerPolicy] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.policy = policy or BreakerPolicy()
        self._clock = clock or time.perf_counter
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._consecutive = 0
        self._outcomes: deque = deque(maxlen=self.policy.window)  # bools: ok
        self._probes_inflight = 0
        self._probe_successes = 0
        self.trips = 0
        self.rejected = 0
        self.probes = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    # -- admission gate -------------------------------------------------------
    def allow(self, now: Optional[float] = None) -> bool:
        if now is None:
            now = self._clock()
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if now - self._opened_at < self.policy.open_s:
                    self.rejected += 1
                    return False
                # cool-down elapsed: admit probes
                self._state = self.HALF_OPEN
                self._probes_inflight = 0
                self._probe_successes = 0
            # half-open: a bounded number of probes may be in flight
            if self._probes_inflight < self.policy.half_open_probes:
                self._probes_inflight += 1
                self.probes += 1
                return True
            self.rejected += 1
            return False

    def retry_after_s(self, now: Optional[float] = None) -> float:
        """Seconds until the breaker will next admit a request (0 when it
        already would) — the Retry-After value for circuit-open refusals."""
        if now is None:
            now = self._clock()
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(0.0, self.policy.open_s - (now - self._opened_at))

    # -- outcome feed ---------------------------------------------------------
    def record_success(self, now: Optional[float] = None) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state == self.HALF_OPEN:
                self._probes_inflight = max(0, self._probes_inflight - 1)
                self._probe_successes += 1
                if self._probe_successes >= self.policy.close_after:
                    self._state = self.CLOSED
                    self._outcomes.clear()
                return
            if self._state == self.CLOSED:
                self._outcomes.append(True)
            # OPEN: a straggler batch finishing after the trip — ignore.

    def record_failure(self, now: Optional[float] = None) -> None:
        if now is None:
            now = self._clock()
        with self._lock:
            if self._state == self.HALF_OPEN:
                # A failed probe re-opens immediately; the cool-down restarts.
                self._state = self.OPEN
                self._opened_at = now
                self._probes_inflight = max(0, self._probes_inflight - 1)
                self.trips += 1
                return
            if self._state == self.OPEN:
                return
            self._consecutive += 1
            self._outcomes.append(False)
            n = len(self._outcomes)
            failures = n - sum(self._outcomes)
            trip = self._consecutive >= self.policy.consecutive_failures or (
                n >= self.policy.min_samples
                and failures / n >= self.policy.error_rate)
            if trip:
                self._state = self.OPEN
                self._opened_at = now
                self.trips += 1

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            n = len(self._outcomes)
            failures = n - sum(self._outcomes)
            return {
                "state": self._state,
                "trips": self.trips,
                "rejected": self.rejected,
                "probes": self.probes,
                "consecutive_failures": self._consecutive,
                "window_samples": n,
                "window_error_rate": (failures / n) if n else 0.0,
            }
