"""Multi-artifact router: name-keyed endpoints over compiled artifacts.

The counterpart of :mod:`repro.serve.router` for the PyTorch port.  Each
registered :class:`~repro_torch.compile.artifact.CompiledArtifact` gets an
*endpoint*: its own micro-batching scheduler (classifier artifacts) and a
rolling stats window — QPS, p50/p95/p99 request latency, mean batch-fill
ratio (rows per dispatched bucket).  The scheduler stages batches in pinned
host memory when the artifact runs on a CUDA device.  LM artifacts
(``kind == 'lm'``) are hosted without a scheduler, as the reference hosts
them: their :meth:`Endpoint.generate` calls are routed and accounted
through the same stats, and ``submit``/``predict``/``set_fallback`` raise
``TypeError``.

An endpoint may additionally carry a *fallback* artifact of the same model
at a narrower precision (``set_fallback``): a
:class:`~repro_torch.serve.degrade.PrecisionGovernor` watches queue depth and
rolling p99 at every dispatch and, past its watermarks, routes batches to
the fallback — load-adaptive precision, shedding bits before shedding
requests.  Recovery is hysteretic (separate low watermarks + a minimum
dwell time), so the precision does not flap under oscillating load.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np

from repro_torch.compile.artifact import CompiledArtifact

from . import faults
from .batching import BatchingPolicy, MicroBatcher
from .degrade import DegradationPolicy, PrecisionGovernor
from .reliability import (BreakerPolicy, CircuitBreaker, CircuitOpenError,
                          RetryPolicy)

__all__ = ["EndpointStats", "Endpoint", "ModelRouter"]

_LATENCY_WINDOW = 4096  # most recent request latencies kept for percentiles


def _percentiles(lat: np.ndarray, qs=(50, 95, 99)):
    """Latency percentiles that stay honest on small windows.

    Interpolating percentiles over one or two samples manufactures values
    no request ever experienced; below 3 samples we switch to nearest-rank
    (the q-th value IS an observed latency, and the tail percentiles report
    the window max rather than something interpolated away from it).
    """
    if lat.size == 0:
        return [0.0] * len(qs)
    if lat.size < 3:
        s = np.sort(lat)
        return [float(s[min(lat.size - 1,
                            max(0, math.ceil(q / 100.0 * lat.size) - 1))])
                for q in qs]
    return [float(np.percentile(lat, q)) for q in qs]


class EndpointStats:
    """Thread-safe serving statistics for one endpoint: lifetime counters
    (requests/rows/batches, QPS averaged since registration) plus a rolling
    window of recent request latencies for the percentiles."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.n_requests = 0
        self.n_rows = 0
        self.n_batches = 0
        self.n_degraded_batches = 0
        self.n_degraded_rows = 0
        self.n_coalesced_batches = 0
        self.n_coalesced_rows = 0
        self._bucket_rows = 0  # sum of dispatched bucket sizes
        self._latencies = deque(maxlen=_LATENCY_WINDOW)

    def record_batch(self, n_requests, n_rows, bucket, latencies,
                     meta=None) -> None:
        with self._lock:
            self.n_requests += n_requests
            self.n_rows += n_rows
            self.n_batches += 1
            self._bucket_rows += bucket
            self._latencies.extend(latencies)
            if meta is not None and meta.get("degraded"):
                self.n_degraded_batches += 1
                self.n_degraded_rows += n_rows
            if meta is not None and meta.get("coalesced"):
                self.n_coalesced_batches += 1
                self.n_coalesced_rows += n_rows

    def rolling_p99_ms(self) -> Optional[float]:
        """p99 (ms) over the rolling latency window — the degradation
        governor's latency signal.  ``None`` while the window is empty:
        an empty window means "no completions observed", NOT "zero
        latency" — reporting 0.0 here let a fully-queued endpoint (every
        request waiting, none finishing) satisfy ``p99 <= p99_low_ms``
        and flap back to full precision at peak overload."""
        with self._lock:
            if not self._latencies:
                return None
            lat = np.asarray(self._latencies, np.float64)
        return _percentiles(lat, (99,))[0] * 1e3

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            elapsed = max(time.perf_counter() - self._t0, 1e-9)
            lat = np.asarray(self._latencies, np.float64)
            # Percentiles over the rolling window; nearest-rank below 3
            # samples (see _percentiles).  Batch fill is only defined once a
            # bucket has actually been dispatched: an idle endpoint reports
            # fill 1.0 (no padding has been wasted), not a spurious 0% that
            # trips dashboards.
            p50, p95, p99 = [v * 1e3 for v in _percentiles(lat)]
            return {
                "requests": self.n_requests,
                "rows": self.n_rows,
                "batches": self.n_batches,
                "qps": self.n_requests / elapsed,
                "rows_per_s": self.n_rows / elapsed,
                "p50_ms": p50,
                "p95_ms": p95,
                "p99_ms": p99,
                "batch_fill": (self.n_rows / self._bucket_rows
                               if self._bucket_rows else 1.0),
                "mean_batch_rows": (self.n_rows / self.n_batches
                                    if self.n_batches else 0.0),
                "degraded_batches": self.n_degraded_batches,
                "degraded_rows": self.n_degraded_rows,
                "coalesced_batches": self.n_coalesced_batches,
                "coalesced_rows": self.n_coalesced_rows,
                "degraded_fraction": (self.n_degraded_rows / self.n_rows
                                      if self.n_rows else 0.0),
            }


class Endpoint:
    """One hosted artifact: scheduler + stats behind a name.

    With :meth:`set_fallback` the endpoint also holds a degraded-precision
    artifact of the same model; every dispatched batch consults the
    precision governor and is served by whichever artifact the current
    load state selects.
    """

    def __init__(self, name: str, artifact: CompiledArtifact,
                 policy: Optional[BatchingPolicy] = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.name = name
        self.artifact = artifact
        self.stats = EndpointStats()
        self.fallback: Optional[CompiledArtifact] = None
        self.governor: Optional[PrecisionGovernor] = None
        self.breaker = breaker
        # Never build buckets the artifact would reject (fixed batch policy),
        # and make the bucket ladder replica-aware for mesh-specialized
        # artifacts (each bucket = replicas x a pow2 per-device shard; the
        # top bucket only rounds up to alignment when the artifact has no
        # hard ceiling to respect).
        self.policy = (policy or BatchingPolicy()).clamped(
            artifact.max_supported_batch).with_replicas(
            getattr(artifact, "replicas", 1),
            align_top=artifact.max_supported_batch is None)
        self.batcher: Optional[MicroBatcher] = None
        if artifact.kind != "lm":
            self.batcher = MicroBatcher(
                self._dispatch, self.policy, on_batch=self.stats.record_batch,
                name=name, retry=retry, on_dispatch=self._on_dispatch,
                device=getattr(artifact, "device", None))

    # -- load-adaptive precision ---------------------------------------------
    def set_fallback(self, artifact: CompiledArtifact,
                     policy: Optional[DegradationPolicy] = None) -> None:
        """Arm load-adaptive precision: under overload (per ``policy``'s
        watermarks) dispatched batches are served by ``artifact`` instead of
        the primary.  The fallback must host the same model shape: same
        lowering kind, and no batch ceiling below the scheduler's buckets.
        """
        if self.batcher is None:
            raise TypeError(f"endpoint '{self.name}' hosts an LM artifact; "
                            f"precision fallback applies to classifiers")
        if artifact.kind != self.artifact.kind:
            raise ValueError(
                f"fallback kind '{artifact.kind}' does not match primary "
                f"'{self.artifact.kind}'")
        ceiling = artifact.max_supported_batch
        if ceiling is not None and ceiling < self.policy.max_batch:
            raise ValueError(
                f"fallback max batch {ceiling} is below the scheduler's "
                f"max_batch {self.policy.max_batch}")
        self.fallback = artifact
        self.governor = PrecisionGovernor(policy)

    def set_breaker(self, policy: Optional[BreakerPolicy] = None) -> None:
        """Arm (or replace) the endpoint's circuit breaker."""
        self.breaker = CircuitBreaker(policy)

    @property
    def degraded(self) -> bool:
        return self.governor is not None and self.governor.degraded

    def _on_dispatch(self, ok: bool, exc) -> None:
        """Dispatch-outcome feed from the scheduler (one call per attempt,
        including retries and bisection sub-dispatches)."""
        if self.breaker is None:
            return
        if ok:
            self.breaker.record_success()
        else:
            self.breaker.record_failure()

    def _dispatch(self, x: np.ndarray):
        """The batcher's predict: resolve which artifact serves this batch.

        Returns ``(rows, meta)`` once a fallback is armed — the batcher
        forwards ``meta`` to the stats sink and stamps it on every future of
        the batch, so callers (the HTTP front end) can report whether their
        prediction came from the degraded artifact.
        """
        faults.fire("endpoint.dispatch", name=self.name, batch=x)
        if self.governor is None:
            return self.artifact.predict(x)
        # A tripped breaker is an overload vote: serve probes (and the
        # post-trip backlog) on the cheap artifact until health returns.
        hint = (self.breaker is not None
                and self.breaker.state != CircuitBreaker.CLOSED)
        degraded = self.governor.observe(
            self.batcher.depth() if self.batcher is not None else 0,
            self.stats.rolling_p99_ms(), overload_hint=hint)
        art = self.fallback if degraded else self.artifact
        return art.predict(x), {"degraded": degraded,
                                "number_format": art.target.number_format}

    def fleet_route(self) -> bool:
        """Whether this member's next micro-batch may ride the fleet's
        stacked dispatch (True) or must serve on its own path (False).

        The stacked program runs every member at *primary* precision with
        no per-member dispatch, so anything that needs the member's own
        dispatch semantics opts out of the round: a non-closed circuit
        breaker (its probes must feed its own outcome counters) and an
        overloaded endpoint whose governor selects the degraded artifact.
        The governor observation here replaces the one its solo dispatch
        would have made — coalesced serving keeps the same load signals.
        """
        if (self.breaker is not None
                and self.breaker.state != CircuitBreaker.CLOSED):
            return False
        if self.governor is None:
            return True
        return not self.governor.observe(
            self.batcher.depth() if self.batcher is not None else 0,
            self.stats.rolling_p99_ms(), overload_hint=False)

    # -- classifier surface --------------------------------------------------
    def submit(self, x: np.ndarray,
               timeout_s: Optional[float] = None) -> Future:
        if self.breaker is not None and not self.breaker.allow():
            raise CircuitOpenError(
                f"endpoint '{self.name}' circuit is open",
                retry_after_s=self.breaker.retry_after_s())
        if self.batcher is None:
            raise TypeError(f"endpoint '{self.name}' hosts an LM artifact; "
                            f"use generate()")
        return self.batcher.submit(x, timeout_s=timeout_s)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Sync convenience: rows larger than one micro-batch are split
        across submissions (pipelined through the scheduler) and re-joined."""
        x = np.asarray(x)
        if x.ndim >= 2 and x.shape[0] > self.policy.max_batch:
            futs = [self.submit(x[i:i + self.policy.max_batch])
                    for i in range(0, x.shape[0], self.policy.max_batch)]
            return np.concatenate([f.result() for f in futs], axis=0)
        return self.submit(x).result()

    # -- lm surface ----------------------------------------------------------
    def generate(self, tokens: np.ndarray, n_tokens: int, **kw) -> np.ndarray:
        """Greedy generation through the artifact's ``generate``; recorded
        as one batch of ``B * n_tokens`` tokens."""
        if "generate" not in self.artifact.extras:
            raise TypeError(f"endpoint '{self.name}' ({self.artifact.kind}) "
                            f"has no generate entry point")
        t0 = time.perf_counter()
        seqs = self.artifact.extras["generate"](tokens, n_tokens, **kw)
        dt = time.perf_counter() - t0
        n = int(np.asarray(tokens).shape[0])
        self.stats.record_batch(1, n * n_tokens, n * n_tokens, [dt])
        return seqs

    def snapshot(self) -> Dict[str, object]:
        """Full stats surface: serving stats + reliability counters +
        breaker/governor/replica-health state (what ``/v1/stats`` shows)."""
        snap: Dict[str, object] = self.stats.snapshot()
        if self.batcher is not None:
            # Flat scalars (every plain-stats consumer keeps iterating
            # numbers); breaker/governor/replica state stay nested because
            # they only appear when armed.
            snap["expired_requests"] = self.batcher.n_expired
            snap["dispatch_retries"] = self.batcher.n_retries
            snap["dispatch_failures"] = self.batcher.n_dispatch_failures
            snap["failed_requests"] = self.batcher.n_failed_requests
            snap.update(self.batcher.assembly_stats())
        if self.breaker is not None:
            snap["breaker"] = self.breaker.snapshot()
        if self.governor is not None:
            snap["governor"] = self.governor.snapshot()
        health = getattr(self.artifact, "replica_health", None)
        if health is not None:
            snap["replica_health"] = health.snapshot()
        return snap

    def close(self, timeout: Optional[float] = None) -> None:
        if self.batcher is not None:
            self.batcher.close(timeout=timeout)


class ModelRouter:
    """Hosts several compiled artifacts behind name-keyed endpoints."""

    def __init__(self):
        self._endpoints: Dict[str, Endpoint] = {}
        self._lock = threading.Lock()

    def register(self, name: str, artifact: CompiledArtifact,
                 policy: Optional[BatchingPolicy] = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None) -> Endpoint:
        with self._lock:
            if name in self._endpoints:
                raise KeyError(f"endpoint '{name}' already registered")
            ep = Endpoint(name, artifact, policy, retry=retry,
                          breaker=breaker)
            self._endpoints[name] = ep
            return ep

    def unregister(self, name: str) -> None:
        with self._lock:
            ep = self._endpoints.pop(name)
        ep.close()

    def __getitem__(self, name: str) -> Endpoint:
        try:
            return self._endpoints[name]
        except KeyError:
            raise KeyError(f"no endpoint '{name}'; "
                           f"registered: {sorted(self._endpoints)}")

    def __contains__(self, name: str) -> bool:
        return name in self._endpoints

    def names(self):
        with self._lock:
            return sorted(self._endpoints)

    def submit(self, name: str, x: np.ndarray,
               timeout_s: Optional[float] = None) -> Future:
        return self[name].submit(x, timeout_s=timeout_s)

    def predict(self, name: str, x: np.ndarray) -> np.ndarray:
        return self[name].predict(x)

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            eps = sorted(self._endpoints.items())
        return {name: ep.snapshot() for name, ep in eps}

    def close(self, timeout: Optional[float] = None) -> None:
        """Close every endpoint; ``timeout`` bounds the *total* drain time
        (each endpoint gets whatever remains of the shared deadline)."""
        with self._lock:
            eps = list(self._endpoints.values())
            self._endpoints.clear()
        deadline = None if timeout is None else time.perf_counter() + timeout
        for ep in eps:
            ep.close(None if deadline is None
                     else max(0.0, deadline - time.perf_counter()))
