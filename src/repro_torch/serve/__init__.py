"""repro_torch.serve — inference serving over the port's compiled artifacts.

The counterpart of :mod:`repro.serve`.  Layers (bottom-up):

* :mod:`repro_torch.serve.batching` — :class:`BatchingPolicy` +
  :class:`MicroBatcher`: an async request queue drained into dynamic
  micro-batches (``max_batch`` rows / ``max_wait_ms`` delay), padded to
  power-of-two buckets, each bucket warmed up before the first real
  request, staged in pinned host memory for artifacts on a CUDA device.
* :mod:`repro_torch.serve.router` — :class:`ModelRouter`: several compiled
  artifacts behind name-keyed :class:`Endpoint`\\ s with per-artifact stats
  (QPS, p50/p95 latency, batch-fill ratio).
* :mod:`repro_torch.serve.cache` — :class:`ArtifactCache`: single-flight
  recompile dedupe keyed by ``(model fingerprint, Target, plan, device)``.
* :mod:`repro_torch.serve.degrade` — :class:`PrecisionGovernor`: the
  load-adaptive precision state machine (overload -> serve the ``auto8``
  fallback artifact instead of shedding load; hysteretic recovery).
* :mod:`repro_torch.serve.fleet` — :class:`FleetCoalescer`: cross-endpoint
  megabatching — compatible endpoints' in-flight micro-batches stacked
  along a model axis and served by ONE fleet kernel launch per round
  (``InferenceService.enable_fleet``; see :mod:`repro_torch.compile.fleet`).
* :mod:`repro_torch.serve.service` — :class:`InferenceService`: the facade.
* :mod:`repro_torch.serve.reliability` — fault-tolerance primitives:
  structured serve errors (:class:`DeadlineExceeded`,
  :class:`CircuitOpenError`, :class:`DispatchError`), bounded jittered
  retry (:class:`RetryPolicy`), and the per-endpoint
  :class:`CircuitBreaker`.
* :mod:`repro_torch.serve.faults` — deterministic fault injection
  (:class:`FaultPlan` / :class:`FaultInjector`), env-gated via
  ``REPRO_FAULTS``.
* :mod:`repro_torch.serve.net` — the asyncio HTTP front end
  (``InferenceService.serve_http``): admission control, SLO tracking and
  ``/v1/predict/<name>``, ``/v1/health``, ``/v1/stats``, ``/v1/endpoints``.
"""

from .batching import BatchingPolicy, MicroBatcher
from .cache import ArtifactCache
from .degrade import DegradationPolicy, PrecisionGovernor
from .faults import FaultInjector, FaultPlan, FaultRule, InjectedFault
from .fleet import FleetCoalescer
from .reliability import (BreakerPolicy, CircuitBreaker, CircuitOpenError,
                          DeadlineExceeded, DispatchError, RetryPolicy,
                          ServeError, TransientError)
from .router import Endpoint, EndpointStats, ModelRouter
from .service import InferenceService

__all__ = [
    "BatchingPolicy",
    "MicroBatcher",
    "ArtifactCache",
    "DegradationPolicy",
    "PrecisionGovernor",
    "Endpoint",
    "EndpointStats",
    "ModelRouter",
    "InferenceService",
    "FleetCoalescer",
    "ServeError",
    "TransientError",
    "DeadlineExceeded",
    "CircuitOpenError",
    "DispatchError",
    "RetryPolicy",
    "BreakerPolicy",
    "CircuitBreaker",
    "FaultRule",
    "FaultPlan",
    "FaultInjector",
    "InjectedFault",
]
