"""The user-facing serving facade: cache + router + schedulers in one object.

The counterpart of :mod:`repro.serve.service` for the PyTorch port:

    from repro_torch.serve import BatchingPolicy, InferenceService

    svc = InferenceService()                # on the current CUDA device
    svc.register("digits", model, Target(number_format="fxp16", backend="cuda"),
                 policy=BatchingPolicy(max_batch=64, max_wait_ms=2.0))

    fut = svc.submit("digits", row)        # async: concurrent.futures.Future
    preds = svc.predict("digits", rows)    # sync convenience
    svc.stats()                            # per-endpoint QPS / p50/p95/p99
    svc.close()                            # (timeout= bounds the drain)

Registration compiles through the :class:`~repro_torch.serve.cache.ArtifactCache`,
so registering the same parameters for the same Target twice (two endpoint
names, a restart loop, an A/B alias) reuses the compiled artifact.

``InferenceService(device="cpu")`` serves on the host through the kernels'
plain versions (the tests do); without a CUDA device and without that
argument, construction raises.  ``svc.enable_fleet()`` coalesces compatible
endpoints into stacked fleet launches, and ``svc.enable_degradation(name,
...)`` arms an endpoint with a narrower-precision fallback artifact
(compiled through the same cache, so ``auto16`` and ``auto8`` of one model
coexist as two cache entries) that serves under overload — see
:mod:`repro_torch.serve.degrade`.  An :class:`~repro_torch.compile.LMModel`
registers like any model; ``svc.generate(name, tokens, n)`` decodes on it.
``svc.serve_http(...)`` builds the HTTP front end (:mod:`repro_torch.serve.net`)
over the service.  Mesh-sharded endpoints arrive with a later slice of the
port.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.compile import CompiledArtifact, Target, resolve_device

from . import faults
from .batching import BatchingPolicy
from .cache import MULTI_GPU_SLICE, ArtifactCache
from .degrade import DegradationPolicy
from .reliability import BreakerPolicy, CircuitBreaker, RetryPolicy
from .router import Endpoint, ModelRouter

__all__ = ["InferenceService"]


def _example_row(artifact: CompiledArtifact,
                 calibration: Any = None) -> Optional[np.ndarray]:
    """One zero input row shaped for ``artifact`` (for pretune warmup):
    from the calibration batch when given, else from the quantized tensors
    in the emit spec.  None when the input shape is not recoverable."""
    if calibration is not None:
        return np.zeros_like(np.asarray(calibration, np.float32)[0])
    spec = artifact.extras.get("emit_spec") or {}
    fam = spec.get("family")
    if fam == "mlp":
        return np.zeros(spec["ws"][0].shape[0], np.float32)
    if fam == "linear":
        return np.zeros(spec["w"].shape[0], np.float32)
    if fam == "svm":
        return np.zeros(spec["sv"].shape[1], np.float32)
    return None


class InferenceService:
    """``device`` is where models registered by value are compiled: the
    current CUDA device by default, ``"cpu"`` only when asked for."""

    def __init__(self, cache: Optional[ArtifactCache] = None,
                 device: Any = None):
        self.device = resolve_device(device)
        self.cache = cache or ArtifactCache()
        self.router = ModelRouter()
        # Active fleet coalescers, keyed by their member-name tuple.
        self._fleets: Dict[tuple, Any] = {}

    # -- lifecycle -----------------------------------------------------------
    def register(self, name: str, model: Any = None,
                 target: Optional[Target] = None,
                 artifact: Optional[CompiledArtifact] = None,
                 policy: Optional[BatchingPolicy] = None,
                 mesh: Any = None, mesh_strategy: str = "auto",
                 calibration: Any = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 pretune: Any = False) -> Endpoint:
        """Host ``model`` compiled for ``target`` (deduped through the
        artifact cache), or a pre-compiled ``artifact``, under ``name``.

        ``pretune`` runs the artifact over the endpoint's *actual* bucket
        ladder at registration (see :meth:`CompiledArtifact.pretune`), so
        the first live request in every bucket finds its kernels built.
        Pass ``True`` to derive the example row from ``calibration`` or
        the artifact's quantized tensors, or pass an example row/batch
        directly (required for artifacts whose input shape is not
        recoverable, e.g. trees registered without calibration).

        ``mesh`` (data-parallel sharding over several cards) raises
        ``NotImplementedError`` until the port's multi-GPU slice.

        ``calibration`` (a sample input batch) is required when ``target``
        uses a calibrated number format (``auto16``/``auto8``/``auto32``):
        the compile pipeline derives the per-tensor QuantPlan from it, and
        the cache keys on the resulting plan.

        ``retry`` arms bounded transient-failure retry in the endpoint's
        scheduler; ``breaker`` attaches a circuit breaker (or use
        :meth:`enable_breaker` after registration).
        """
        if (artifact is None) == (model is None):
            raise TypeError("pass either model (+ target) or artifact")
        if mesh is not None:
            raise NotImplementedError(MULTI_GPU_SLICE)
        if artifact is None:
            art = self.cache.get_or_compile(model, target or Target(),
                                            calibration=calibration,
                                            device=self.device)
        else:
            art = self.cache.put(artifact) if artifact.fingerprint else artifact
        ep = self.router.register(name, art, policy, retry=retry,
                                  breaker=breaker)
        if pretune is not False and pretune is not None:
            try:
                example = (_example_row(art, calibration) if pretune is True
                           else np.asarray(pretune))
                if example is None:
                    raise ValueError(
                        f"pretune=True cannot infer an input row for "
                        f"endpoint '{name}' ({art.kind}); pass "
                        f"pretune=<example row>")
                art.pretune(example, batches=ep.policy.buckets())
            except BaseException:
                self.router.unregister(name)  # never leave a half-made ep
                raise
        return ep

    def enable_fleet(self, names: Optional[list] = None) -> Dict[tuple, list]:
        """Coalesce compatible endpoints into stacked fleet launches.

        Groups the endpoints in ``names`` (default: all registered) by
        :func:`repro_torch.compile.fleet_signature`; every group with at
        least two stackable members gets one
        :class:`~repro_torch.serve.fleet.FleetCoalescer` — their in-flight
        micro-batches are served by ONE stacked kernel launch per round,
        bit-identically to per-endpoint serving (degradation and breaker
        paths still honored per member, via per-member fallback).  The
        stacked program is built through the artifact cache
        (:meth:`ArtifactCache.get_or_stack`).  Endpoints already in a
        fleet, unstackable artifacts (trees, float targets, per-layer
        routes, the ``ref`` backend), artifacts on another device than the
        service's, and under-sized groups keep their own workers.  Returns
        ``{fleet signature: [member names]}`` for the fleets formed.
        """
        from repro_torch.compile import fleet_signature

        from .fleet import FleetCoalescer

        coalesced = {n for members in self._fleets for n in members}
        pool = [n for n in (names if names is not None
                            else self.router.names())
                if n not in coalesced]
        groups: Dict[tuple, list] = {}
        for n in pool:
            ep = self.router[n]
            if ep.artifact.device != self.device:
                continue
            sig = fleet_signature(ep.artifact)
            if sig is not None:
                groups.setdefault(sig, []).append(n)
        formed: Dict[tuple, list] = {}
        for sig, members in groups.items():
            if len(members) < 2:
                continue
            eps = [self.router[n] for n in members]
            stack = self.cache.get_or_stack([ep.artifact for ep in eps])
            self._fleets[tuple(members)] = FleetCoalescer(stack, eps)
            formed[sig] = members
        return formed

    def enable_degradation(self, name: str, model: Any = None,
                           target: Optional[Target] = None,
                           artifact: Optional[CompiledArtifact] = None,
                           policy: Optional[DegradationPolicy] = None,
                           calibration: Any = None) -> Endpoint:
        """Arm endpoint ``name`` with a degraded-precision fallback.

        Pass either a pre-compiled ``artifact`` or ``model`` + ``target``
        (compiled through the shared cache, so the primary and fallback
        artifacts of one model — e.g. ``auto16`` and ``auto8`` plans —
        coexist as two cache entries keyed by their plan descriptors).
        Under overload (``policy`` watermarks, queue depth or rolling p99)
        the endpoint's dispatcher serves batches with the fallback and
        recovers with hysteresis when load subsides.
        """
        ep = self.router[name]
        if (artifact is None) == (model is None):
            raise TypeError("pass either model (+ target) or artifact")
        if artifact is None:
            artifact = self.cache.get_or_compile(model, target or Target(),
                                                 calibration=calibration,
                                                 device=self.device)
        ep.set_fallback(artifact, policy)
        return ep

    def enable_breaker(self, name: str,
                       policy: Optional[BreakerPolicy] = None) -> Endpoint:
        """Arm endpoint ``name`` with a circuit breaker: after repeated
        dispatch failures (``policy`` triggers) new submissions fail fast
        with :class:`~repro_torch.serve.reliability.CircuitOpenError` until
        half-open probes succeed.  Breaker state shows in :meth:`stats`.
        """
        ep = self.router[name]
        ep.set_breaker(policy)
        return ep

    def unregister(self, name: str) -> None:
        for members in self._fleets:
            if name in members:
                raise RuntimeError(
                    f"endpoint '{name}' is coalesced into fleet {members}; "
                    f"close the service (or the fleet) before unregistering "
                    f"a member")
        self.router.unregister(name)

    def endpoint(self, name: str) -> Endpoint:
        return self.router[name]

    def close(self, timeout: Optional[float] = None) -> None:
        """Close every endpoint, draining queued requests.  ``timeout``
        bounds the total drain (seconds): requests that cannot be served in
        time are rejected with an error — every future resolves either way.
        """
        # Fleet coalescers stop FIRST (finalizing in-flight rounds): the
        # routers' batcher drains then serve each member's leftovers on the
        # closing thread, which requires no other driver to be running.
        fleets, self._fleets = self._fleets, {}
        for co in fleets.values():
            co.close(timeout)
        self.router.close(timeout=timeout)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Alias of :meth:`close` named for the serving lifecycle: stop
        accepting, serve what is queued (bounded by ``timeout``), shut down.
        """
        self.close(timeout=timeout)

    def serve_http(self, host: str = "127.0.0.1", port: int = 0,
                   admission: Any = None, slo: Any = None):
        """Build (not start) the asyncio HTTP front end for this service:
        ``asyncio.run(svc.serve_http(...).serve())`` or ``await
        server.start()`` inside a running loop.  See
        :class:`repro_torch.serve.net.HttpServer`.
        """
        from .net import HttpServer

        return HttpServer(self, host=host, port=port, admission=admission,
                          slo=slo)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- inference -----------------------------------------------------------
    def submit(self, name: str, x: np.ndarray,
               timeout_s: Optional[float] = None) -> Future:
        return self.router.submit(name, x, timeout_s=timeout_s)

    def predict(self, name: str, x: np.ndarray) -> np.ndarray:
        return self.router.predict(name, x)

    def generate(self, name: str, tokens: np.ndarray, n_tokens: int,
                 **kw) -> np.ndarray:
        """Greedy LM generation on an ``lm`` endpoint: (B,) start tokens ->
        (B, n_tokens + 1) token ids."""
        return self.router[name].generate(tokens, n_tokens, **kw)

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, Dict[str, float]]:
        out = self.router.stats()
        out["_cache"] = self.cache.stats()
        if self._fleets:
            out["_fleets"] = [co.snapshot() for co in self._fleets.values()]
        inj = faults.current()
        if inj is not None:
            out["_faults"] = inj.stats()
        return out
