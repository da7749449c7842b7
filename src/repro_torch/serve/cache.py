"""Artifact cache: dedupe recompiles by ``(fingerprint, Target, mesh,
device)``.

The counterpart of :mod:`repro.serve.cache` for the PyTorch port.
Compiling is the expensive step (quantize + lower + the weights' copy to the
card); hosting the same model under several endpoints, or re-registering it
after a config reload, should not pay it twice.  The cache keys on the
sha256 fingerprint of the *extracted* parameter tree (see
:mod:`repro_torch.compile.fingerprint`) plus the frozen Target plus the
mesh descriptor (axes, platform, device ids, strategy) of replica-sharded
artifacts plus the QuantPlan descriptor for calibrated targets plus the
device the artifact is compiled on, so equal parameters hit regardless of
which model object they came from.

Compilation is *single-flight*: when N threads race a miss on the same key
(a restart storm re-registering every endpoint at once), exactly one thread
compiles while the others block on its result — N racing registrations
yield one artifact object, not N identical compiles with a last-writer-wins
cache entry.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import Future
from typing import Any, Dict, Optional, Tuple

from repro_torch.compile import (CompiledArtifact, Target,
                                 compile_from_params, fingerprint_params,
                                 get_lowering, mesh_descriptor, model_kind,
                                 resolve_device, resolve_mesh_strategy,
                                 specialize_mesh)

from . import faults

__all__ = ["ArtifactCache"]

# (fingerprint, Target, mesh descriptor or None, QuantPlan descriptor or
#  None, ambient kernel-routing token or None, device)
CacheKey = Tuple[str, Target, Optional[Tuple], Optional[Tuple], Optional[str],
                 str]


def _kernel_env_token(target: Target) -> Optional[str]:
    """Ambient state that changes what a cuda compile produces.

    The megakernel/per-layer routing depends on the ``REPRO_MEGAKERNEL_VMEM``
    budget override, which lives *outside* the Target — so it must be part
    of the cache key (the pre-compile analogue of
    ``CompiledArtifact.kernel_strategy``): two compiles of one model under
    different budgets must not alias to one cache entry.
    """
    if target.backend != "cuda":
        return None
    import os

    return os.environ.get("REPRO_MEGAKERNEL_VMEM")


class ArtifactCache:
    """LRU cache of compiled artifacts keyed by ``(fingerprint, Target,
    mesh, plan, device)``, with single-flight compilation under
    concurrency."""

    # Calibration-plan memo bound: plans are tiny (a format table), but the
    # memo must not grow without limit under adversarial batch churn.
    _PLAN_MEMO_CAP = 256

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()
        self._entries: "OrderedDict[CacheKey, CompiledArtifact]" = OrderedDict()
        self._inflight: Dict[CacheKey, Future] = {}
        # (fingerprint, Target, sha256 of the calibration batch) -> QuantPlan.
        # Deriving a plan replays the model in float over the whole batch —
        # far from free — so repeat registrations (the restart storm the
        # single-flight path exists for) must not pay it per call.
        self._plans: "OrderedDict[Tuple, Any]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: CacheKey) -> Optional[CompiledArtifact]:
        with self._lock:
            art = self._entries.get(key)
            if art is not None:
                self._entries.move_to_end(key)
            return art

    def put(self, artifact: CompiledArtifact) -> CompiledArtifact:
        if not artifact.fingerprint:
            raise ValueError("artifact has no fingerprint; compile it through "
                             "repro_torch.compile.compile")
        return self._insert(artifact.cache_key, artifact)

    def _insert(self, key, artifact: CompiledArtifact) -> CompiledArtifact:
        with self._lock:
            self._entries[key] = artifact
            self._entries.move_to_end(key)
            while self.capacity is not None and len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        return artifact

    def _plan_for(self, lowering, params, fingerprint: str, target: Target,
                  calibration: Any):
        """Memoized QuantPlan derivation (see get_or_compile)."""
        import hashlib

        import numpy as np

        from repro_torch.quant import make_plan

        if calibration is None:  # make_plan raises the helpful error
            return make_plan(lowering, params, target, calibration)
        batch = np.ascontiguousarray(np.asarray(calibration, np.float32))
        sha = hashlib.sha256(batch.tobytes()).hexdigest()
        memo_key = (fingerprint, target, sha)
        with self._lock:
            plan = self._plans.get(memo_key)
            if plan is not None:
                self._plans.move_to_end(memo_key)
                return plan
        plan = make_plan(lowering, params, target, batch)
        with self._lock:
            self._plans[memo_key] = plan
            self._plans.move_to_end(memo_key)
            while len(self._plans) > self._PLAN_MEMO_CAP:
                self._plans.popitem(last=False)
        return plan

    def get_or_compile(self, model: Any, target: Target,
                       mesh: Any = None, strategy: str = "auto",
                       calibration: Any = None,
                       device: Any = None) -> CompiledArtifact:
        """Return the cached artifact for (model params, target, mesh, plan,
        device), compiling on miss.  ``device`` resolves as
        :func:`repro_torch.compile.compile` resolves it: the current CUDA
        device by default, the host only when asked for.  With a ``mesh``
        the artifact compiled there is specialized for it
        (:func:`repro_torch.compile.specialize_mesh` with ``strategy``)
        inside the same single flight.  Extraction runs unconditionally (it is cheap and
        yields the fingerprint); the quantize/lower/specialize stages are
        what a hit skips.  Concurrent misses on one key compile once
        (single-flight); the racing callers receive the winner's artifact.

        ``calibration`` (a sample batch) is required for calibrated
        (``auto*``) Targets: the per-tensor plan is derived *before* keying,
        so two different batches that calibrate to the same plan share one
        artifact, while batches that genuinely change the plan get their
        own entry — the plan, not the batch, determines the program.  The
        derivation itself (a float replay of the model over the batch) is
        memoized by (fingerprint, Target, batch sha256), so repeat
        registrations of one endpoint stay as cheap as fixed-format hits.
        """
        dev = resolve_device(device)
        kind = model_kind(model)
        lowering = get_lowering(kind)
        params = lowering.extract_params(model)
        fingerprint = fingerprint_params(kind, params)
        mesh_key = None
        if mesh is not None:
            mesh_key = mesh_descriptor(mesh, resolve_mesh_strategy(mesh,
                                                                   strategy))
        plan = None
        if target.is_calibrated:
            plan = self._plan_for(lowering, params, fingerprint, target,
                                  calibration)
        key: CacheKey = (fingerprint, target, mesh_key,
                         None if plan is None else plan.descriptor(),
                         _kernel_env_token(target), str(dev))
        with self._lock:
            art = self._entries.get(key)
            if art is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return art
            fut = self._inflight.get(key)
            if fut is None:
                fut = Future()
                self._inflight[key] = fut
                owner = True
            else:
                owner = False
        if not owner:
            # fut.result() re-raises the owner's compile failure verbatim —
            # waiters share the owner's fate for THIS flight only; the slot
            # is already cleared, so any of them may simply call again.
            art = fut.result()
            with self._lock:
                self.hits += 1
            return art
        # Owner path.  Everything through put() runs inside the guard: a
        # failure anywhere (compile, mesh specialization, the cache insert
        # itself) must clear the in-flight slot and resolve the waiters with
        # the exception — never leave them blocked, never cache a broken
        # entry.  The slot is popped *before* the future resolves so a
        # waiter that catches the error and retries starts a fresh flight.
        try:
            faults.fire("cache.compile", name=kind)
            art = compile_from_params(kind, params, target, plan=plan,
                                      device=dev)
            if mesh is not None:
                art = specialize_mesh(art, mesh, strategy)
            with self._lock:
                self.misses += 1
            self._insert(key, art)
        except BaseException as e:
            with self._lock:
                self._inflight.pop(key, None)
            fut.set_exception(e)
            raise
        with self._lock:
            self._inflight.pop(key, None)
        fut.set_result(art)
        return art

    def get_or_stack(self, artifacts) -> Any:
        """Return the cached :class:`repro_torch.compile.FleetStack` over
        exactly these member artifacts (in order), stacking on miss.

        Keyed by ``("fleet", <member cache keys>)`` — the member keys
        already capture fingerprint/Target/plan/kernel routing/device, so
        two fleets over the same artifact set share one stacked program
        while any member change (recalibration, different budget) forces a
        restack.  Single-flight like compiles: stacking materializes the
        whole fleet's weights on device, which N racing enables must not
        pay N times.
        """
        from repro_torch.compile import stack_fleet

        key = ("fleet", tuple(a.cache_key for a in artifacts))
        with self._lock:
            stack = self._entries.get(key)
            if stack is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return stack
            fut = self._inflight.get(key)
            if fut is None:
                fut = Future()
                self._inflight[key] = fut
                owner = True
            else:
                owner = False
        if not owner:
            stack = fut.result()
            with self._lock:
                self.hits += 1
            return stack
        try:
            stack = stack_fleet(artifacts)
            with self._lock:
                self.misses += 1
            self._insert(key, stack)
        except BaseException as e:
            with self._lock:
                self._inflight.pop(key, None)
            fut.set_exception(e)
            raise
        with self._lock:
            self._inflight.pop(key, None)
        fut.set_result(stack)
        return stack

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits,
                    "misses": self.misses, "capacity": self.capacity}
