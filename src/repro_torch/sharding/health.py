"""Replica health tracking for mesh-specialized serving.

The counterpart of :mod:`repro.sharding.health` for the PyTorch port,
behaviour for behaviour.  A mesh artifact shards each micro-batch across N
data-parallel replicas.  Replicas fail *independently* (a card resets, a
host drops off): losing one replica must not take down the endpoint, and
must not change any surviving row's answer.  Because every lowering is
row-independent, a batch can be re-sharded over any subset of replicas bit
for bit, so the fused mesh dispatch path
(:func:`repro_torch.compile.api.specialize_mesh`) routes each shard through
a :class:`ReplicaHealthTracker`:

* a replica that faults ``evict_after`` consecutive times is **evicted**
  from the dispatch set; its shards fail over to healthy replicas;
* every ``probe_every`` dispatches an evicted replica gets one shard as a
  **probe**; a probe success re-admits it, a probe failure restarts the
  eviction clock;
* the last healthy replica is never evicted: with nowhere to fail over
  to, the error propagates to the retry/bisection layer instead.

The tracker is deliberately dumb about *what* a fault is: the dispatch
path reports outcomes, the tracker only decides who serves next.  All
state is surfaced via :meth:`ReplicaHealthTracker.snapshot` into
``/v1/stats``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List

__all__ = ["ReplicaHealthPolicy", "ReplicaHealthTracker"]


@dataclasses.dataclass(frozen=True)
class ReplicaHealthPolicy:
    """Eviction/probing knobs.

    * ``evict_after`` — consecutive faults on one replica before eviction.
    * ``probe_every`` — dispatch events between re-admission probes of an
      evicted replica (1 = probe on every dispatch).
    """

    evict_after: int = 2
    probe_every: int = 16

    def __post_init__(self):
        if self.evict_after < 1:
            raise ValueError("evict_after must be >= 1")
        if self.probe_every < 1:
            raise ValueError("probe_every must be >= 1")


class ReplicaHealthTracker:
    """Tracks per-replica health and picks dispatch candidates.

    ``candidates(slot)`` returns the replica-index preference order for
    the shard that would nominally run on ``slot``: the nominal replica
    first when healthy (keeping the all-healthy path identical to the
    untracked one), then the remaining healthy replicas in rotation, with
    a probe-due evicted replica promoted to the front so re-admission
    gets exercised.  The dispatch path tries candidates in order and
    reports the outcome via ``record_success``/``record_failure``.
    """

    def __init__(self, n_replicas: int,
                 policy: ReplicaHealthPolicy | None = None):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.n = int(n_replicas)
        self.policy = policy or ReplicaHealthPolicy()
        self._lock = threading.Lock()
        self._healthy = [True] * self.n
        self._consecutive = [0] * self.n
        self._since_probe = [0] * self.n  # dispatches since last probe
        self.faults = 0
        self.evictions = 0
        self.readmissions = 0
        self.probes = 0

    # -- dispatch-side API ----------------------------------------------------
    def all_healthy(self) -> bool:
        with self._lock:
            return all(self._healthy)

    def healthy_replicas(self) -> List[int]:
        with self._lock:
            return [i for i in range(self.n) if self._healthy[i]]

    def candidates(self, slot: int) -> List[int]:
        """Replica preference order for the shard nominally on ``slot``."""
        with self._lock:
            healthy = [i for i in range(self.n) if self._healthy[i]]
            probe = None
            for i in range(self.n):
                if self._healthy[i]:
                    continue
                self._since_probe[i] += 1
                if probe is None and (self._since_probe[i]
                                      >= self.policy.probe_every):
                    probe = i
                    self._since_probe[i] = 0
                    self.probes += 1
            nominal = slot % self.n
            order: List[int] = []
            if probe is not None:
                order.append(probe)
            if self._healthy[nominal]:
                order.append(nominal)
            # rotation keyed on the slot spreads failover load instead of
            # dogpiling replica 0 with every orphaned shard
            for k in range(len(healthy)):
                cand = healthy[(slot + k) % len(healthy)]
                if cand not in order:
                    order.append(cand)
            return order

    def record_success(self, replica: int) -> None:
        with self._lock:
            self._consecutive[replica] = 0
            if not self._healthy[replica]:
                self._healthy[replica] = True
                self.readmissions += 1

    def record_failure(self, replica: int) -> None:
        with self._lock:
            self.faults += 1
            if not self._healthy[replica]:
                # failed probe: restart the probe clock
                self._since_probe[replica] = 0
                return
            self._consecutive[replica] += 1
            if self._consecutive[replica] < self.policy.evict_after:
                return
            if sum(self._healthy) <= 1:
                # Never evict the last healthy replica: with no failover
                # target the error must surface to retry/bisection instead.
                return
            self._healthy[replica] = False
            self._since_probe[replica] = 0
            self.evictions += 1

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "replicas": self.n,
                "healthy": [i for i in range(self.n) if self._healthy[i]],
                "evicted": [i for i in range(self.n) if not self._healthy[i]],
                "faults": self.faults,
                "evictions": self.evictions,
                "readmissions": self.readmissions,
                "probes": self.probes,
            }
