"""Sharding rules: logical axes -> partition specs with divisibility guards,
plus the serving-mesh helpers behind replica-sharded classifier endpoints
(the counterpart of :mod:`repro.sharding`; ``Rules.sharding`` and ``shard``
wait for the LM half of the multi-GPU port)."""

from .health import ReplicaHealthPolicy, ReplicaHealthTracker
from .rules import (HostDevice, Mesh, Rules, batch_axes, batch_spec, dp_size,
                    is_host_emulated, make_host_mesh, make_serving_mesh,
                    model_axis, replica_bucket, spec_for)

__all__ = ["batch_axes", "model_axis", "spec_for", "Rules",
           "make_serving_mesh", "dp_size", "batch_spec", "replica_bucket",
           "is_host_emulated", "ReplicaHealthPolicy", "ReplicaHealthTracker",
           "Mesh", "HostDevice", "make_host_mesh"]
