"""Sharding rules: logical axes -> partition specs with divisibility guards,
the serving-mesh helpers behind replica-sharded classifier endpoints, and
the placement of tensors on a mesh through DTensor (the counterpart of
:mod:`repro.sharding`)."""

from .health import ReplicaHealthPolicy, ReplicaHealthTracker
from .rules import (HostDevice, Mesh, NamedSharding, Rules, batch_axes,
                    batch_spec, device_mesh, device_put,
                    device_put_tree, dp_size, full_value, is_dtensor,
                    is_host_emulated, make_host_mesh, make_serving_mesh,
                    model_axis, placements, replica_bucket, shard, spec_for)

__all__ = ["batch_axes", "model_axis", "spec_for", "Rules",
           "make_serving_mesh", "dp_size", "batch_spec", "replica_bucket",
           "is_host_emulated", "ReplicaHealthPolicy", "ReplicaHealthTracker",
           "Mesh", "HostDevice", "make_host_mesh", "NamedSharding", "shard",
           "placements", "device_mesh", "device_put", "device_put_tree",
           "is_dtensor", "full_value"]
