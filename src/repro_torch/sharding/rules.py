"""Logical-axis -> partition-spec rules with divisibility guards, and the
serving-mesh helpers behind replica-sharded classifier endpoints.

The counterpart of :mod:`repro.sharding.rules` for the PyTorch port.  The
production mesh is ``(data=16, model=16)`` per pod, with a leading pure-DP
``pod`` axis in the multi-pod mesh.  Logical axes used by the LM stack:

* ``batch``   -> all data-parallel axes (``('pod','data')`` or ``('data',)``)
* ``seq``     -> None normally; ``'data'`` for sequence-parallel long-context
* ``model``   -> tensor/expert-parallel axis (heads, ffn columns, vocab, experts)
* ``expert``  -> ``('data', 'model')`` when the expert count divides both
* anything else -> replicated (None)

``spec_for`` drops a mesh axis whenever the dimension is not divisible by the
axis size (e.g. qwen2's 14 heads on a 16-way model axis).

**The mesh.**  torch has no single-process counterpart of
``jax.sharding.Mesh``: ``torch.distributed``'s ``DeviceMesh`` needs a process
group, and the serving plane drives every local card from one process, as
the reference does.  So :class:`Mesh` is a small placement plan with the
reference's surface (``devices`` as a numpy object array, ``axis_names``,
``shape``).  A device entry is a ``torch.device("cuda", i)`` naming a card
that exists, or a :class:`HostDevice` placeholder: the counterpart of the
reference's ``--xla_force_host_platform_device_count`` host devices, which
the port cannot have (:func:`make_host_mesh`).  A spec is a tuple with one
entry per dimension (``None``, an axis name, or a tuple of names), the
counterpart of ``PartitionSpec``.

**Placement: DTensor.**  JAX splits one program over a mesh from a single
controller; torch's idiom is one process per device, each holding its
shard of every tensor as a ``torch.distributed.tensor.DTensor``.  So:

* :class:`NamedSharding` (``Rules.sharding``) pairs a :class:`Mesh` with a
  spec, as ``jax.sharding.NamedSharding`` does;
* :func:`device_mesh` maps a :class:`Mesh` onto the running process group
  (rank r is ``mesh.devices.flat[r]``; NCCL over cards, gloo over host
  placeholders), and :func:`placements` turns a spec into the DTensor
  placements over it;
* :func:`device_put` is ``jax.device_put(x, NamedSharding)``: it
  distributes a full tensor that every rank holds;
* :func:`shard` is ``with_sharding_constraint``: it redistributes an
  activation to the spec its logical axes resolve to.

The dry run plans over a :class:`Mesh` with no process group at all;
:func:`repro_torch.launch.mesh.run_on_mesh` starts the processes a
placement needs.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "HostDevice", "batch_axes", "model_axis", "spec_for",
           "Rules", "NamedSharding", "shard", "placements", "device_mesh",
           "device_put", "device_put_tree", "is_dtensor", "full_value",
           "gather_fsdp",
           "make_serving_mesh", "make_host_mesh", "dp_size",
           "batch_spec", "replica_bucket", "is_host_emulated",
           "device_platform", "device_id", "torch_device",
           "replica_devices"]


@dataclasses.dataclass(frozen=True)
class HostDevice:
    """A host placeholder device of an emulated mesh (``platform`` 'cpu')."""

    id: int
    platform: str = "cpu"


def device_platform(d) -> str:
    """'cpu' for a host placeholder, 'gpu' for a CUDA card (the reference's
    platform names)."""
    return "gpu" if isinstance(d, torch.device) else d.platform


def device_id(d) -> int:
    return int(d.index) if isinstance(d, torch.device) else int(d.id)


def torch_device(d) -> torch.device:
    """Where a mesh device's replica runs: its card, or the host."""
    return d if isinstance(d, torch.device) else torch.device("cpu")


class Mesh:
    """An n-D array of devices with named axes (see the module docstring).

    Raises ``ValueError`` for a device entry of another type, a CUDA device
    without an index or naming a card this host does not have, a repeated
    device, or axis names that do not match the array's rank.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        devs = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devs.ndim != len(axis_names):
            raise ValueError(f"mesh of rank {devs.ndim} given axis names "
                             f"{axis_names}")
        seen = set()
        for d in devs.flat:
            if isinstance(d, torch.device):
                if d.type != "cuda" or d.index is None:
                    raise ValueError(
                        f"mesh device {d}: use torch.device('cuda', i) for a "
                        f"card or HostDevice(i) for an emulated host device")
                if d.index >= torch.cuda.device_count():
                    raise ValueError(
                        f"mesh device {d}: this host has "
                        f"{torch.cuda.device_count()} CUDA device(s)")
            elif not isinstance(d, HostDevice):
                raise ValueError(f"mesh device {d!r} is neither a CUDA "
                                 f"torch.device nor a HostDevice")
            key = (device_platform(d), device_id(d))
            if key in seen:
                raise ValueError(f"mesh devices must be unique; {d} appears "
                                 f"twice")
            seen.add(key)
        self.devices = devs
        self.axis_names = axis_names
        self.shape = collections.OrderedDict(zip(axis_names, devs.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        axes = ", ".join(f"'{a}': {n}" for a, n in self.shape.items())
        return (f"Mesh({axes}; "
                f"{device_platform(self.devices.flat[0]) if self.size else '-'})")


def batch_axes(mesh) -> Tuple[str, ...]:
    """All pure data-parallel mesh axes, outermost first."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis(mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


@dataclasses.dataclass(frozen=True)
class Rules:
    """Resolves logical axis names against a concrete mesh."""

    mesh: Mesh
    seq_sharded: bool = False  # sequence parallelism for long-context cells

    def resolve(self, logical: Optional[str], dim: int):
        if logical is None:
            return None
        if logical == "batch":
            axes = batch_axes(self.mesh)
            total = int(np.prod([self.mesh.shape[a] for a in axes])) if axes else 1
            if axes and dim % total == 0:
                return axes if len(axes) > 1 else axes[0]
            # fall back to in-pod data axis only
            if "data" in self.mesh.axis_names and dim % self.mesh.shape["data"] == 0:
                return "data"
            return None
        if logical == "seq":
            if self.seq_sharded and "data" in self.mesh.axis_names and \
                    dim % self.mesh.shape["data"] == 0:
                return "data"
            return None
        if logical == "model":
            ax = model_axis(self.mesh)
            if ax is not None and dim % self.mesh.shape[ax] == 0:
                return ax
            return None
        if logical == "expert":
            # 2D expert sharding: experts spread over (data, model) so each
            # expert is fully resident on one chip group — tokens move
            # instead of expert weights.
            axes = tuple(a for a in ("data", "model") if a in self.mesh.axis_names)
            total = int(np.prod([self.mesh.shape[a] for a in axes])) if axes else 1
            if axes and dim % total == 0:
                return axes
            return self.resolve("model", dim)
        raise KeyError(f"unknown logical axis '{logical}'")

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> tuple:
        if len(logical_axes) != len(shape):
            raise ValueError(f"{len(logical_axes)} logical axes "
                             f"{tuple(logical_axes)} for shape {tuple(shape)}")
        return tuple(self.resolve(l, d) for l, d in zip(logical_axes, shape))

    def sharding(self, logical_axes: Sequence[Optional[str]],
                 shape: Sequence[int]) -> "NamedSharding":
        return NamedSharding(self.mesh, self.spec(logical_axes, shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the counterpart of ``jax.sharding.NamedSharding``."""

    mesh: Mesh
    spec: tuple


def spec_for(mesh: Optional[Mesh], logical_axes: Sequence[Optional[str]],
             shape: Sequence[int], seq_sharded: bool = False) -> Optional[tuple]:
    if mesh is None:
        return None
    return Rules(mesh, seq_sharded).spec(logical_axes, shape)


# --------------------------------------------------------------------------
# placement: a Mesh onto the process group, a spec onto DTensor placements
# --------------------------------------------------------------------------
_DEVICE_MESHES: dict = {}


def placements(spec: Sequence, device_mesh) -> tuple:
    """The DTensor placements of ``spec`` over ``device_mesh``: a tensor dim
    on an axis (or a tuple of axes, in mesh order) is ``Shard(dim)`` on each
    of those mesh dims; every other mesh dim is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]} appears twice in "
                                 f"spec {tuple(spec)}")
            out[i] = Shard(dim)
    return tuple(out)


def device_mesh(mesh: Mesh):
    """The ``DeviceMesh`` of ``mesh`` over the running process group, whose
    world size must equal ``mesh.size``: rank r is ``mesh.devices.flat[r]``,
    a ``"cuda"`` mesh (NCCL) over cards or a ``"cpu"`` one (gloo) over host
    placeholders, its dim names the mesh's axis names.  Built once per mesh
    and process group (building one is collective)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs an initialized process group "
                           "(repro_torch.launch.mesh.run_on_mesh starts one)")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"process group of {dist.get_world_size()} ranks "
                         f"for a mesh of {mesh.size} devices")
    world = dist.group.WORLD
    hit = _DEVICE_MESHES.get(id(mesh))
    if hit is not None and hit[1] is world:
        return hit[2]
    kinds = {device_platform(d) for d in mesh.devices.flat}
    if len(kinds) != 1:
        raise ValueError(f"mesh mixes device kinds {sorted(kinds)}")
    dtype = "cuda" if kinds == {"gpu"} else "cpu"
    ranks = torch.arange(mesh.size).reshape(mesh.devices.shape)
    dm = DeviceMesh(dtype, ranks, mesh_dim_names=mesh.axis_names)
    _DEVICE_MESHES[id(mesh)] = (mesh, world, dm)
    return dm


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor placed on a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def full_value(tree):
    """The full value of a DTensor, or of each DTensor leaf of a tree of
    dicts, lists, tuples and named tuples (a collective every rank makes);
    any other leaf as it is.  The counterpart of ``jax.device_get``."""
    if isinstance(tree, dict):
        return {k: full_value(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(full_value(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_value(v) for v in tree)
    return tree.full_tensor() if is_dtensor(tree) else tree


def device_put(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (the full tensor, the same on every rank) distributed over
    ``sharding``'s mesh by its spec: the counterpart of ``jax.device_put``."""
    from torch.distributed.tensor import distribute_tensor

    dm = device_mesh(sharding.mesh)
    x = torch.as_tensor(x).to(dm.device_type)
    return distribute_tensor(x, dm, placements(sharding.spec, dm))


def device_put_tree(tree, specs, mesh: Mesh):
    """:func:`device_put` on every leaf of a dict tree, each with the spec
    (a tuple) at the same place in ``specs`` (``param_specs``,
    ``cache_specs``)."""
    if isinstance(tree, dict):
        return {k: device_put_tree(v, specs[k], mesh) for k, v in tree.items()}
    return device_put(tree, NamedSharding(mesh, specs))


def shard(x, logical_axes: Sequence[Optional[str]], rules: Optional[Rules]):
    """Activation sharding constraint: ``x`` unchanged when ``rules`` is
    None, else redistributed to the spec its logical axes resolve to.  A
    plain tensor under rules raises ``TypeError``: it has left the mesh."""
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError(f"shard: a plain {type(x).__name__} of shape "
                        f"{tuple(x.shape)} under rules (expected a DTensor "
                        f"on the rules' mesh)")
    dm = device_mesh(rules.mesh)
    spec = rules.spec(logical_axes, x.shape)
    return x.redistribute(dm, placements(spec, dm))


def gather_fsdp(w):
    """A parameter DTensor with its shards on the data axes (``pod``,
    ``data``: FSDP's) gathered, as FSDP gathers a weight at use, and its
    ``model`` shards kept; a plain tensor as it is.  A product then runs on
    whole contraction dims on each rank, where DTensor would otherwise sum
    partial products across the data ranks."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    names = tuple(w.device_mesh.mesh_dim_names)
    return w.redistribute(w.device_mesh, [
        Replicate() if names[i] in ("pod", "data") else p
        for i, p in enumerate(w.placements)])


# --------------------------------------------------------------------------
# serving meshes: batch-axis placement for data-parallel inference
# --------------------------------------------------------------------------
# The classifier serving path (repro_torch.serve +
# CompiledArtifact.specialize_mesh) is pure data parallelism: every replica
# holds the full (tiny) model and serves a batch shard.  These helpers are
# the single source of truth for "which mesh axes carry the batch" —
# consumed by serve (replica-aware buckets), compile (mesh-specialized
# predicts), and launch (--dp).


def make_serving_mesh(n_devices: Optional[int] = None,
                      devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D pure-DP ``('data',)`` mesh over ``n_devices`` (default: all).

    ``devices`` defaults to every visible CUDA device.  Asking for more
    devices than there are raises ``ValueError``: a mesh never names a card
    that is not there, and never falls back to the host (build a host mesh
    with :func:`make_host_mesh` for that).
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices) if n_devices is None else int(n_devices)
    if n > len(devices) or n < 1:
        raise ValueError(
            f"requested {n} devices but only {len(devices)} "
            f"are available (on a host without that many cards, "
            f"make_host_mesh(n) emulates a host mesh)")
    return Mesh(devices[:n], ("data",))


def make_host_mesh(n: int) -> Mesh:
    """A 1-D ``('data',)`` mesh of ``n`` host placeholder devices: replicas
    that share the host (the reference's emulated host platform)."""
    return make_serving_mesh(n, devices=[HostDevice(i) for i in range(n)])


def dp_size(mesh) -> int:
    """Number of data-parallel replicas the mesh serves batch shards on.

    The product of the batch axes' sizes (``pod`` x ``data``); a mesh with
    no batch axis (pure model parallelism) has one replica.
    """
    axes = batch_axes(mesh)
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


def replica_devices(mesh) -> list:
    """The device each of the ``dp_size(mesh)`` replicas runs on, in
    replica order: the first device of each batch shard's group along the
    non-batch axes (those devices would all compute the same shard)."""
    names = mesh.axis_names
    axes = batch_axes(mesh)
    order = [names.index(a) for a in axes] + [
        i for i, a in enumerate(names) if a not in axes]
    groups = np.transpose(mesh.devices, order).reshape(dp_size(mesh), -1)
    return [g[0] for g in groups]


def batch_spec(mesh) -> tuple:
    """The spec placing a leading batch dimension on the batch axes."""
    axes = batch_axes(mesh)
    return (axes if len(axes) > 1 else (axes[0] if axes else None),)


def replica_bucket(n: int, replicas: int) -> Tuple[int, int]:
    """Replica-aware padding: ``(shard, total)`` for ``n`` rows on ``replicas``.

    Every replica sees the same power-of-two shard (the serve ladder, per
    device), so ``n`` rows pad up to ``replicas * pow2ceil(ceil(n /
    replicas))``, with the port's own ``pow2ceil`` so the replica shards and
    the bucket ladder never disagree on the rounding rule.
    """
    from repro_torch.kernels.tune import pow2ceil

    n = max(1, int(n))
    replicas = max(1, int(replicas))
    shard = pow2ceil(-(-n // replicas))
    return shard, shard * replicas


def is_host_emulated(mesh) -> bool:
    """True when every mesh device is a host placeholder.

    Such meshes (:func:`make_host_mesh`) emulate placement but share one
    physical host, where per-replica dispatch is pure overhead: the
    mesh-specialized predict then runs the replica shards as one fused
    batch (bit-identical by row independence) instead of replica by replica.
    """
    return all(device_platform(d) == "cpu" for d in mesh.devices.flat)
