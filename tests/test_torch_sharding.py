"""The port's sharding rules, serving-mesh helpers, production meshes and
replica health tracking against the live JAX package's.

The reference's side is built over ``jax.sharding.AbstractMesh`` (its
``Rules`` needs no devices there); the port's meshes are plans over host
placeholder devices.  A spec is compared as a tuple (``PartitionSpec``
iterates as one).
"""

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.launch import mesh as jlaunch_mesh
from repro.sharding import health as jhealth
from repro.sharding import rules as jrules
from repro_torch.launch import mesh as tmesh
from repro_torch.serve import BatchingPolicy
from repro_torch.sharding import (HostDevice, Mesh, ReplicaHealthPolicy,
                                  ReplicaHealthTracker)
from repro_torch.sharding import rules as trules

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "8x1": ((8, 1), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "1x8": ((1, 8), ("data", "model")),
}
# (logical axes, shape): batch / seq / model / expert / None at divisible
# and indivisible dims (qwen2's 14 heads, 3 rows, an odd vocabulary, ...)
SPEC_CASES = [
    (("batch", "seq", "model"), (256, 4096, 896)),
    (("batch", "seq", "model"), (3, 4096, 14)),
    (("batch", None), (32, 7)),
    (("batch", None), (16, 7)),
    (("batch", None), (8, 7)),
    (("batch",), (2,)),
    (("seq", "model"), (4096, 151936)),
    (("seq", "model"), (4095, 151937)),
    (("model", None), (64, 896)),
    (("expert", "model", None), (256, 7168, 2048)),
    (("expert", "model", None), (8, 6144, 32768)),
    (("expert", None), (16, 4)),
    (("expert", None), (6, 4)),
    ((None, None, None), (1, 2, 3)),
    ((), ()),
]


def host_mesh(shape, names):
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = [HostDevice(i) for i in range(devs.size)]
    return Mesh(devs.reshape(shape), names)


@pytest.mark.parametrize("seq_sharded", [False, True])
@pytest.mark.parametrize("name", MESHES)
def test_rules_match_reference(name, seq_sharded):
    shape, names = MESHES[name]
    jmesh, tmesh_ = AbstractMesh(shape, names), host_mesh(shape, names)
    jr, tr = (jrules.Rules(jmesh, seq_sharded),
              trules.Rules(tmesh_, seq_sharded))
    for logical, dims in SPEC_CASES:
        want = tuple(jr.spec(logical, dims))
        assert tr.spec(logical, dims) == want, (logical, dims)
        assert trules.spec_for(tmesh_, logical, dims, seq_sharded) == want
        for l, d in zip(logical, dims):
            assert tr.resolve(l, d) == jr.resolve(l, d), (l, d)
    assert trules.batch_axes(tmesh_) == jrules.batch_axes(jmesh)
    assert trules.model_axis(tmesh_) == jrules.model_axis(jmesh)
    assert trules.dp_size(tmesh_) == jrules.dp_size(jmesh)
    assert trules.batch_spec(tmesh_) == tuple(jrules.batch_spec(jmesh))
    assert trules.spec_for(None, ("batch",), (8,)) is None


def test_rules_reject_unknown_axis_and_rank_mismatch():
    shape, names = MESHES["4x2"]
    with pytest.raises(KeyError, match="unknown logical axis 'heads'") as t:
        trules.Rules(host_mesh(shape, names)).resolve("heads", 8)
    with pytest.raises(KeyError) as j:
        jrules.Rules(AbstractMesh(shape, names)).resolve("heads", 8)
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="logical axes"):
        trules.Rules(host_mesh(shape, names)).spec(("batch",), (8, 2))


def test_mesh_refuses_duplicates_unknown_cards_and_bad_entries():
    with pytest.raises(ValueError, match="unique"):
        Mesh([HostDevice(0), HostDevice(1), HostDevice(0)], ("data",))
    # a card this host does not have: no fallback to the host
    missing = torch.device("cuda", torch.cuda.device_count())
    with pytest.raises(ValueError, match="CUDA device"):
        Mesh([missing], ("data",))
    with pytest.raises(ValueError, match="HostDevice"):
        Mesh([torch.device("cpu")], ("data",))
    with pytest.raises(ValueError, match="neither"):
        Mesh([0, 1], ("data",))
    with pytest.raises(ValueError, match="rank"):
        Mesh([HostDevice(0)], ("data", "model"))


# ---------------------------------------------------------------------------
# the serving-mesh helpers (tests/test_serve_sharded.py's, on host meshes)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_make_serving_mesh_shape(n):
    mesh = trules.make_host_mesh(n)
    assert mesh.axis_names == ("data",)
    assert list(mesh.shape.items()) == [("data", n)]
    assert trules.dp_size(mesh) == n
    assert trules.batch_spec(mesh) == ("data",) == tuple(
        jrules.batch_spec(AbstractMesh((n,), ("data",))))
    assert trules.is_host_emulated(mesh)
    assert [d.id for d in mesh.devices.flat] == list(range(n))
    devs = [HostDevice(i) for i in range(n)]
    assert list(trules.make_serving_mesh(devices=devs).devices.flat) == devs
    with pytest.raises(ValueError, match="only") as err:
        trules.make_serving_mesh(n + 1, devices=devs)
    assert "make_host_mesh(n)" in str(err.value)


def test_make_serving_mesh_counts_the_cards():
    """The default devices are every visible card; asking for one more
    raises the reference's error, naming the host mesh where the reference
    names its XLA flag."""
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {n + 1} devices but "
                                         f"only {n} are available"):
        trules.make_serving_mesh(n + 1)
    if n:
        mesh = trules.make_serving_mesh()
        assert trules.dp_size(mesh) == n
        assert not trules.is_host_emulated(mesh)


def test_dp_size_counts_batch_axes_only():
    class FakeMesh:
        def __init__(self, shape):
            self.shape = shape
            self.axis_names = tuple(shape)

    for shape in ({"data": 4, "model": 2}, {"pod": 2, "data": 4, "model": 2},
                  {"model": 4}):
        fake = FakeMesh(shape)
        assert trules.dp_size(fake) == jrules.dp_size(fake)
    assert trules.dp_size(FakeMesh({"pod": 2, "data": 4, "model": 2})) == 8
    assert trules.dp_size(FakeMesh({"model": 4})) == 1


def test_replica_bucket_padding():
    assert trules.replica_bucket(1, 1) == (1, 1)
    assert trules.replica_bucket(5, 1) == (8, 8)
    assert trules.replica_bucket(8, 8) == (1, 8)
    assert trules.replica_bucket(9, 8) == (2, 16)
    assert trules.replica_bucket(100, 8) == (16, 128)
    assert trules.replica_bucket(3, 8) == (1, 8)  # n < replicas
    assert trules.replica_bucket(512, 8) == (64, 512)
    assert trules.replica_bucket(3089, 1) == (4096, 4096)
    for n in range(0, 300, 7):
        for r in (1, 2, 3, 5, 8, 16):
            assert trules.replica_bucket(n, r) == jrules.replica_bucket(n, r)


def test_replica_devices_pick_one_device_per_batch_shard():
    devs = trules.replica_devices(tmesh.make_ci_mesh(8))  # data 4 x model 2
    assert [d.id for d in devs] == [0, 2, 4, 6]
    devs = trules.replica_devices(tmesh.make_production_mesh(multi_pod=True))
    assert len(devs) == 32 and [d.id for d in devs[:3]] == [0, 16, 32]
    model_only = host_mesh((4,), ("model",))
    assert [d.id for d in trules.replica_devices(model_only)] == [0]


def test_replica_bucket_ladder():
    p = BatchingPolicy(max_batch=64, replicas=8)
    assert p.buckets() == (8, 16, 32, 64)
    assert p.bucket_for(1) == 8
    assert p.bucket_for(9) == 16
    assert p.bucket_for(64) == 64
    assert BatchingPolicy(max_batch=64).buckets() == (1, 2, 4, 8, 16, 32, 64)
    assert BatchingPolicy(max_batch=4, replicas=8).buckets() == (4,)
    with pytest.raises(ValueError):
        BatchingPolicy(replicas=0)


def test_with_replicas_and_clamp_compose():
    p = BatchingPolicy(max_batch=256).clamped(64).with_replicas(8)
    assert p.max_batch == 64 and p.replicas == 8
    assert p.with_replicas(8) is p
    q = BatchingPolicy(max_batch=64).with_replicas(6)
    assert q.max_batch == 96 and q.buckets() == (6, 12, 24, 48, 96)
    for bucket in q.buckets():
        assert trules.replica_bucket(bucket, 6)[1] == bucket
    assert BatchingPolicy(max_batch=72).with_replicas(
        6, align_top=False).max_batch == 72


# ---------------------------------------------------------------------------
# launch/mesh.py
# ---------------------------------------------------------------------------
def test_production_meshes():
    pod = tmesh.make_production_mesh()
    assert list(pod.shape.items()) == [("data", 16), ("model", 16)]
    assert pod.devices.shape == (16, 16) and pod.size == 256
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert list(multi.shape.items()) == [("pod", 2), ("data", 16),
                                         ("model", 16)]
    assert multi.size == 512 and trules.dp_size(multi) == 32
    assert trules.is_host_emulated(multi)
    assert len({d.id for d in multi.devices.flat}) == 512


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8, 16])
def test_ci_mesh_shapes(n):
    mesh = tmesh.make_ci_mesh(n)
    d = max(1, n // 2)
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (d, n // d)
    if n == 1:  # the one shape the reference can build on this host
        assert dict(jlaunch_mesh.make_ci_mesh(1).shape) == dict(mesh.shape)


# ---------------------------------------------------------------------------
# replica health (tests/test_reliability.py's cases, and a seeded sequence)
# ---------------------------------------------------------------------------
def _pair(n, **policy):
    return (ReplicaHealthTracker(n, ReplicaHealthPolicy(**policy)),
            jhealth.ReplicaHealthTracker(
                n, jhealth.ReplicaHealthPolicy(**policy)))


def test_replica_eviction_after_consecutive_faults():
    for tr in _pair(4, evict_after=2, probe_every=100):
        tr.record_failure(1)
        assert tr.healthy_replicas() == [0, 1, 2, 3]
        tr.record_failure(1)
        assert tr.healthy_replicas() == [0, 2, 3]
        assert tr.snapshot()["evictions"] == 1
        assert all(c != 1 for c in tr.candidates(1))


def test_replica_success_resets_strikes():
    for tr in _pair(2, evict_after=2):
        tr.record_failure(0)
        tr.record_success(0)
        tr.record_failure(0)
        assert tr.healthy_replicas() == [0, 1]


def test_last_healthy_replica_never_evicted():
    t, j = _pair(2, evict_after=1)
    for tr in (t, j):
        tr.record_failure(0)
        assert tr.healthy_replicas() == [1]
        for _ in range(10):
            tr.record_failure(1)
        assert tr.healthy_replicas() == [1]
        assert 1 in tr.candidates(0)
    assert t.snapshot() == j.snapshot()


def test_evicted_replica_probed_and_readmitted():
    t, j = _pair(2, evict_after=1, probe_every=3)
    for tr in (t, j):
        tr.record_failure(0)
        assert tr.healthy_replicas() == [1]
        probed = [tr.candidates(0)[0] for _ in range(6)]
        assert 0 in probed
        tr.record_success(0)
        assert tr.healthy_replicas() == [0, 1]
        assert tr.snapshot()["readmissions"] == 1
    assert t.snapshot() == j.snapshot()


def test_health_policy_validation():
    for bad in (dict(evict_after=0), dict(probe_every=0)):
        with pytest.raises(ValueError):
            ReplicaHealthPolicy(**bad)
    with pytest.raises(ValueError):
        ReplicaHealthTracker(0)
    assert ReplicaHealthPolicy() == ReplicaHealthPolicy(2, 16)


@pytest.mark.parametrize("n,evict_after,probe_every,seed", [
    (1, 1, 1, 0), (2, 1, 3, 1), (4, 2, 5, 2), (8, 3, 2, 3)])
def test_tracker_matches_reference_over_seeded_sequence(n, evict_after,
                                                        probe_every, seed):
    """500 seeded candidates/record_success/record_failure calls through
    both trackers: equal answers and snapshots at every step."""
    t, j = _pair(n, evict_after=evict_after, probe_every=probe_every)
    rng = np.random.RandomState(seed)
    ops = rng.choice(["candidates", "success", "failure", "healthy"], 500,
                     p=[0.35, 0.2, 0.4, 0.05])
    for step, op in enumerate(ops):
        arg = int(rng.randint(0, 2 * n))
        if op == "candidates":
            got, want = t.candidates(arg), j.candidates(arg)
        elif op == "healthy":
            got = (t.all_healthy(), t.healthy_replicas())
            want = (j.all_healthy(), j.healthy_replicas())
        else:
            getattr(t, f"record_{op}")(arg % n)
            got = getattr(j, f"record_{op}")(arg % n)
            want = None
        assert got == want, (step, op, arg)
        assert t.snapshot() == j.snapshot(), (step, op, arg)
    snap = t.snapshot()
    assert snap["faults"] > 0 and snap["replicas"] == n
    if n > 1:
        assert snap["evictions"] > 0 and snap["probes"] > 0
