"""The port's mesh serving (``specialize_mesh``, the mesh half of the
serving plane, ``launch/serve.py --dp``) against the live JAX package's.

Everything runs on the host: meshes of 1, 2, 3 and 8 host replicas
(``make_host_mesh``), under ``spmd`` (replica by replica, each replica's
program on the host) and ``fused``, over artifacts compiled with
``device="cpu"`` (the kernels' plain versions).  The reference's mesh
artifacts need as many XLA devices as replicas, so its ``specialize_mesh``
runs in a subprocess under ``--xla_force_host_platform_device_count=8``
(as ``tests/test_elastic.py`` runs its meshes); in this process the
reference gives the single-device oracle.  The models are those of the
fleet tests (F=8, C=3): a CART tree, an MLP, a logistic model and an rbf
SVM fitted to the blobs.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_port_cases import fleet_blobs, fleet_params, jax_fleet_model
from repro import compile as jcompile
from repro import models as jmodels
from repro.sharding import rules as jrules
from repro_torch import compile as tcompile
from repro_torch.convert import model_from_params
from repro_torch.launch import serve as tserve_cli
from repro_torch.serve import (ArtifactCache, BatchingPolicy, FaultPlan,
                               FaultRule, InferenceService, faults)
from repro_torch.sharding import HostDevice, make_host_mesh
from repro_torch.sharding import rules as trules

KINDS = ("tree", "mlp", "logistic", "svm-rbf")
FORMATS = ("fxp16", "auto8", "flt")
REPLICAS = (1, 2, 3, 8)
STRATEGIES = ("spmd", "fused")
NS = (1, 3, 7, 33, 120)  # below, at and above the replica counts
WAIT = 60


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.uninstall()


@pytest.fixture(scope="module")
def blobs():
    return fleet_blobs()


@pytest.fixture(scope="module")
def params(blobs):
    """kind -> (extracted params, reference model)."""
    xtr, ytr = blobs[0], blobs[1]
    tree = jmodels.train_decision_tree(xtr, ytr, 3, max_depth=6)
    out = {"tree": (jcompile.get_lowering("tree").extract_params(tree), tree)}
    for kind in KINDS[1:]:
        p = fleet_params(kind, 0, xtr, ytr)[1]
        out[kind] = (p, jax_fleet_model(kind, p))
    return out


class Pairs:
    """(reference artifact, port artifact) per (kind, format, backend),
    compiled once: the reference on ``pallas`` (a tree on ``ref``: the
    reference's ``pallas`` tree compile raises on the installed JAX), the
    port on ``cuda`` (on the host), or both on ``ref``."""

    def __init__(self, params, x_cal):
        self.params, self.x_cal, self._memo = params, x_cal, {}

    def __call__(self, kind, fmt, backend="cuda"):
        key = (kind, fmt, backend)
        if key not in self._memo:
            p, jmodel = self.params[kind]
            cal = self.x_cal if fmt.startswith("auto") else None
            jbackend = ("ref" if backend == "ref" or kind == "tree"
                        else "pallas")
            jart = jcompile.compile(
                jmodel, jcompile.Target(number_format=fmt, backend=jbackend),
                calibration=cal)
            tart = self.port(kind, fmt, backend)
            self._memo[key] = (jart, tart)
        return self._memo[key]

    def port(self, kind, fmt, backend="cuda", **target):
        cal = self.x_cal if fmt.startswith("auto") else None
        return tcompile.compile(
            self.model(kind),
            tcompile.Target(number_format=fmt, backend=backend, **target),
            calibration=cal, device="cpu")

    def model(self, kind):
        return model_from_params(kind, self.params[kind][0])


@pytest.fixture(scope="module")
def pairs(params, blobs):
    return Pairs(params, blobs[0])


def _same(got, want, what):
    np.testing.assert_array_equal(got[0], want[0], err_msg=str(what))
    assert got[1] == want[1], (what, got[1], want[1])


# ---------------------------------------------------------------------------
# labels and padding-free stats: mesh == single device == the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_artifacts_match_single_device_and_reference(pairs, blobs, kind,
                                                          fmt):
    xte = blobs[2]
    jart, tart = pairs(kind, fmt)
    want = {n: jart.predict_with_stats(xte[:n]) for n in NS}
    for n in NS:
        _same(tart.predict_with_stats(xte[:n]), want[n], ("single", n))
    if (kind, fmt) != ("svm-rbf", "auto8"):
        # the labels carry information (an 8-bit kernel domain holds the
        # inputs and the kernel values in one format: the calibrated rbf
        # SVM's labels come out constant in both packages)
        assert len(np.unique(want[NS[-1]][0])) > 1
    for r in REPLICAS:
        for strategy in STRATEGIES:
            mesh_art = tart.specialize_mesh(make_host_mesh(r), strategy)
            assert (mesh_art.replicas, mesh_art.mesh_strategy) == (r, strategy)
            assert (mesh_art.replica_health is None) == (strategy == "spmd")
            assert mesh_art.device == tart.device
            for n in NS:
                _same(mesh_art.predict_with_stats(xte[:n]), want[n],
                      (r, strategy, n))


def test_auto_strategy_and_descriptor(pairs):
    _, tart = pairs("tree", "fxp16")
    mesh = make_host_mesh(3)
    assert tcompile.resolve_mesh_strategy(mesh) == "fused"
    assert tcompile.resolve_mesh_strategy(mesh, "spmd") == "spmd"
    art = tart.specialize_mesh(mesh)
    assert art.mesh_strategy == "fused" and art.mesh is mesh
    assert art.mesh_key == ((("data", 3),), "cpu", (0, 1, 2), "fused")
    assert tart.mesh_key is None and tart.replicas == 1
    assert tcompile.mesh_descriptor(None, "fused") is None
    # the reference's descriptor of the same layout has the same form
    jmesh = jrules.make_serving_mesh(1)
    assert jcompile.artifact.mesh_descriptor(jmesh, "fused") == \
        tcompile.mesh_descriptor(make_host_mesh(1), "fused")


def test_spmd_replicas_issue_their_own_shards(pairs, blobs, monkeypatch):
    """spmd calls each replica's _predict (never predict: no wait between
    replicas) once per call on its own shard; fused untracked calls the
    artifact's predict once on the whole padded batch."""
    xte = blobs[2]
    _, tart = pairs("mlp", "fxp16")
    calls = []

    def spy(x):
        calls.append(tuple(x.shape))
        return inner(x)

    inner = tart._predict
    monkeypatch.setattr(tart, "_predict", spy)
    spmd = tart.specialize_mesh(make_host_mesh(3), "spmd")
    fused = tart.specialize_mesh(make_host_mesh(3), "fused")
    for art in (spmd, fused):  # the first call also probes a pad row
        art.predict(xte[:7])
    calls.clear()
    spmd.predict(xte[:7])
    assert calls == [(4, 8)] * 3  # 7 rows -> 3 x pow2ceil(3) = 12
    calls.clear()
    fused.predict(xte[:7])
    assert calls == [(12, 8)]


# ---------------------------------------------------------------------------
# rejections
# ---------------------------------------------------------------------------
def test_specialize_mesh_rejections(pairs):
    from repro_torch.configs import get_config
    from repro_torch.lm import model as M

    _, tart = pairs("tree", "fxp16")
    mesh = make_host_mesh(2)
    sharded = tart.specialize_mesh(mesh)
    with pytest.raises(ValueError, match="already specialized"):
        sharded.specialize_mesh(make_host_mesh(2))
    with pytest.raises(ValueError, match="strategy") as terr:
        tart.specialize_mesh(mesh, "warp")
    jart = pairs("tree", "fxp16")[0]
    with pytest.raises(ValueError, match="strategy") as jerr:
        jart.specialize_mesh(jrules.make_serving_mesh(1), "warp")
    assert str(terr.value) == str(jerr.value)
    emit = pairs.port("tree", "fxp16", backend="emit")
    with pytest.raises(TypeError, match="emit"):
        emit.specialize_mesh(mesh)
    cfg = get_config("qwen2-0.5b").reduced()
    lm = tcompile.compile(
        tcompile.LMModel(cfg, M.init_params(
            cfg, torch.Generator().manual_seed(0))),
        tcompile.Target(), device="cpu")
    with pytest.raises(TypeError, match="classifier"):
        lm.specialize_mesh(mesh)


# ---------------------------------------------------------------------------
# fixed-batch capacity, the mesh-level pretune ladder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("r", [1, 3])
def test_fixed_batch_mesh_capacity_scales(pairs, blobs, strategy, r):
    xte = blobs[2]
    single = pairs("mlp", "fxp16")[1]
    fixed = pairs.port("mlp", "fxp16", batch_policy="fixed", batch_size=8)
    sharded = fixed.specialize_mesh(make_host_mesh(r), strategy)
    assert sharded.max_supported_batch == 8 * r
    for n in (1, 5, 8 * r):
        _same(sharded.predict_with_stats(xte[:n]),
              single.predict_with_stats(xte[:n]), n)
    with pytest.raises(ValueError, match="mesh capacity") as terr:
        sharded.predict(xte[:8 * r + 1])
    if r == 1:  # the reference's own message on its one CPU device
        jfixed = jcompile.compile(
            pairs.params["mlp"][1],
            jcompile.Target(number_format="fxp16", backend="xla",
                            batch_policy="fixed", batch_size=8))
        with pytest.raises(ValueError) as jerr:
            jfixed.specialize_mesh(jrules.make_serving_mesh(1),
                                   strategy).predict(xte[:9])
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("r", [1, 3, 8])
def test_mesh_pretune_walks_replica_ladder(pairs, blobs, strategy, r):
    """pretune walks replicas x the pow2 shard ladder (up to 64 a replica,
    or the fixed batch), so every replica's shard shape is warmed."""
    _, tart = pairs("mlp", "fxp16")
    sharded = tart.specialize_mesh(make_host_mesh(r), strategy)
    seen = []
    inner = sharded._predict

    def record(x):
        seen.append(len(x))
        return inner(x)

    sharded._predict = record
    assert sharded.pretune(blobs[2][0]) is sharded
    assert seen == [r * 2 ** k for k in range(7)]  # r .. 64 r
    for b in seen:
        assert trules.replica_bucket(b, r) == (b // r, b)
    fixed = pairs.port("mlp", "fxp16", batch_policy="fixed", batch_size=8)
    sharded = fixed.specialize_mesh(make_host_mesh(r), strategy)
    seen, inner = [], sharded._predict
    sharded._predict = record
    sharded.pretune(blobs[2][:2])
    assert seen == [r, 2 * r, 4 * r, 8 * r]


# ---------------------------------------------------------------------------
# the cache, register, the scheduler
# ---------------------------------------------------------------------------
def test_cache_keys_mesh_and_single_separately(pairs):
    cache = ArtifactCache()
    model = pairs.model("tree")
    t = tcompile.Target(number_format="fxp16")
    mesh = make_host_mesh(2)
    single = cache.get_or_compile(model, t, device="cpu")
    sharded = cache.get_or_compile(model, t, mesh=mesh, device="cpu")
    assert single is not sharded
    assert cache.stats() == {"entries": 2, "hits": 0, "misses": 2,
                             "capacity": None}
    assert cache.get_or_compile(model, t, mesh=make_host_mesh(2),
                                device="cpu") is sharded
    assert cache.stats()["hits"] == 1
    assert single.mesh_key is None
    assert sharded.mesh_key is not None
    assert sharded.cache_key != single.cache_key
    spmd = cache.get_or_compile(model, t, mesh=mesh, strategy="spmd",
                                device="cpu")
    assert spmd is not sharded and spmd.mesh_strategy == "spmd"
    # two same-shaped meshes over disjoint devices must not alias
    m1 = trules.make_serving_mesh(devices=[HostDevice(0), HostDevice(1)])
    m2 = trules.make_serving_mesh(devices=[HostDevice(2), HostDevice(3)])
    a = cache.get_or_compile(model, t, mesh=m1, device="cpu")
    b = cache.get_or_compile(model, t, mesh=m2, device="cpu")
    assert a is sharded and b is not a and a.mesh_key != b.mesh_key
    assert cache.stats()["misses"] == 4


def test_register_rejects_mismatched_mesh(pairs):
    svc = InferenceService(device="cpu")
    try:
        _, tart = pairs("tree", "fxp16")
        sharded = tart.specialize_mesh(make_host_mesh(2), "fused")
        with pytest.raises(ValueError, match="already specialized"):
            svc.register("x", artifact=sharded, mesh=make_host_mesh(2),
                         mesh_strategy="spmd")
        with pytest.raises(ValueError, match="already specialized"):
            svc.register("x", artifact=sharded, mesh=make_host_mesh(3))
        ep = svc.register("y", artifact=sharded, mesh=make_host_mesh(2),
                          mesh_strategy="fused")
        assert ep.artifact is sharded
        ep = svc.register("z", artifact=tart, mesh=make_host_mesh(3))
        assert ep.artifact.replicas == 3 and ep.policy.replicas == 3
    finally:
        svc.close()


def test_service_register_with_mesh_dedupes(pairs):
    svc = InferenceService(device="cpu")
    try:
        t = tcompile.Target(number_format="fxp16")
        mesh = make_host_mesh(2)
        a = svc.register("main", pairs.model("tree"), t, mesh=mesh)
        b = svc.register("canary", pairs.model("tree"), t, mesh=mesh)
        c = svc.register("single", pairs.model("tree"), t)
        assert a.artifact is b.artifact and c.artifact is not a.artifact
        assert svc.stats()["_cache"]["hits"] == 1
    finally:
        svc.close()


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("r", [2, 3, 8])
def test_service_mesh_endpoint_parity(pairs, blobs, strategy, r):
    """Micro-batched ragged traffic through a mesh endpoint returns the
    single-device artifact's labels; every dispatched bucket is a multiple
    of the replica count; a fused endpoint's snapshot has replica_health."""
    xte = blobs[2]
    _, tart = pairs("mlp", "auto8")
    want = tart.predict(xte)
    buckets = []
    svc = InferenceService(device="cpu")
    try:
        ep = svc.register("m", artifact=tart.specialize_mesh(
            make_host_mesh(r), strategy),
            policy=BatchingPolicy(max_batch=16 * r, max_wait_ms=5))
        assert ep.policy.replicas == r
        orig = ep.batcher._on_batch

        def spy(n_req, n_rows, bucket, lats, **kw):
            buckets.append(bucket)
            orig(n_req, n_rows, bucket, lats, **kw)

        ep.batcher._on_batch = spy
        futs, off = [], 0
        for size in (1, 3, 8, 5, 2) * 8:
            if off + size > len(xte):
                break
            futs.append((off, size, svc.submit("m", xte[off:off + size])))
            off += size
        for o, s, f in futs:
            np.testing.assert_array_equal(f.result(timeout=WAIT),
                                          want[o:o + s])
        snap = svc.stats()["m"]
        if strategy == "fused":
            assert snap["replica_health"] == {
                "replicas": r, "healthy": list(range(r)), "evicted": [],
                "faults": 0, "evictions": 0, "readmissions": 0, "probes": 0}
        else:
            assert "replica_health" not in snap
    finally:
        svc.close()
    assert buckets and all(b % r == 0 for b in buckets), buckets


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------
FAILOVER_ROWS, FAILOVER_CALLS = 16, 8


def _failover_run(sharded, x):
    """Replica 0 faults twice (evicted after two consecutive faults), then
    succeeds: (labels of each call, the tracker's snapshot)."""
    plan = FaultPlan([FaultRule(site="mesh.replica", match="0",
                                transient=True, count=2)])
    labels = []
    with faults.inject(plan):
        for _ in range(FAILOVER_CALLS):
            labels.append(sharded.predict(x))
    return labels, sharded.replica_health.snapshot()


@pytest.mark.parametrize("kind", ["tree", "mlp"])
def test_mesh_replica_fault_failover_is_bit_identical(pairs, blobs, kind):
    x = blobs[2][:FAILOVER_ROWS]
    _, tart = pairs(kind, "fxp16")
    golden = tart.predict(x)
    sharded = tart.specialize_mesh(make_host_mesh(4), "fused")
    labels, snap = _failover_run(sharded, x)
    for got in labels:
        np.testing.assert_array_equal(got, golden)
    assert snap["faults"] == 2 and snap["evictions"] == 1
    assert snap["probes"] >= 1 and snap["readmissions"] == 1
    assert snap["healthy"] == [0, 1, 2, 3] and snap["evicted"] == []
    np.testing.assert_array_equal(sharded.predict(x), golden)


def test_last_replica_fault_surfaces(pairs, blobs):
    """With one replica there is no failover: the fault reaches the
    caller."""
    _, tart = pairs("tree", "fxp16")
    sharded = tart.specialize_mesh(make_host_mesh(1), "fused")
    plan = FaultPlan([FaultRule(site="mesh.replica", transient=True)])
    with faults.inject(plan):
        with pytest.raises(faults.TransientInjectedFault):
            sharded.predict(blobs[2][:4])
    assert sharded.replica_health.snapshot()["healthy"] == [0]


# ---------------------------------------------------------------------------
# launch/serve.py --dp
# ---------------------------------------------------------------------------
def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve_cli.main(argv)
    return out.getvalue()


def test_launch_serve_dp_arguments():
    """--dp N on the host: N host replicas with replica-aware buckets (64 a
    replica); --dp 1 hosts the single-device artifact.  (More replicas than
    cards on the card: tests/test_torch_serve_net.py.)"""
    base = ["--classifier", "logistic", "--device", "cpu", "--requests", "64"]
    out = _cli(base + ["--dp", "3"])
    assert "replicas=3 (fused)" in out
    assert "buckets=(3, 6, 12, 24, 48, 96, 192)" in out and "64 rows" in out
    out = _cli(base)
    assert "replicas=1," in out and "buckets=(1, 2, 4, 8, 16, 32, 64)" in out


# ---------------------------------------------------------------------------
# the reference's own specialize_mesh on 8 emulated XLA devices
# ---------------------------------------------------------------------------
_REFERENCE_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    sys.path.insert(0, "tests")
    import numpy as np
    from _torch_port_cases import fleet_blobs, fleet_params, jax_fleet_model
    from repro import compile as jc, models as jm
    from repro.serve import FaultPlan, FaultRule, faults
    from repro.sharding.rules import make_serving_mesh

    ns = json.loads(os.environ["MESH_NS"])
    rows, calls = json.loads(os.environ["MESH_FAILOVER"])
    xtr, ytr, xte, _ = fleet_blobs()
    mesh = make_serving_mesh(8)
    models = {"tree": jm.train_decision_tree(xtr, ytr, 3, max_depth=6)}
    for kind in ("mlp", "logistic", "svm-rbf"):
        models[kind] = jax_fleet_model(kind, fleet_params(kind, 0, xtr, ytr)[1])
    out = {}
    for kind, model in models.items():
        art = jc.compile(model, jc.Target(number_format="fxp16",
                                          backend="xla"))
        for strategy in ("spmd", "fused"):
            sharded = art.specialize_mesh(mesh, strategy)
            assert sharded.replicas == 8
            for n in ns:
                lab, st = sharded.predict_with_stats(xte[:n])
                out[f"{kind} {strategy} {n}"] = [lab.tolist(), st]
    fused = jc.compile(models["tree"], jc.Target(number_format="fxp16",
                                                 backend="xla")
                       ).specialize_mesh(mesh, "fused")
    plan = FaultPlan([FaultRule(site="mesh.replica", match="0",
                                transient=True, count=2)])
    labels = []
    with faults.inject(plan):
        for _ in range(calls):
            labels.append(fused.predict(xte[:rows]).tolist())
    out["failover"] = [labels, fused.replica_health.snapshot()]
    print("RESULT " + json.dumps(out))
""")


def test_eight_replicas_match_reference_specialize_mesh(pairs, blobs):
    """The reference's specialize_mesh (spmd and fused) on 8 emulated XLA
    devices against the port's 8-replica host mesh on the same rows: labels
    and stats bit for bit (the port's ``ref`` route, which the reference's
    ``xla`` route jits; its ``cuda`` route's labels too), and the same
    failover sequence leaves equal labels and tracker snapshots."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               MESH_NS=json.dumps(NS),
               MESH_FAILOVER=json.dumps([FAILOVER_ROWS, FAILOVER_CALLS]))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    ref = json.loads(line[-1][len("RESULT "):])
    xte = blobs[2]
    mesh = make_host_mesh(8)
    for kind in KINDS:
        on_ref = pairs.port(kind, "fxp16", backend="ref")
        on_cuda = pairs(kind, "fxp16")[1]
        for strategy in STRATEGIES:
            a = on_ref.specialize_mesh(mesh, strategy)
            b = on_cuda.specialize_mesh(mesh, strategy)
            for n in NS:
                labels, stats = ref[f"{kind} {strategy} {n}"]
                got = a.predict_with_stats(xte[:n])
                assert got[0].tolist() == labels, (kind, strategy, n)
                assert got[1] == stats, (kind, strategy, n)
                assert b.predict(xte[:n]).tolist() == labels
    labels, snap = _failover_run(
        pairs("tree", "fxp16")[1].specialize_mesh(mesh, "fused"),
        xte[:FAILOVER_ROWS])
    assert [lab.tolist() for lab in labels] == ref["failover"][0]
    assert snap == ref["failover"][1]
