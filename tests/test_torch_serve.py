"""The port's serving plane against the live JAX package's.

The port's ``repro_torch.serve`` runs here on the host
(``InferenceService(device="cpu")``, the kernels' plain versions); the
reference's ``repro.serve`` runs its ``pallas`` artifacts in interpret
mode.  At the fleet tests' sizes (F=8, C=3, E=3):

* the same request stream through both services, fleets enabled, gives
  equal responses;
* batcher buckets and padding, and the staging allocations' plateau;
* deadlines, retry, poison bisection and the circuit breaker, on the
  injectable clocks the reference's tests use;
* degradation to an ``auto8`` fallback, in and out of a fleet;
* ``ArtifactCache`` dedupe and single flight;
* ``enable_fleet`` with mixed kinds (the tree is built on the port only:
  the reference's ``pallas`` tree compile raises on the installed JAX);
* lifecycle: ``close`` resolves every future.

Threaded tests bound every wait.
"""

import math
import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from _torch_port_cases import compile_pair, fleet_blobs, fleet_params
from repro import serve as jserve
from repro_torch import compile as tcompile
from repro_torch.convert import model_from_params
from repro_torch.models import train_decision_tree
from repro_torch.serve import (ArtifactCache, BatchingPolicy, BreakerPolicy,
                               CircuitOpenError, DeadlineExceeded,
                               DegradationPolicy, DispatchError, FaultPlan,
                               FaultRule, InferenceService, MicroBatcher,
                               RetryPolicy, TransientError, faults)
from repro_torch.serve.batching import StagingBuffer, _Request

E = 3
WAIT = 60  # seconds any one future may take


class FakeClock:
    """Injectable monotonic clock shared across threads."""

    def __init__(self, t=0.0):
        self._t = t
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            return self._t

    def advance(self, dt):
        with self._lock:
            self._t += dt


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.uninstall()


@pytest.fixture(scope="module")
def blobs():
    return fleet_blobs()


@pytest.fixture(scope="module")
def members(blobs):
    """name -> (kind, params, number_format, calibration) of the endpoints
    both services host: three calibrated MLPs and two rbf SVMs."""
    xtr, ytr = blobs[0], blobs[1]
    out = {}
    for s in range(E):
        out[f"m{s}"] = (*fleet_params("mlp", s, xtr, ytr), "auto16",
                        xtr[40 * s:120 + 40 * s])
    for s in range(2):
        out[f"r{s}"] = (*fleet_params("svm-rbf", s, xtr, ytr), "fxp16", None)
    return out


@pytest.fixture(scope="module")
def pairs(members):
    return {n: compile_pair(kind, p, fmt, calibration=cal)
            for n, (kind, p, fmt, cal) in members.items()}


def _policy(**kw):
    return BatchingPolicy(**{"max_batch": 4, "max_wait_ms": 2, **kw})


def _port_service(pairs, names=None):
    svc = InferenceService(device="cpu")
    for n in names or pairs:
        svc.register(n, artifact=pairs[n][1], policy=_policy())
    return svc


# ---------------------------------------------------------------------------
# the same request stream through both services
# ---------------------------------------------------------------------------
def test_same_stream_same_responses_as_reference(pairs, blobs):
    xte = blobs[2]
    stream = [(n, i, 1 + (i * 7 + k) % 4)
              for i in range(0, 48, 2) for k, n in enumerate(sorted(pairs))]
    responses = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            svc = jserve.InferenceService()
            for n in pairs:
                svc.register(n, artifact=pairs[n][0],
                             policy=jserve.BatchingPolicy(max_batch=4,
                                                          max_wait_ms=2))
        else:
            svc = _port_service(pairs)
        try:
            formed = svc.enable_fleet()
            assert sorted(map(sorted, formed.values())) == [
                ["m0", "m1", "m2"], ["r0", "r1"]]
            futs = [svc.submit(n, xte[i:i + k]) for n, i, k in stream]
            responses[pkg] = [f.result(timeout=WAIT) for f in futs]
            stats = svc.stats()
            assert all(f["stacked_dispatches"] >= 1
                       and f["stack_fallbacks"] == 0
                       for f in stats["_fleets"])
        finally:
            svc.close()
    for (n, i, k), a, b in zip(stream, responses["jax"], responses["port"]):
        np.testing.assert_array_equal(a, b, err_msg=f"{n} rows {i}:{i + k}")
        np.testing.assert_array_equal(b, pairs[n][1].predict(xte[i:i + k]))


# ---------------------------------------------------------------------------
# batcher: buckets, padding, staging
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(max_batch=64), dict(max_batch=48),
                                dict(max_batch=8, bucketing="exact"),
                                dict(max_batch=5)])
def test_bucket_ladder_equals_reference(kw):
    port, ref = BatchingPolicy(**kw), jserve.BatchingPolicy(**kw)
    assert port.buckets() == ref.buckets()
    for n in range(1, kw["max_batch"] + 1):
        assert port.bucket_for(n) == ref.bucket_for(n)
    assert port.clamped(4) == BatchingPolicy(**{**kw, "max_batch": min(
        4, kw["max_batch"])})


def test_padding_and_staging_plateau(pairs, blobs):
    art, xte = pairs["m0"][1], blobs[2]
    seen = []

    def predict(x):
        x = np.asarray(x)
        seen.append(x.shape[0])
        if x.shape[0] > 1:  # padding rows are zeros
            assert np.isfinite(x).all()
        return art.predict(x)

    golden = art.predict(xte)
    mb = MicroBatcher(predict, _policy(max_batch=8))
    try:
        def drive():
            futs = [(i, mb.submit(xte[i:i + 1 + i % 3])) for i in range(40)]
            for i, f in futs:
                np.testing.assert_array_equal(f.result(timeout=WAIT),
                                              golden[i:i + 1 + i % 3])

        drive()
        stats = mb.assembly_stats()
        assert 0 < stats["n_staging_allocs"] <= 2 * len(
            mb.policy.buckets())
        drive()
        assert mb.assembly_stats()["n_staging_allocs"] == \
            stats["n_staging_allocs"]
        assert mb.assembly_stats()["n_zero_copy_assemblies"] > \
            stats["n_zero_copy_assemblies"]
        assert set(seen) <= set(mb.policy.buckets())
    finally:
        mb.close()


def test_staging_is_pinned_only_for_the_card(pairs):
    for device in (None, torch.device("cpu")):
        buf = StagingBuffer((4, 8), np.float32, device)
        assert buf.handed is buf.view and isinstance(buf.view, np.ndarray)
        assert buf.device is None  # not pinned
        buf.release()  # no event on the host
        assert buf.acquire() is buf.view
    buf = StagingBuffer((2,), np.dtype(object), torch.device("cuda"))
    assert buf.handed is buf.view and buf.device is None  # no torch dtype
    svc = _port_service(pairs, ["m0"])
    try:
        assert svc.endpoint("m0").batcher.device == torch.device("cpu")
    finally:
        svc.close()


@pytest.mark.parametrize("fails", [False, True])
def test_every_staged_dispatch_releases_its_buffer(monkeypatch, fails):
    # A pinned buffer's event is recorded after each dispatch from it,
    # whether predict returned or raised, and waited on before the buffer
    # is written again.
    events = []
    monkeypatch.setattr(StagingBuffer, "release",
                        lambda self: events.append(("release", id(self))))
    monkeypatch.setattr(StagingBuffer, "acquire",
                        lambda self: events.append(("acquire", id(self)))
                        or self.view)

    def predict(x):
        if fails:
            raise RuntimeError("device fault")
        return np.asarray(x)[:, 0]

    mb = MicroBatcher(predict, BatchingPolicy(max_batch=4, warmup=False))
    try:
        reqs = [_Request(np.full((1, 2), i, np.float32), Future(), 0.0)
                for i in range(3)]
        if fails:
            with pytest.raises(RuntimeError):
                mb._dispatch_once(reqs)
        else:
            mb._dispatch_once(reqs)
            assert [float(r.future.result(timeout=0)[0]) for r in reqs] == \
                [0.0, 1.0, 2.0]
        kinds = [k for k, _ in events]
        assert kinds == ["acquire", "release"]
        assert events[0][1] == events[1][1]
    finally:
        mb.close(drain=False)


# ---------------------------------------------------------------------------
# deadlines, retry, bisection, breaker
# ---------------------------------------------------------------------------
def test_expired_in_queue_never_dispatched():
    clock = FakeClock()
    gate, entered = threading.Event(), threading.Event()
    dispatched = []

    def predict(x):
        entered.set()
        gate.wait(5.0)
        dispatched.append(np.array(x[:, 0]))
        return x[:, 0]

    mb = MicroBatcher(predict, BatchingPolicy(max_batch=8, warmup=False),
                      clock=clock, sleep=lambda s: None)
    try:
        blocker = mb.submit(np.array([[0.0]], np.float32))
        assert entered.wait(5.0)
        doomed = mb.submit(np.array([[7.0]], np.float32), timeout_s=5.0)
        alive = mb.submit(np.array([[3.0]], np.float32))
        clock.advance(10.0)
        gate.set()
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=5)
        assert alive.result(timeout=5) == [3.0]
        assert blocker.result(timeout=5) == [0.0]
        assert 7.0 not in np.concatenate(dispatched)
        assert mb.n_expired == 1
    finally:
        gate.set()
        mb.close(drain=False)


def test_transient_failures_retry_with_backoff():
    sleeps, attempts = [], []

    def predict(x):
        attempts.append(0)
        if len(attempts) <= 2:
            raise TransientError("flaky device")
        return x[:, 0]

    mb = MicroBatcher(predict, BatchingPolicy(max_batch=4, warmup=False),
                      retry=RetryPolicy(max_attempts=3, backoff_base_s=0.25,
                                        multiplier=2.0, backoff_max_s=10.0,
                                        jitter=0.0),
                      sleep=sleeps.append)
    try:
        assert mb.submit(np.array([[5.0]], np.float32)).result(
            timeout=5) == [5.0]
        assert sleeps == [0.25, 0.5]
        assert mb.n_retries == 2 and mb.n_failed_requests == 0
    finally:
        mb.close(drain=False)


@pytest.mark.parametrize("n", [2, 8, 16])
def test_bisection_isolates_a_poison_request(pairs, blobs, n):
    art, xte = pairs["m1"][1], blobs[2]
    poison = np.float32(1e30)
    calls = []

    def predict(x):
        calls.append(x.shape[0])
        if (np.asarray(x) >= poison).any():
            raise RuntimeError("poison row")
        return art.predict(x)

    golden = art.predict(xte[:n])
    mb = MicroBatcher(predict, BatchingPolicy(max_batch=n, warmup=False))
    try:
        reqs = [_Request(xte[i:i + 1], Future(), 0.0) for i in range(n - 1)]
        reqs.insert(n // 3, _Request(np.full_like(xte[:1], poison), Future(),
                                     0.0))
        mb._serve(list(reqs))
        with pytest.raises(DispatchError) as exc:
            reqs[n // 3].future.result(timeout=0)
        assert exc.value.isolated
        got = [r.future.result(timeout=0) for i, r in enumerate(reqs)
               if i != n // 3]
        np.testing.assert_array_equal(np.concatenate(got), golden[:n - 1])
        assert len(calls) <= 2 * int(math.log2(n)) + 1
    finally:
        mb.close(drain=False)


def test_endpoint_breaker_opens_and_fails_fast(pairs, blobs):
    xte = blobs[2]
    svc = _port_service(pairs, ["m2"])
    try:
        ep = svc.enable_breaker("m2", BreakerPolicy(consecutive_failures=2,
                                                    open_s=3600.0))
        with faults.inject(FaultPlan([FaultRule("endpoint.dispatch",
                                                transient=False)])):
            for i in range(2):
                with pytest.raises(DispatchError):
                    ep.submit(xte[i:i + 1]).result(timeout=WAIT)
        assert ep.breaker.state == ep.breaker.OPEN
        with pytest.raises(CircuitOpenError):
            ep.submit(xte[:1])
        assert svc.stats()["m2"]["breaker"]["state"] == "open"
    finally:
        svc.close()


def test_injected_transient_faults_retry_to_golden(pairs, blobs):
    xte = blobs[2]
    art = pairs["m0"][1]
    svc = InferenceService(device="cpu")
    try:
        ep = svc.register("m0", artifact=art, policy=_policy(),
                          retry=RetryPolicy(max_attempts=3,
                                            backoff_base_s=0.0, jitter=0.0))
        plan = FaultPlan([FaultRule("endpoint.dispatch", every=2)], seed=1)
        with faults.inject(plan) as inj:
            got = [ep.submit(xte[i:i + 1]).result(timeout=WAIT)[0]
                   for i in range(6)]
            assert inj.stats()["fired_total"] >= 1
        np.testing.assert_array_equal(got, art.predict(xte[:6]))
        assert svc.stats()["m0"]["dispatch_retries"] >= 1
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# degradation
# ---------------------------------------------------------------------------
def test_degraded_member_serves_auto8_fallback(pairs, members, blobs):
    xtr, xte = blobs[0], blobs[2]
    kind, params, _, _ = members["m0"]
    svc = _port_service(pairs, ["m0", "m1", "m2"])
    try:
        svc.enable_fleet()
        ep = svc.enable_degradation(
            "m0", model=model_from_params(kind, params),
            target=tcompile.Target(number_format="auto8", backend="cuda"),
            calibration=xtr, policy=DegradationPolicy(min_hold_s=3600.0))
        assert ep.fallback.target.number_format == "auto8"
        ep.governor.observe(ep.governor.policy.queue_high, None)
        assert ep.degraded
        want0 = ep.fallback.predict(xte)
        want1 = pairs["m1"][1].predict(xte)
        futs = [(i, svc.submit("m0", xte[i:i + 1]),
                 svc.submit("m1", xte[i:i + 1])) for i in range(16)]
        for i, f0, f1 in futs:
            assert f0.result(timeout=WAIT)[0] == want0[i]
            assert f0.batch_meta["degraded"] is True
            assert f0.batch_meta["number_format"] == "auto8"
            assert f1.result(timeout=WAIT)[0] == want1[i]
        assert svc.stats()["m0"]["degraded_rows"] >= 16
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# the artifact cache
# ---------------------------------------------------------------------------
def test_cache_dedupes_and_keys_the_device(members):
    kind, params, _, _ = members["r0"]
    cache = ArtifactCache()
    target = tcompile.Target(number_format="fxp16", backend="cuda")
    a = cache.get_or_compile(model_from_params(kind, params), target,
                             device="cpu")
    b = cache.get_or_compile(model_from_params(kind, params), target,
                             device="cpu")
    assert a is b and cache.stats()["misses"] == 1
    assert cache.stats()["hits"] == 1
    assert a.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        cache.get_or_compile(model_from_params(kind, params), target,
                             mesh=object(), device="cpu")


def test_cache_single_flight_under_racing_compiles(members, monkeypatch):
    import repro_torch.serve.cache as cache_mod

    kind, params, _, _ = members["r1"]
    calls, gate = [], threading.Event()
    real = cache_mod.compile_from_params

    def slow_compile(*a, **kw):
        calls.append(0)
        gate.wait(5.0)
        return real(*a, **kw)

    monkeypatch.setattr(cache_mod, "compile_from_params", slow_compile)
    cache = ArtifactCache()
    target = tcompile.Target(number_format="fxp16", backend="cuda")
    out = []
    threads = [threading.Thread(target=lambda: out.append(
        cache.get_or_compile(model_from_params(kind, params), target,
                             device="cpu"))) for _ in range(6)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    assert len(out) == 6 and all(a is out[0] for a in out)
    assert len(calls) == 1


def test_get_or_stack_dedupes(pairs):
    cache = ArtifactCache()
    arts = [pairs[f"m{s}"][1] for s in range(E)]
    assert cache.get_or_stack(arts) is cache.get_or_stack(arts)


# ---------------------------------------------------------------------------
# enable_fleet with mixed kinds; lifecycle; what is not ported
# ---------------------------------------------------------------------------
def test_enable_fleet_mixed_kinds(pairs, members, blobs):
    xtr, ytr, xte = blobs[0], blobs[1], blobs[2]
    tree = tcompile.compile(train_decision_tree(xtr, ytr, 3, max_depth=4),
                            tcompile.Target(number_format="fxp16",
                                            backend="cuda"), device="cpu")
    kind, params, _, _ = members["m0"]
    on_ref = tcompile.compile(model_from_params(kind, params),
                              tcompile.Target(number_format="fxp16",
                                              backend="ref"), device="cpu")
    svc = _port_service(pairs, ["m0", "m1", "m2"])
    try:
        svc.register("tree", artifact=tree, policy=_policy())
        svc.register("solo-ref", artifact=on_ref, policy=_policy())
        formed = svc.enable_fleet()
        assert list(formed.values()) == [["m0", "m1", "m2"]]
        names = ["m0", "m1", "m2", "tree", "solo-ref"]
        golden = {n: svc.endpoint(n).artifact.predict(xte) for n in names}
        futs = [(n, i, svc.submit(n, xte[i:i + 1]))
                for i in range(32) for n in names]
        for n, i, f in futs:
            assert f.result(timeout=WAIT)[0] == golden[n][i], n
        snap = svc.stats()
        fleet = snap["_fleets"][0]
        assert fleet["members"] == ["m0", "m1", "m2"]
        assert fleet["stacked_dispatches"] >= 1
        assert fleet["stack_fallbacks"] == 0
        assert snap["tree"]["batches"] >= 1 and \
            snap["tree"]["coalesced_batches"] == 0
        assert snap["solo-ref"]["batches"] >= 1
        with pytest.raises(RuntimeError, match="fleet"):
            svc.unregister("m0")
    finally:
        svc.close()


def test_failed_stacked_launch_releases_staging(pairs, blobs, monkeypatch):
    # A stacked launch that raises is re-served by each member's own path,
    # and the staging buffer it was handed is released all the same.
    from repro_torch.compile.fleet import FleetStack

    xte = blobs[2]
    counts = {"acquire": 0, "release": 0}
    acquire, release = StagingBuffer.acquire, StagingBuffer.release

    def counted(name, fn):
        def wrapped(self):
            counts[name] += 1
            return fn(self)
        return wrapped

    monkeypatch.setattr(StagingBuffer, "acquire", counted("acquire", acquire))
    monkeypatch.setattr(StagingBuffer, "release", counted("release", release))

    def broken(self, x):
        raise RuntimeError("stacked launch failed")

    monkeypatch.setattr(FleetStack, "predict_device", broken)
    names = ["m0", "m1", "m2"]
    svc = _port_service(pairs, names)
    try:
        svc.enable_fleet()
        futs = [(n, i, svc.submit(n, xte[i:i + 1]))
                for i in range(16) for n in names]
        for n, i, f in futs:
            assert f.result(timeout=WAIT)[0] == pairs[n][1].predict(
                xte[i:i + 1])[0], n
        fleet = svc.stats()["_fleets"][0]
    finally:
        svc.close()
    assert fleet["stacked_dispatches"] == 0
    assert fleet["stack_fallbacks"] >= 1
    assert counts["acquire"] >= 1 and counts["acquire"] == counts["release"]


def test_close_resolves_every_future(pairs, blobs):
    xte = blobs[2]
    svc = _port_service(pairs)
    svc.enable_fleet()
    names = sorted(pairs)
    ep = svc.endpoint("m0")
    futs = [(n, i, svc.submit(n, xte[i:i + 1]))
            for i in range(12) for n in names]
    svc.close(timeout=WAIT)
    golden = {n: pairs[n][1].predict(xte) for n in names}
    for n, i, f in futs:
        assert f.done()
        assert f.result(timeout=0)[0] == golden[n][i]
    with pytest.raises(RuntimeError, match="closed"):
        ep.submit(xte[:1])


def test_register_pretune_and_unported_entry_points(pairs, blobs):
    xte = blobs[2]
    svc = InferenceService(device="cpu")
    try:
        ep = svc.register("warm", artifact=pairs["r0"][1], policy=_policy(),
                          pretune=True)
        np.testing.assert_array_equal(ep.submit(xte[:4]).result(timeout=WAIT),
                                      pairs["r0"][1].predict(xte[:4]))
        # ported since: the HTTP front end (tests/test_torch_serve_net.py)
        from repro_torch.serve.net import HttpServer
        server = svc.serve_http(port=0)
        assert isinstance(server, HttpServer) and server.service is svc
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            svc.register("sharded", artifact=pairs["r1"][1], mesh=object())
        assert svc.endpoint("warm").artifact.max_supported_batch is None
    finally:
        svc.close()


def test_service_runs_on_the_card_unless_asked(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceService()
    assert InferenceService(device="cpu").device.type == "cpu"


def test_fixed_batch_artifact_is_clamped(members, blobs):
    kind, params, _, _ = members["m1"]
    art = tcompile.compile(model_from_params(kind, params),
                           tcompile.Target(number_format="fxp16",
                                           backend="cuda",
                                           batch_policy="fixed",
                                           batch_size=2), device="cpu")
    assert art.max_supported_batch == 2
    svc = InferenceService(device="cpu")
    try:
        ep = svc.register("fixed", artifact=art, policy=_policy(max_batch=8))
        assert ep.policy.max_batch == 2
        xte = blobs[2]
        np.testing.assert_array_equal(ep.predict(xte[:7]), art.predict(
            xte[:2]).tolist() + art.predict(xte[2:4]).tolist()
            + art.predict(xte[4:6]).tolist() + art.predict(xte[6:7]).tolist())
    finally:
        svc.close()
