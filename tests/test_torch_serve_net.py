"""The port's network serving plane (``repro_torch.serve.net``).

The 38 cases of ``tests/test_serve_net.py``:

* the pure cases (HTTP/1.1 framing over fed StreamReaders, token-bucket
  and queue-watermark admission on explicit clocks, rolling-window SLO
  histograms, the PrecisionGovernor's hysteresis, MicroBatcher shutdown)
  are one test each, parametrised over both packages' modules: every case
  runs once on the reference's and once on the port's;
* the service and HTTP cases run on ``InferenceService(device="cpu")``
  hosting the port's CART tree, trained on the golden blobs data
  (``tests/golden/regenerate.py``) and compiled for ``cuda`` (the kernels'
  plain versions on the host) at ``auto16`` with its ``auto8`` fallback;
  its labels are held against the reference's stored golden vectors:
  routes, error statuses, 429, the 503 watermark, drain on stop, fuzzed
  and disconnecting clients, the 504 deadline, the open circuit and the
  injected fault;
* the CLI: ``python -m repro_torch.launch.serve --classifier tree --format
  auto16 --degrade --http ... --device cpu`` serves, and ``--dp 2`` raises
  the multi-GPU slice's error.
"""

import asyncio
import dataclasses
import json
import socket
import threading
import time
import types
from concurrent.futures import wait

import numpy as np
import pytest

from golden import regenerate as G
from repro import serve as jserve
from repro.serve import net as jnet
from repro.serve import router as jrouter
from repro.serve.net import slo as jslo
from repro_torch import compile as tcompile
from repro_torch import serve as tserve
from repro_torch.models import train_decision_tree, train_mlp
from repro_torch.serve import (BatchingPolicy, DegradationPolicy,
                               InferenceService)
from repro_torch.serve import net as tnet
from repro_torch.serve import router as trouter
from repro_torch.serve.net import (AdmissionPolicy, HttpServer)
from repro_torch.serve.net import slo as tslo

pytestmark = pytest.mark.filterwarnings("ignore")


def _modules(serve, net, router, slo):
    return types.SimpleNamespace(
        read_request=net.read_request, ProtocolError=net.ProtocolError,
        response_bytes=net.response_bytes,
        AdmissionController=net.AdmissionController,
        AdmissionPolicy=net.AdmissionPolicy,
        RollingHistogram=net.RollingHistogram, SLOTracker=net.SLOTracker,
        BUCKET_EDGES_S=slo.BUCKET_EDGES_S,
        DegradationPolicy=serve.DegradationPolicy,
        PrecisionGovernor=serve.PrecisionGovernor,
        MicroBatcher=serve.MicroBatcher, BatchingPolicy=serve.BatchingPolicy,
        EndpointStats=router.EndpointStats)


PACKAGES = {"reference": _modules(jserve, jnet, jrouter, jslo),
            "port": _modules(tserve, tnet, trouter, tslo)}


@pytest.fixture(params=sorted(PACKAGES))
def P(request):
    """The modules of one package: each pure case runs on both."""
    return PACKAGES[request.param]


# ---------------------------------------------------------------------------
# shared artifacts: the golden dataset, the port's CART tree
# ---------------------------------------------------------------------------
def _compile(model, tag, xtr):
    kw = G.CLASSIFIER_TARGETS[tag]
    return tcompile.compile(
        model, tcompile.Target(backend="cuda", **kw),
        calibration=xtr if tag in G.CALIBRATED_TAGS else None, device="cpu")


@pytest.fixture(scope="module")
def golden_tree():
    xtr, ytr, xte, c = G.make_dataset()
    model = train_decision_tree(xtr, ytr, c, max_depth=6, seed=0)
    art16 = _compile(model, "auto16", xtr)
    art8 = _compile(model, "auto8", xtr)
    with np.load(G.golden_path("tree")) as z:
        goldens = {tag: z[tag].copy() for tag in ("auto16", "auto8")}
    for tag, art in (("auto16", art16), ("auto8", art8)):
        np.testing.assert_array_equal(art.predict(xte), goldens[tag])
    return art16, art8, xte, goldens


def _slowed(art, delay_s: float):
    """The artifact with a per-batch sleep injected (same output bytes)."""
    orig = art._predict

    def wrapped(x):
        out = orig(x)
        time.sleep(delay_s)
        return out

    return dataclasses.replace(art, _predict=wrapped)


# ---------------------------------------------------------------------------
# protocol framing
# ---------------------------------------------------------------------------
def _parse(P, raw: bytes, **kw):
    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        return await P.read_request(reader, **kw)

    return asyncio.run(go())


def test_protocol_parses_request(P):
    req = _parse(P, b"POST /v1/predict/t?x=1 HTTP/1.1\r\nHost: a\r\n"
                 b"Content-Length: 2\r\nX-Weird: v\r\n\r\nhi")
    assert (req.method, req.path, req.query) == ("POST", "/v1/predict/t", "x=1")
    assert req.headers["host"] == "a" and req.headers["x-weird"] == "v"
    assert req.body == b"hi" and req.keep_alive


def test_protocol_percent_decoding_and_close(P):
    req = _parse(P, b"GET /v1/predict/my%20ep HTTP/1.1\r\n"
                 b"Connection: close\r\n\r\n")
    assert req.path == "/v1/predict/my ep"
    assert not req.keep_alive


def test_protocol_clean_eof_is_none(P):
    assert _parse(P, b"") is None


def test_protocol_error_statuses(P):
    cases = [
        (b"GARBAGE\r\n\r\n", 400),                          # bad request line
        (b"GET / HTTP/1.1\r\nbad header\r\n\r\n", 400),     # no colon
        (b"POST / HTTP/1.1\r\n\r\n", 411),                  # no length
        (b"POST / HTTP/1.1\r\nContent-Length: x\r\n\r\n", 400),
        (b"POST / HTTP/1.1\r\nContent-Length: -1\r\n\r\n", 400),
        (b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n", 501),
        (b"GET / HTT", 400),                                # truncated head
        (b"GET / HTTP/1.1\r\nH: " + b"x" * 40_000 + b"\r\n\r\n", 431),
    ]
    for raw, status in cases:
        with pytest.raises(P.ProtocolError) as e:
            _parse(P, raw)
        assert e.value.status == status, raw[:40]


def test_protocol_body_limits_and_json(P):
    with pytest.raises(P.ProtocolError) as e:
        _parse(P, b"POST / HTTP/1.1\r\nContent-Length: 99\r\n\r\nhi", max_body=10)
    assert e.value.status == 413
    with pytest.raises(P.ProtocolError) as e:   # closed mid-body
        _parse(P, b"POST / HTTP/1.1\r\nContent-Length: 99\r\n\r\nhi")
    assert e.value.status == 400
    req = _parse(P, b"POST / HTTP/1.1\r\nContent-Length: 9\r\n\r\nnot json!")
    with pytest.raises(P.ProtocolError) as e:
        req.json()
    assert e.value.status == 400


def test_response_bytes_framing(P):
    raw = P.response_bytes(200, {"a": 1}, headers={"Retry-After": "0.5"})
    head, _, payload = raw.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200 OK\r\n")
    assert b"Content-Type: application/json" in head
    assert b"Retry-After: 0.5" in head
    assert f"Content-Length: {len(payload)}".encode() in head
    assert json.loads(payload) == {"a": 1}
    assert b"Connection: close" in P.response_bytes(503, keep_alive=False)


# ---------------------------------------------------------------------------
# admission control (explicit clocks, no sleeping)
# ---------------------------------------------------------------------------
def test_token_bucket_burst_and_refill(P):
    ctrl = P.AdmissionController(
        P.AdmissionPolicy(rate_limit=10.0, burst=3), now=0.0)
    assert all(ctrl.admit(0, now=0.0).ok for _ in range(3))
    refused = ctrl.admit(0, now=0.0)
    assert (refused.ok, refused.status) == (False, 429)
    # the bucket holds a token again after 1/rate seconds
    assert refused.retry_after_s == pytest.approx(0.1)
    assert not ctrl.admit(0, now=0.05).ok
    assert ctrl.admit(0, now=0.11).ok
    stats = ctrl.stats()
    assert stats["admitted"] == 4 and stats["rejected_rate"] == 2


def test_queue_watermark_503_with_drain_estimate(P):
    ctrl = P.AdmissionController(P.AdmissionPolicy(queue_high=8), now=0.0)
    assert ctrl.admit(7, now=0.0).ok
    refused = ctrl.admit(8, now=0.0)
    assert (refused.ok, refused.status) == (False, 503)
    assert refused.retry_after_s >= 0.05  # the floor
    ctrl.record_drain(100, 1.0)  # 100 req/s observed drain
    assert ctrl.admit(8, now=0.0).retry_after_s == pytest.approx(0.04, abs=0.02)
    assert ctrl.stats()["rejected_queue"] == 2


def test_admission_policy_validation(P):
    for bad in (dict(rate_limit=0), dict(burst=0), dict(queue_high=0)):
        with pytest.raises(ValueError):
            P.AdmissionPolicy(**bad)
    assert P.AdmissionController().admit(10 ** 9).ok is False  # default cap
    assert P.AdmissionController(P.AdmissionPolicy(queue_high=None)).admit(
        10 ** 9).ok


# ---------------------------------------------------------------------------
# SLO tracking
# ---------------------------------------------------------------------------
def test_rolling_histogram_percentiles_nearest_rank(P):
    h = P.RollingHistogram(window_s=60.0)
    for v in (0.010, 0.020, 0.100):
        h.record(v, now=1.0)
    assert h.count(now=1.0) == 3
    # read at a bucket upper edge: >= the true value, < one ratio above
    for q, v in ((50, 0.020), (99, 0.100)):
        got = h.percentile(q, now=1.0)
        assert v <= got <= v * 1.16
    assert h.percentile(99, now=1.0) >= h.percentile(50, now=1.0)
    assert P.RollingHistogram().percentile(99, now=0.0) == 0.0


def test_rolling_histogram_window_expiry(P):
    h = P.RollingHistogram(window_s=10.0, slices=5)
    h.record(0.5, now=0.0)
    assert h.count(now=5.0) == 1
    assert h.count(now=11.0) == 0  # aged out -> percentiles reset
    assert h.percentile(99, now=11.0) == 0.0
    h.record(0.25, now=11.0)
    assert h.count(now=11.0) == 1


def test_rolling_histogram_boundary_slice_ages_out(P):
    """Regression: a load spike must stop influencing percentiles once it
    is ``window_s`` old.  The ring keeps a slice only while
    ``epoch > now_epoch - slices`` — the strict ``>`` drops the boundary
    slice exactly at the window edge (a ``>=`` would report up to
    ``window_s + slice_s`` of history; see RollingHistogram.merged)."""
    h = P.RollingHistogram(window_s=60.0, slices=12)
    # a spike spread over the first slice (and a bit of the second)
    for t in (0.1, 2.5, 4.9, 5.1):
        h.record(5.0, now=t)  # 5 s latencies: a real spike
    assert h.percentile(99, now=30.0) >= 4.0
    # advance now past window_s from the last spike sample: spike gone
    assert h.count(now=65.2) == 0
    assert h.percentile(99, now=65.2) == 0.0
    # fresh traffic after the spike aged out reports clean percentiles
    h.record(0.010, now=66.0)
    assert h.percentile(99, now=66.0) <= 0.012
    # and at no point past the window edge does the boundary slice leak:
    # records from [0, slice_s) are dropped no later than now == window_s
    h2 = P.RollingHistogram(window_s=60.0, slices=12)
    h2.record(5.0, now=0.1)
    assert h2.count(now=60.0) == 0  # not 65.0 — no slice_s over-inclusion


def test_rolling_histogram_overflow_bucket_is_surfaced(P):
    """Latencies beyond the last finite edge (~12 s) report AT that edge
    (">= edge" floor semantics) — and the overflow count exposes that the
    percentile is saturated rather than exact."""
    h = P.RollingHistogram(window_s=60.0)
    last_edge = float(P.BUCKET_EDGES_S[-1])
    h.record(last_edge * 10, now=1.0)  # way past the histogram range
    h.record(last_edge * 99, now=1.0)
    h.record(0.010, now=1.0)
    assert h.percentile(99, now=1.0) == pytest.approx(last_edge)
    assert h.overflow(now=1.0) == 2
    assert h.count(now=1.0) == 3  # overflow values still count in ranks
    # overflow ages out with its slices like any other count
    assert h.overflow(now=120.0) == 0

    trk = P.SLOTracker(window_s=60.0, default_slo_ms=50.0)
    trk.record("ep", last_edge * 10, now=1.0)
    snap = trk.snapshot(now=1.0)["ep"]
    assert snap["window_overflow"] == 1
    assert snap["p99_ms"] == pytest.approx(last_edge * 1e3)
    snap2 = trk.snapshot(now=120.0)["ep"]
    assert snap2["window_overflow"] == 0


def test_slo_tracker_violations_and_snapshot(P):
    trk = P.SLOTracker(window_s=60.0, default_slo_ms=50.0,
                     targets={"fast": 1000.0})
    for ms in (10, 20, 200):  # one violation of the 50ms default
        trk.record("ep", ms / 1e3, now=1.0)
    trk.record("fast", 0.2, now=1.0)  # under its 1000ms target
    snap = trk.snapshot(now=1.0)
    ep = snap["ep"]
    assert ep["requests"] == ep["window_requests"] == 3
    assert ep["violations"] == 1
    assert ep["violation_fraction"] == pytest.approx(1 / 3)
    assert not ep["p99_under_slo"] and snap["fast"]["p99_under_slo"]
    assert ep["p50_ms"] <= ep["p95_ms"] <= ep["p99_ms"]


# ---------------------------------------------------------------------------
# PrecisionGovernor state machine
# ---------------------------------------------------------------------------
def test_governor_engages_on_either_watermark(P):
    pol = P.DegradationPolicy(queue_high=10, queue_low=2, p99_high_ms=100.0,
                            min_hold_s=0.0)
    g = P.PrecisionGovernor(pol)
    assert not g.observe(9, 50.0, now=0.0)       # under both
    assert g.observe(10, 0.0, now=1.0)           # queue watermark
    g2 = P.PrecisionGovernor(pol)
    assert g2.observe(0, 100.0, now=0.0)         # p99 watermark alone


def test_governor_recovery_is_conjunctive(P):
    g = P.PrecisionGovernor(P.DegradationPolicy(
        queue_high=10, queue_low=2, p99_high_ms=100.0, p99_low_ms=40.0,
        min_hold_s=0.0))
    assert g.observe(50, 500.0, now=0.0)
    assert g.observe(0, 90.0, now=1.0)    # queue low, p99 still high: stay
    assert g.observe(5, 10.0, now=2.0)    # p99 low, queue still high: stay
    assert not g.observe(1, 10.0, now=3.0)  # both low: recover
    assert g.snapshot() == {"degraded": False, "observations": 4,
                            "engagements": 1, "recoveries": 1}


def test_governor_holds_on_empty_window_p99(P):
    """Regression: with the latency trigger armed, an endpoint whose
    requests are all *queued* (zero completions in the rolling window)
    must not recover — unknown p99 is not low p99.  The stats layer
    reports None for an empty window and the governor treats None as
    blocking recovery / never engaging the latency trigger by itself."""
    g = P.PrecisionGovernor(P.DegradationPolicy(
        queue_high=10, queue_low=2, p99_high_ms=100.0, p99_low_ms=40.0,
        min_hold_s=0.0))
    assert g.observe(50, 500.0, now=0.0)      # engaged under real overload
    # queue drained below queue_low but NOTHING completed: p99 unknown.
    assert g.observe(0, None, now=1.0)        # must hold degraded
    assert g.observe(1, None, now=2.0)        # still holding
    assert g.recoveries == 0
    assert not g.observe(0, 10.0, now=3.0)    # a real low p99: recover
    # unknown p99 never *engages* the latency trigger either
    g2 = P.PrecisionGovernor(P.DegradationPolicy(
        queue_high=10, queue_low=2, p99_high_ms=100.0, min_hold_s=0.0))
    assert not g2.observe(0, None, now=0.0)
    # queue-only policies are unaffected by an unknown latency signal
    g3 = P.PrecisionGovernor(P.DegradationPolicy(queue_high=10, queue_low=2,
                                             min_hold_s=0.0))
    assert g3.observe(50, None, now=0.0)
    assert not g3.observe(0, None, now=1.0)


def test_rolling_p99_none_on_empty_window(P):
    """EndpointStats reports None (not 0.0) before any request completes —
    the signal the governor needs to distinguish idle from overloaded."""
    stats = P.EndpointStats()
    assert stats.rolling_p99_ms() is None
    stats.record_batch(1, 1, 1, [0.050])
    assert stats.rolling_p99_ms() == pytest.approx(50.0)


def test_governor_min_hold_prevents_flapping(P):
    g = P.PrecisionGovernor(P.DegradationPolicy(queue_high=10, queue_low=2,
                                            min_hold_s=5.0))
    assert g.observe(100, 0.0, now=0.0)  # first engage is never held back
    # load oscillates across both watermarks faster than min_hold
    for t in np.arange(0.5, 4.5, 0.5):
        state = g.observe(0 if int(t * 2) % 2 else 100, 0.0, now=float(t))
        assert state  # dwell time pins the state
    assert not g.observe(0, 0.0, now=5.0)  # held long enough: recover
    assert g.engagements == 1 and g.recoveries == 1


def test_governor_force_and_policy_validation(P):
    g = P.PrecisionGovernor()
    g.force(True, now=0.0)
    assert g.degraded and g.engagements == 1
    for bad in (dict(queue_high=0), dict(queue_low=99, queue_high=9),
                dict(p99_high_ms=-1), dict(p99_low_ms=5.0),
                dict(p99_high_ms=10.0, p99_low_ms=20.0),
                dict(min_hold_s=-1)):
        with pytest.raises(ValueError):
            P.DegradationPolicy(**bad)
    # p99_low defaults to half of p99_high
    assert P.DegradationPolicy(p99_high_ms=80.0).p99_low_ms == 40.0


# ---------------------------------------------------------------------------
# MicroBatcher graceful shutdown: every future resolves
# ---------------------------------------------------------------------------
def test_close_drains_all_queued_futures(P):
    def predict(x):
        return x.sum(axis=tuple(range(1, x.ndim))).astype(np.int32)

    mb = P.MicroBatcher(predict, P.BatchingPolicy(max_batch=8, warmup=False))
    futs = [mb.submit(np.full((1, 4), i, np.float32)) for i in range(40)]
    mb.close()  # unbounded drain: everything is served
    got = [int(f.result(timeout=10)[0]) for f in futs]
    assert got == [4 * i for i in range(40)]
    with pytest.raises(RuntimeError):
        mb.submit(np.zeros((1, 4), np.float32))
    mb.close()  # idempotent


def test_close_deadline_rejects_rather_than_drops(P):
    def slow(x):
        time.sleep(0.05)
        return np.zeros(x.shape[0], np.int32)

    mb = P.MicroBatcher(slow, P.BatchingPolicy(max_batch=1, warmup=False,
                                           max_wait_ms=0.0))
    futs = [mb.submit(np.zeros((1, 4), np.float32)) for _ in range(50)]
    t0 = time.perf_counter()
    mb.close(timeout=0.4)  # budget for ~8 of the 50
    # Deadline honored (generous CI margin), and EVERY future resolved:
    # served or rejected with the drain-deadline error — none pending.
    # (The worker may still be finishing its current batch when close()
    # returns; wait() gives that last in-flight future time to resolve.)
    assert time.perf_counter() - t0 < 5.0
    wait(futs, timeout=10)
    served = rejected = 0
    for f in futs:
        assert f.done()
        if f.exception() is not None:
            assert "closed" in str(f.exception())
            rejected += 1
        else:
            served += 1
    assert served + rejected == 50
    assert rejected > 0  # the deadline actually cut the drain short


def test_close_without_drain_rejects_everything_queued(P):
    def slow(x):
        time.sleep(0.05)
        return np.zeros(x.shape[0], np.int32)

    mb = P.MicroBatcher(slow, P.BatchingPolicy(max_batch=1, warmup=False,
                                           max_wait_ms=0.0))
    futs = [mb.submit(np.zeros((1, 4), np.float32)) for _ in range(20)]
    # join budget far below the 1s the queue needs: close() reclaims the
    # tail from the still-running worker and must reject, not serve, it
    mb.close(drain=False, timeout=0.2)
    wait(futs, timeout=10)
    assert all(f.done() for f in futs)
    # the queued tail was rejected, not dropped
    assert any(f.exception() is not None for f in futs)



def test_service_close_resolves_inflight(golden_tree):
    art16, _, xte, _ = golden_tree
    svc = InferenceService(device="cpu")
    svc.register("t", artifact=_slowed(art16, 0.02),
                 policy=BatchingPolicy(max_batch=4, warmup=False))
    futs = [svc.submit("t", xte[i]) for i in range(32)]
    svc.close(timeout=30.0)
    preds = [int(f.result(timeout=1)[0]) for f in futs]
    assert len(preds) == 32  # all served within the budget


# ---------------------------------------------------------------------------
# degradation end-to-end: overload -> auto8, bit-identical to its goldens
# ---------------------------------------------------------------------------
def test_degradation_engages_and_bit_matches_goldens(golden_tree):
    art16, art8, xte, goldens = golden_tree
    svc = InferenceService(device="cpu")
    svc.register("tree", artifact=_slowed(art16, 0.03),
                 policy=BatchingPolicy(max_batch=8, warmup=False,
                                       max_wait_ms=0.0))
    svc.enable_degradation(
        "tree", artifact=art8,
        policy=DegradationPolicy(queue_high=6, queue_low=0, min_hold_s=0.0))
    ep = svc.endpoint("tree")
    try:
        idx = [i % xte.shape[0] for i in range(96)]
        futs = [svc.submit("tree", xte[i]) for i in idx]
        preds = [int(f.result(timeout=60)[0]) for f in futs]
        flags = [f.batch_meta["degraded"] for f in futs]
        # the flood crossed the queue watermark: the governor engaged and
        # the degraded batches were served by the auto8 artifact
        assert ep.governor.engagements >= 1 and any(flags)
        for i, pred, degraded in zip(idx, preds, flags):
            tag = "auto8" if degraded else "auto16"
            assert pred == int(goldens[tag][i]), (i, tag)
        assert svc.stats()["tree"]["degraded_fraction"] > 0.0
        # drained: the next lone request observes an empty queue, recovers
        # (min_hold 0), and is served by the primary again
        f = svc.submit("tree", xte[0])
        assert int(f.result(timeout=60)[0]) == int(goldens["auto16"][0])
        assert f.batch_meta["degraded"] is False
        assert ep.governor.recoveries >= 1 and not ep.degraded
    finally:
        svc.close(timeout=30.0)


def test_degradation_hysteresis_no_flap_under_oscillation(golden_tree):
    art16, art8, xte, _ = golden_tree
    svc = InferenceService(device="cpu")
    svc.register("tree", artifact=_slowed(art16, 0.01),
                 policy=BatchingPolicy(max_batch=4, warmup=False,
                                       max_wait_ms=0.0))
    # min_hold longer than the test: at most ONE transition can ever happen
    svc.enable_degradation(
        "tree", artifact=art8,
        policy=DegradationPolicy(queue_high=4, queue_low=0, min_hold_s=60.0))
    try:
        for _ in range(6):  # bursts with idle gaps: load oscillates
            futs = [svc.submit("tree", xte[i]) for i in range(16)]
            for f in futs:
                f.result(timeout=60)
            time.sleep(0.03)
        g = svc.endpoint("tree").governor
        assert g.engagements <= 1 and g.recoveries == 0
    finally:
        svc.close(timeout=30.0)


def test_set_fallback_validation(golden_tree):
    art16, _, _, _ = golden_tree
    svc = InferenceService(device="cpu")
    svc.register("tree", artifact=art16)
    xtr, ytr, _, c = G.make_dataset()
    mlp = train_mlp(xtr, ytr, c, hidden=(4,), epochs=1, device="cpu")
    wrong_kind = _compile(mlp, "auto8", xtr)
    try:
        with pytest.raises(ValueError):
            svc.endpoint("tree").set_fallback(wrong_kind)
        with pytest.raises(TypeError):  # model+artifact is ambiguous
            svc.enable_degradation("tree", model=mlp, artifact=art16)
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# HttpServer end-to-end over real sockets
# ---------------------------------------------------------------------------
async def _read_response(reader):
    status = int((await reader.readline()).split()[1])
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b""):
            break
        name, _, value = line.decode().partition(":")
        headers[name.strip().lower()] = value.strip()
    body = await reader.readexactly(int(headers.get("content-length", 0)))
    if "json" in headers.get("content-type", ""):
        body = json.loads(body)
    return status, headers, body


async def _roundtrip(server, method, path, body=None, conn=None):
    if conn is None:
        conn = await asyncio.open_connection(server.host, server.port)
    reader, writer = conn
    payload = b"" if body is None else json.dumps(body).encode()
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                  + (f"Content-Length: {len(payload)}\r\n" if payload else "")
                  + "\r\n").encode() + payload)
    await writer.drain()
    return await _read_response(reader)


def _run_with_server(svc, coro_fn, **server_kw):
    async def go():
        server = HttpServer(svc, **server_kw)
        await server.start()
        try:
            return await coro_fn(server)
        finally:
            await server.stop()

    return asyncio.run(go())


def test_http_server_routes_and_predict(golden_tree):
    art16, art8, xte, goldens = golden_tree
    svc = InferenceService(device="cpu")
    svc.register("tree", artifact=art16,
                 policy=BatchingPolicy(max_batch=16))
    svc.enable_degradation("tree", artifact=art8)

    async def scenario(server):
        conn = await asyncio.open_connection(server.host, server.port)
        status, _, health = await _roundtrip(server, "GET", "/v1/health",
                                             conn=conn)
        assert status == 200 and health == {"status": "ok", "endpoints": 1}
        # keep-alive: same connection serves the whole scenario
        status, _, eps = await _roundtrip(server, "GET", "/v1/endpoints",
                                          conn=conn)
        assert status == 200 and eps["tree"]["number_format"] == "auto16"
        assert eps["tree"]["degradation"]["fallback_format"] == "auto8"
        # predictions (69 rows: exercises the > max_batch chunking path)
        status, _, body = await _roundtrip(
            server, "POST", "/v1/predict/tree",
            {"rows": xte[:69].tolist()}, conn=conn)
        assert status == 200 and not body["degraded"]
        assert body["predictions"] == [int(v) for v in goldens["auto16"][:69]]
        status, _, stats = await _roundtrip(server, "GET", "/v1/stats",
                                            conn=conn)
        assert status == 200
        assert stats["endpoints"]["tree"]["rows"] == 69.0
        assert stats["slo"]["tree"]["requests"] == 1
        conn[1].close()

    _run_with_server(svc, scenario)
    svc.close()


def test_http_server_error_paths(golden_tree):
    art16, _, xte, _ = golden_tree
    svc = InferenceService(device="cpu")
    svc.register("tree", artifact=art16)

    async def scenario(server):
        cases = [
            ("GET", "/nope", None, 404),
            ("POST", "/v1/predict/ghost", {"rows": [[0.0]]}, 404),
            ("GET", "/v1/predict/tree", None, 405),
            ("POST", "/v1/health", {"x": 1}, 405),
            ("POST", "/v1/predict/tree", {"wrong": 1}, 400),
            ("POST", "/v1/predict/tree", {"rows": [["a", "b"]]}, 400),
            ("POST", "/v1/predict/tree", {"rows": []}, 400),
        ]
        for method, path, body, want in cases:
            status, _, resp = await _roundtrip(server, method, path, body)
            assert status == want, (path, resp)
            assert "error" in resp

    _run_with_server(svc, scenario)
    svc.close()


def test_http_server_rate_limit_429(golden_tree):
    art16, _, xte, _ = golden_tree
    svc = InferenceService(device="cpu")
    svc.register("tree", artifact=art16)

    async def scenario(server):
        row = {"rows": [xte[0].tolist()]}
        status, _, _ = await _roundtrip(server, "POST", "/v1/predict/tree",
                                        row)
        assert status == 200  # the single burst token
        status, headers, body = await _roundtrip(
            server, "POST", "/v1/predict/tree", row)
        assert status == 429 and body["error"] == "rate limit"
        assert float(headers["retry-after"]) > 0
        status, _, stats = await _roundtrip(server, "GET", "/v1/stats")
        assert stats["admission"]["tree"]["rejected_rate"] == 1

    _run_with_server(svc, scenario,
                     admission=AdmissionPolicy(rate_limit=0.5, burst=1))
    svc.close()


def test_http_server_queue_watermark_503(golden_tree):
    art16, _, xte, _ = golden_tree
    svc = InferenceService(device="cpu")
    svc.register("tree", artifact=_slowed(art16, 0.1),
                 policy=BatchingPolicy(max_batch=2, warmup=False,
                                       max_wait_ms=0.0))

    async def scenario(server):
        row = {"rows": [xte[0].tolist()]}
        results = await asyncio.gather(*[
            _roundtrip(server, "POST", "/v1/predict/tree", row)
            for _ in range(12)])
        statuses = [s for s, _, _ in results]
        assert statuses.count(200) >= 1
        assert statuses.count(503) >= 1  # watermark refused the overflow
        for status, headers, _ in results:
            if status == 503:
                assert float(headers["retry-after"]) > 0
        assert all(s in (200, 503) for s in statuses)

    _run_with_server(svc, scenario, admission=AdmissionPolicy(queue_high=2))
    svc.close(timeout=30.0)


def test_http_server_stop_reports_draining(golden_tree):
    art16, _, xte, _ = golden_tree
    svc = InferenceService(device="cpu")
    svc.register("tree", artifact=art16)

    async def scenario(server):
        status, _, body = await _roundtrip(server, "GET", "/v1/health")
        assert body["status"] == "ok"
        await server.stop()
        # listener is closed: new connections are refused
        with pytest.raises(OSError):
            await asyncio.open_connection(server.host, server.port)

    _run_with_server(svc, scenario)
    svc.close()


# ---------------------------------------------------------------------------
# launch/serve.py --http CLI smoke
# ---------------------------------------------------------------------------
def test_serve_cli_http_smoke(capsys):
    from urllib.request import Request, urlopen

    from repro_torch.launch import serve as serve_cli

    with socket.socket() as s:  # a port that was just free
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    th = threading.Thread(target=serve_cli.main, args=([
        "--classifier", "tree", "--format", "auto16", "--degrade",
        "--http", f"127.0.0.1:{port}", "--http-duration", "8",
        "--queue-high", "32", "--slo-ms", "250", "--device", "cpu",
    ],), daemon=True)
    th.start()
    deadline = time.time() + 30
    body = None
    while time.time() < deadline:
        try:
            with urlopen(f"http://127.0.0.1:{port}/v1/health",
                         timeout=2) as r:
                body = json.loads(r.read())
            break
        except OSError:
            time.sleep(0.2)
    assert body == {"status": "ok", "endpoints": 1}
    row = json.dumps({"rows": [[0.0] * 16]}).encode()  # blobs: 16 features
    with urlopen(Request(f"http://127.0.0.1:{port}/v1/predict/tree",
                         data=row), timeout=10) as r:
        pred = json.loads(r.read())
    assert len(pred["predictions"]) == 1 and pred["degraded"] is False
    th.join(timeout=60)
    assert not th.is_alive()
    out = capsys.readouterr().out
    assert "degradation armed: auto16 -> auto8" in out


# ---------------------------------------------------------------------------
# HTTP robustness: malformed, truncated, oversized, disconnecting clients
# ---------------------------------------------------------------------------
async def _send_raw(server, raw, close_early=False, timeout=5.0):
    """Write raw bytes to the server; return the response bytes (or None
    when ``close_early`` drops the connection mid-request)."""
    reader, writer = await asyncio.open_connection(server.host, server.port)
    writer.write(raw)
    await writer.drain()
    if close_early:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass
        return None
    try:
        data = await asyncio.wait_for(reader.read(65536), timeout)
    finally:
        writer.close()
    return data


def test_http_fuzz_malformed_inputs_answer_typed_errors(golden_tree):
    """Garbage on the wire gets a typed 4xx/5xx — never a hang, never a
    dead server."""
    art16, _, xte, _ = golden_tree
    svc = InferenceService(device="cpu")
    svc.register("tree", artifact=art16)

    async def scenario(server):
        cases = [
            # body is not JSON
            (b"POST /v1/predict/tree HTTP/1.1\r\n"
             b"Content-Length: 9\r\n\r\nnot json!", 400),
            # binary garbage where a request line should be
            (b"\x00\xff\xfe garbage\r\n\r\n", 400),
            # unparseable Content-Length
            (b"POST /v1/predict/tree HTTP/1.1\r\n"
             b"Content-Length: nope\r\n\r\n", 400),
            # Content-Length far past the body cap: refused before reading
            (b"POST /v1/predict/tree HTTP/1.1\r\n"
             b"Content-Length: 99999999\r\n\r\n{}", 413),
            # unimplemented framing
            (b"POST /v1/predict/tree HTTP/1.1\r\n"
             b"Transfer-Encoding: chunked\r\n\r\n", 501),
            # JSON that parses but is the wrong shape
            (b'POST /v1/predict/tree HTTP/1.1\r\n'
             b'Content-Length: 17\r\n\r\n{"rows": "nope!"}', 400),
        ]
        for raw, want in cases:
            data = await _send_raw(server, raw)
            assert data and data.startswith(b"HTTP/1.1"), raw[:30]
            status = int(data.split()[1])
            assert status == want, (raw[:30], status)
        # after all that abuse the server still serves real traffic
        status, _, body = await _roundtrip(
            server, "POST", "/v1/predict/tree", {"rows": [xte[0].tolist()]})
        assert status == 200 and len(body["predictions"]) == 1

    _run_with_server(svc, scenario)
    svc.close()


def test_http_fuzz_disconnecting_clients_leave_server_healthy(golden_tree):
    """Clients that vanish mid-request (truncated bodies, half-written
    request lines) must not wedge a handler or take the listener down."""
    art16, _, _, _ = golden_tree
    svc = InferenceService(device="cpu")
    svc.register("tree", artifact=art16)

    async def scenario(server):
        # truncated body: Content-Length promises 50, client sends 1, leaves
        await _send_raw(server, b"POST /v1/predict/tree HTTP/1.1\r\n"
                                b"Content-Length: 50\r\n\r\n{",
                        close_early=True)
        # disconnect mid-request-line
        await _send_raw(server, b"POST /v1/pre", close_early=True)
        # disconnect mid-header
        await _send_raw(server, b"GET /v1/health HTTP/1.1\r\nHost:",
                        close_early=True)
        # a zero-byte connection (open, immediately close)
        await _send_raw(server, b"", close_early=True)
        await asyncio.sleep(0.05)  # let the handlers observe the EOFs
        status, _, body = await _roundtrip(server, "GET", "/v1/health")
        assert status == 200 and body["status"] == "ok"

    _run_with_server(svc, scenario)
    svc.close()


def test_http_deadline_maps_to_504(golden_tree):
    """A request whose ``deadline_ms`` passes while it queues answers a
    typed 504 (code deadline_exceeded) and is never dispatched; requests
    without deadlines are unaffected."""
    art16, _, xte, _ = golden_tree
    svc = InferenceService(device="cpu")
    svc.register("tree", artifact=_slowed(art16, 0.05),
                 policy=BatchingPolicy(max_batch=4, warmup=False,
                                       max_wait_ms=0.0))

    async def scenario(server):
        row = {"rows": [xte[0].tolist()]}
        # back the queue up so a deadline-carrying request provably waits
        flood = [asyncio.ensure_future(
            _roundtrip(server, "POST", "/v1/predict/tree", row))
            for _ in range(16)]
        await asyncio.sleep(0.05)
        status, _, body = await _roundtrip(
            server, "POST", "/v1/predict/tree",
            {"rows": [xte[0].tolist()], "deadline_ms": 1})
        assert status == 504, body
        assert body["code"] == "deadline_exceeded"
        for s, _, b in await asyncio.gather(*flood):
            assert s == 200, b  # batchmates without deadlines all served
        # malformed deadline is a 400, not a silent default
        status, _, body = await _roundtrip(
            server, "POST", "/v1/predict/tree",
            {"rows": [xte[0].tolist()], "deadline_ms": "soon"})
        assert status == 400
        status, _, body = await _roundtrip(
            server, "POST", "/v1/predict/tree",
            {"rows": [xte[0].tolist()], "deadline_ms": -5})
        assert status == 400

    _run_with_server(svc, scenario)
    svc.close(timeout=30.0)


def test_http_circuit_open_maps_to_503(golden_tree):
    from repro_torch.serve import BreakerPolicy, CircuitBreaker

    art16, _, xte, _ = golden_tree
    svc = InferenceService(device="cpu")
    svc.register("tree", artifact=art16,
                 breaker=CircuitBreaker(BreakerPolicy(
                     consecutive_failures=1, open_s=60.0)))
    svc.endpoint("tree").breaker.record_failure()  # trips immediately

    async def scenario(server):
        status, headers, body = await _roundtrip(
            server, "POST", "/v1/predict/tree", {"rows": [xte[0].tolist()]})
        assert status == 503, body
        assert body["code"] == "circuit_open"
        assert float(headers["retry-after"]) > 0
        status, _, stats = await _roundtrip(server, "GET", "/v1/stats")
        assert stats["endpoints"]["tree"]["breaker"]["state"] == "open"

    _run_with_server(svc, scenario)
    svc.close()


def test_http_injected_fault_answers_500_and_recovers(golden_tree):
    """The http.request chaos site: an injected fault at the boundary is a
    typed 500 for that request; the next request is served normally."""
    from repro_torch.serve import FaultPlan, FaultRule
    from repro_torch.serve import faults as faults_mod

    art16, _, xte, goldens = golden_tree
    svc = InferenceService(device="cpu")
    svc.register("tree", artifact=art16)
    plan = FaultPlan([FaultRule(site="http.request", match="/v1/predict",
                                count=1)])

    async def scenario(server):
        row = {"rows": [xte[0].tolist()]}
        status, _, body = await _roundtrip(server, "POST",
                                           "/v1/predict/tree", row)
        assert status == 500 and "injected fault" in body["error"]
        status, _, body = await _roundtrip(server, "POST",
                                           "/v1/predict/tree", row)
        assert status == 200
        assert body["predictions"] == [int(goldens["auto16"][0])]

    with faults_mod.inject(plan):
        _run_with_server(svc, scenario)
    svc.close()


def test_serve_cli_dp_raises_multi_gpu_slice():
    from repro_torch.launch import serve as serve_cli

    with pytest.raises(NotImplementedError, match="multi-GPU"):
        serve_cli.main(["--classifier", "tree", "--dp", "2", "--device",
                        "cpu"])
