"""The LM forward's spans (``repro_torch.spans``) and the reduction of a
profiler trace by them (``bench/span_trace.py``).

* off: a forward records nothing, shows no ``lm.*`` range to a profiler,
  calls no profiler function and reads no clock;
* on: the logits are bit for bit those of a forward with spans off, and a
  forward records each span as often, and inside the span, that the
  forward's structure says, and opens no profiler range;
* the records' clock is the profiler's: the profiler's event of an
  operation run inside a span lies within the span's record, to 50 us;
* the kernel-to-span and gap-to-span reduction on synthetic events, and
  the six span metrics read from it.
"""

from __future__ import annotations

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench import span_trace as st
from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.lm import model

S = spans.Span
MS = 1_000_000

# the spans only the zamba2 pattern opens (its Mamba2 mixers, their scans
# and its shared-block calls)
HYBRID = {"lm.mamba", "lm.ssd", "lm.shared"}
SIX = ("norm_device_share", "rope_device_share", "gate_device_share",
       "logits_device_share", "forward_host_ms", "dispatch_idle_share")


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with spans off and nothing recorded."""
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


@pytest.fixture(scope="module")
def llava():
    """llava-next at its reduced widths: 4 layers, 8 image positions
    projected and prepended to 16 tokens."""
    cfg = get_config("llava-next-mistral-7b").reduced()
    gen = torch.Generator().manual_seed(3)
    params = model.init_params(cfg, gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 16),
                                     generator=gen),
             "image_embeds": torch.randn((1, 8, cfg.d_model), generator=gen)}
    return cfg, params, batch


def _forward(llava):
    cfg, params, batch = llava
    return model.forward(params, batch, cfg, attn_impl="train")


def _annotations(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name().startswith("lm.")]


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------
def test_off_a_forward_records_nothing_and_shows_no_range(llava):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _forward(llava)
    assert spans.take() == []
    assert _annotations(prof) == []


def test_off_a_span_opens_no_range_reads_no_clock_allocates_nothing(
        llava, monkeypatch):
    def boom(*_):
        raise AssertionError("called while spans are off")

    class NoClock:
        time_ns = staticmethod(boom)

    monkeypatch.setattr(spans, "time", NoClock)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    _forward(llava)
    assert spans.span("lm.norm") is spans.span("lm.block")  # one object
    assert spans.take() == []


# ---------------------------------------------------------------------------
# on
# ---------------------------------------------------------------------------
def test_on_the_logits_are_bit_for_bit_those_of_off(llava):
    off = _forward(llava)
    spans.enable()
    on = _forward(llava)
    spans.disable()
    assert torch.equal(on, off)
    assert spans.take()


def _per_forward(n_layers):
    """Each span's count a forward: a norm before attention and MLP in each
    block, and the final one."""
    return {"lm.forward": 1, "lm.embed": 1, "lm.block": n_layers,
            "lm.norm": 2 * n_layers + 1, "lm.attn": n_layers,
            "lm.rope": n_layers, "lm.mlp": n_layers, "lm.gate": n_layers,
            "lm.logits": 1}


def test_the_full_config_records_228_spans_a_forward():
    assert sum(_per_forward(32).values()) == 228  # llava-next's 32 layers


def test_on_counts_and_parents_of_a_forward(llava):
    cfg = llava[0]
    spans.enable()
    _forward(llava)
    _forward(llava)
    spans.disable()
    rec = spans.take()
    assert Counter(r.name for r in rec) == {
        k: 2 * v for k, v in _per_forward(cfg.n_layers).items()}
    assert {r.name for r in rec} == set(spans.NAMES) - HYBRID
    parent = {"lm.forward": None, "lm.embed": "lm.forward",
              "lm.block": "lm.forward", "lm.logits": "lm.forward",
              "lm.attn": "lm.block", "lm.mlp": "lm.block",
              "lm.rope": "lm.attn", "lm.gate": "lm.mlp"}
    forwards = [i for i, r in enumerate(rec) if r.name == "lm.forward"]
    assert forwards == [0, len(rec) // 2]
    for i, r in enumerate(rec):
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            up = rec[r.parent]
            assert r.parent < i and up.start_ns <= r.start_ns \
                and r.end_ns <= up.end_ns
        got = rec[r.parent].name if r.parent >= 0 else None
        if r.name == "lm.norm":
            assert got in ("lm.block", "lm.logits")
        else:
            assert got == parent[r.name]
        root = i
        while rec[root].parent >= 0:
            root = rec[root].parent
        assert root == (forwards[0] if i < forwards[1] else forwards[1])
    norms = Counter(rec[r.parent].name for r in rec if r.name == "lm.norm")
    assert norms == {"lm.block": 4 * cfg.n_layers, "lm.logits": 2}


def test_on_counts_and_parents_of_the_zamba2_forward():
    """The published Zamba2's route at its reduced widths (7 Mamba2
    layers, shared-block calls at 1, 3 and 5) on a ragged 45 positions:
    each layer's ``lm.mamba`` with its ``lm.ssd`` inside, each call's
    ``lm.shared`` around its two norms, attention and MLP, and every name
    of :data:`spans.NAMES` recorded."""
    cfg = get_config("zamba2-7b-hf").reduced()
    gen = torch.Generator().manual_seed(5)
    params = model.init_params(cfg, gen)
    tok = torch.randint(0, cfg.vocab_size, (1, 45), generator=gen)
    off = model.forward(params, {"tokens": tok}, cfg)
    spans.enable()
    on = model.forward(params, {"tokens": tok}, cfg)
    spans.disable()
    assert torch.equal(on, off)
    rec = spans.take()
    layers, calls = cfg.n_layers, len(cfg.shared.layers)
    assert Counter(r.name for r in rec) == {
        "lm.forward": 1, "lm.embed": 1, "lm.block": layers,
        "lm.mamba": layers, "lm.ssd": layers, "lm.shared": calls,
        "lm.attn": calls, "lm.rope": calls, "lm.mlp": calls,
        "lm.gate": calls, "lm.norm": layers + 2 * calls + 1,
        "lm.logits": 1}
    assert {r.name for r in rec} == set(spans.NAMES)
    parent = {"lm.embed": "lm.forward", "lm.block": "lm.forward",
              "lm.logits": "lm.forward", "lm.mamba": "lm.block",
              "lm.ssd": "lm.mamba", "lm.shared": "lm.block",
              "lm.attn": "lm.shared", "lm.rope": "lm.attn",
              "lm.mlp": "lm.shared", "lm.gate": "lm.mlp"}
    for r in rec[1:]:
        got = rec[r.parent].name
        if r.name == "lm.norm":
            assert got in ("lm.block", "lm.shared", "lm.logits")
        else:
            assert got == parent[r.name], r
    norms = Counter(rec[r.parent].name for r in rec if r.name == "lm.norm")
    assert norms == {"lm.block": layers, "lm.shared": 2 * calls,
                     "lm.logits": 1}


def test_on_a_span_records_and_opens_no_profiler_range(llava):
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _forward(llava)
    spans.disable()
    assert len(spans.take()) == sum(_per_forward(llava[0].n_layers).values())
    assert _annotations(prof) == []


def test_on_recording_leaves_no_object_for_the_collector():
    """The records are arrays of integers: a thousand spans add no object
    that the garbage collector tracks."""
    import gc

    spans.enable()
    with spans.span("lm.forward"):
        pass
    gc.collect()
    before = len(gc.get_objects())
    for _ in range(1000):
        with spans.span("lm.block"):
            with spans.span("lm.norm"):
                pass
    after = len(gc.get_objects())
    spans.disable()
    assert after - before < 20
    assert len(spans.take()) == 2001


def test_take_inside_an_open_span_raises():
    spans.enable()
    with spans.span("lm.forward"):
        with pytest.raises(RuntimeError):
            spans.take()
    assert [r.name for r in spans.take()] == ["lm.forward"]


def test_on_take_clears(llava):
    spans.enable()
    _forward(llava)
    assert spans.take()
    assert spans.take() == []


def test_the_records_are_on_the_profilers_clock(llava):
    """Two forwards under a profiler of the host's operations.  Each
    forward's last ``aten::matmul`` is its logits GEMM: it starts after
    the final norm's record ends and ends before the ``lm.logits`` record
    ends, and the profiler stamps both on its own clock.  Held to 50 us:
    a clock off by more than that, either way, fails.  (The operation runs
    between the two reads in real time, so a preempted process widens the
    bracket and never fails the check.)"""
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _forward(llava)
        _forward(llava)
    spans.disable()
    rec = spans.take()
    mm = sorted((e for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::matmul"), key=lambda e: e.start_ns())
    logits = [i for i, r in enumerate(rec) if r.name == "lm.logits"]
    assert len(logits) == 2 and len(mm) % 2 == 0
    for k, i in enumerate(logits):
        gemm = mm[(k + 1) * len(mm) // 2 - 1]
        norm = next(r for r in rec if r.parent == i)
        assert norm.name == "lm.norm"
        assert norm.end_ns - 50_000 <= gemm.start_ns()
        assert gemm.start_ns() + gemm.duration_ns() <= rec[i].end_ns + 50_000


# ---------------------------------------------------------------------------
# the reduction by span (synthetic events, times in ms)
# ---------------------------------------------------------------------------
def _spans():
    """Two forwards, 0-40 and 60-100 ms; the first with a block holding a
    norm, the second's norm in its logits."""
    return [S("lm.forward", -1, 0, 40 * MS),
            S("lm.block", 0, 5 * MS, 30 * MS),
            S("lm.norm", 1, 6 * MS, 10 * MS),
            S("lm.forward", -1, 60 * MS, 100 * MS),
            S("lm.logits", 3, 80 * MS, 99 * MS),
            S("lm.norm", 4, 81 * MS, 85 * MS)]


def E(name, start, end, device, correlation):
    return st.Event(name, start, end, device, False, correlation)


def _launch(name, t, corr):
    return E(name, t * MS, t * MS + MS // 10, False, corr)


def _events(launches=True):
    dev = [E("norm_kernel", 10 * MS, 20 * MS, True, 1),
           E("gemm", 20 * MS, 45 * MS, True, 2),
           E("Memcpy DtoD", 45 * MS, 50 * MS, True, 3),
           E("head_gemm", 70 * MS, 90 * MS, True, 4),
           E("nvjet_norm", 90 * MS, 95 * MS, True, 5)]
    host = [_launch("cudaLaunchKernel", 7, 1),  # in the block's norm
            _launch("cuLaunchKernelEx", 12, 2),  # in the block
            _launch("cudaMemcpyAsync", 50, 3),  # between the forwards
            _launch("cudaLaunchKernel", 90, 4),  # in the logits
            _launch("cudaLaunchKernel", 82, 5),  # in the final norm
            E("aten::mm", 12 * MS, 13 * MS, False, 4)]
    return dev + (host if launches else host[-1:])


def test_each_kernel_counts_to_the_innermost_span_at_its_launch():
    t = st.by_span(_events(), _spans())
    assert t.device == {
        "lm.norm": [pytest.approx(0.015), 2],
        "lm.block": [pytest.approx(0.025), 1],
        st.OUTSIDE: [pytest.approx(0.005), 0],  # a copy, no launch
        "lm.logits": [pytest.approx(0.020), 1]}
    assert t.busy_s == pytest.approx(0.040 + 0.025)  # 10-50, 70-95
    assert t.forward_s == pytest.approx([0.040, 0.040])
    assert t.idle == {} and t.dispatch_idle_s == 0  # no window given


def test_a_kernel_without_a_launch_record_is_counted_apart():
    t = st.by_span(_events(launches=False), _spans())
    assert list(t.device) == [st.UNLAUNCHED]
    assert t.device[st.UNLAUNCHED][1] == 4


def test_each_gap_counts_to_the_span_at_its_middle():
    # window 0-110 ms: gaps 0-10 (mid 5: the block opens at 5), 50-70
    # (mid 60: the second forward opens), 95-110 (mid 102.5: after the
    # forwards, in the harness)
    t = st.by_span(_events(), _spans(), (0, 110 * MS))
    assert t.window_s == pytest.approx(0.110)
    assert t.idle == pytest.approx({"lm.block": 0.010, "lm.forward": 0.020,
                                    st.OUTSIDE: 0.015})
    # inside a forward: 0-10, 60-70 and 95-100 ms
    assert t.dispatch_idle_s == pytest.approx(0.025)


def test_a_gap_in_the_harness_is_outside_every_forward():
    t = st.by_span([E("k", 0, 10 * MS, True, 1),
                         _launch("cudaLaunchKernel", 0, 1)],
                        [S("lm.forward", -1, 0, 5 * MS)], (0, 30 * MS))
    assert t.idle == {st.OUTSIDE: pytest.approx(0.020)}
    assert t.dispatch_idle_s == 0


def test_innermost_walks_up_past_closed_spans():
    at = st._innermost(_spans())
    assert [at(t * MS) for t in (-1, 3, 7, 20, 35, 50, 82, 99, 101)] == [
        st.OUTSIDE, "lm.forward", "lm.norm", "lm.block", "lm.forward",
        st.OUTSIDE, "lm.norm", "lm.logits", st.OUTSIDE]


def test_no_spans_put_everything_outside():
    """A port without spans: the kernels count outside every forward, and
    no span metric has anything to read."""
    t = st.by_span(_events(), [], (0, 110 * MS))
    assert set(t.device) == {st.OUTSIDE}
    assert t.forward_s == [] and t.dispatch_idle_s == 0
    for name in SIX:
        assert st.METRICS[name](t) is None


def test_two_windows_add_up():
    a = st.by_span(_events(), _spans(), (0, 110 * MS))
    both = st.add(a, a)
    assert both.device["lm.norm"] == [pytest.approx(0.030), 4]
    assert both.busy_s == pytest.approx(0.130)
    assert both.idle[st.OUTSIDE] == pytest.approx(0.030)
    assert both.dispatch_idle_s == pytest.approx(0.050)
    assert both.window_s == pytest.approx(0.220)
    assert len(both.forward_s) == 4
    assert a.device["lm.norm"] == [pytest.approx(0.015), 2]  # untouched


# ---------------------------------------------------------------------------
# the six span metrics
# ---------------------------------------------------------------------------
def _table():
    return st.by_span(_events(), _spans() + [
        S("lm.rope", -1, 101 * MS, 102 * MS),
        S("lm.gate", -1, 102 * MS, 104 * MS)], (0, 110 * MS))


def test_the_six_metrics_are_named():
    assert tuple(st.METRICS) == SIX


@pytest.mark.parametrize("name,want", [
    ("norm_device_share", 100 * 0.015 / 0.065),
    ("rope_device_share", 0.0),
    ("gate_device_share", 0.0),
    ("logits_device_share", 100 * 0.020 / 0.065),
    ("forward_host_ms", 40.0),
    ("dispatch_idle_share", 100 * 0.025 / 0.110)])
def test_metrics_on_a_span_table(name, want):
    assert st.METRICS[name](_table()) == pytest.approx(want)


def test_the_shares_read_the_innermost_span():
    t = _table()
    t.device["lm.rope"] = [0.0065, 3]
    t.device["lm.gate"] = [0.013, 1]
    assert st.METRICS["rope_device_share"](t) == pytest.approx(10.0)
    assert st.METRICS["gate_device_share"](t) == pytest.approx(20.0)


def test_forward_host_ms_is_the_median():
    t = _table()
    t.forward_s = [0.010, 0.030, 0.020]
    assert st.METRICS["forward_host_ms"](t) == pytest.approx(20.0)


@pytest.mark.parametrize("name", SIX)
def test_metrics_read_nothing_without_device_events(name):
    assert st.METRICS[name](None) is None
    no_card = st.by_span([], _spans(), (0, 110 * MS))
    assert no_card.busy_s == 0
    assert st.METRICS[name](no_card) is None
