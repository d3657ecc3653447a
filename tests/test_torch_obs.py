"""The port's observability layer (``repro_torch.obs``) against ``repro.obs``.

Case for case the tracer, registry, report and engine parts of
``tests/test_obs.py`` (its ring, fused-ring and service cases live in
``test_torch_dist.py``, ``test_torch_fused_ring.py`` and
``test_torch_service.py``), with the same parametrisation; where a case
drives a join, both packages run it on the same inputs inside their own
captures and the span counts and mirrored metrics must be equal.  Then what
only the port has a counterpart of: each package's report reads the other's
traces to the same dict, and the ``torch.profiler`` bridge
(``capture(torch_bridge=True)``, the counterpart of ``jax_bridge``) on the
CPU: one profiler range per span, none with the bridge off, ranges closed on
an exception, the enclosing window's bridge restored after a nested capture.
"""
import collections
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import repro.core as ref_core
from oracles import brute_counts, brute_pairs, make_dataset, pair_set
from repro import obs as ref_obs
from repro.join import SimilarityIndex as RefIndex
from repro.obs import report as ref_report
from repro_torch import obs
from repro_torch.core import EngineConfig, SelfJoinConfig, SelfJoinEngine
from repro_torch.join import SimilarityIndex
from repro_torch.obs import report as obs_report
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import _NOOP, _state
from torch.profiler import record_function

SRC = Path(__file__).resolve().parents[1] / "src"


# -- tracer unit tests -------------------------------------------------------

def test_disabled_tracer_records_zero_events():
    assert not obs.enabled()
    with obs.span("work", "test", k=1) as sp:
        sp.set(extra=2)
    obs.event("tick", "test")
    obs.inc("never_total")
    obs.observe("never_hist", 1.0)
    obs.set_gauge("never_gauge", 1.0)
    assert obs.event_count() == 0
    assert obs.events() == []
    assert obs.span("again") is _NOOP
    assert _state.bridge is None
    assert obs.metric_value(obs.REGISTRY.snapshot(), "never_total") == 0.0


def test_disabled_join_runs_untraced(dataset_case):
    name, data, eps = dataset_case
    eng = SelfJoinEngine(data, SelfJoinConfig(eps=eps, k=4, tile_size=16), device="cpu")
    res = eng.pairs()
    assert obs.event_count() == 0, name
    assert pair_set(res.pairs) == pair_set(brute_pairs(data, eps)), name


def test_ring_buffer_bounds_and_drop_counter():
    obs.enable(capacity=4)
    try:
        for i in range(10):
            obs.event(f"e{i}", "test")
        evts = obs.events()
        assert [e.name for e in evts] == ["e6", "e7", "e8", "e9"]
        assert obs.dropped_count() == 6
        assert obs.event_count() == 4
    finally:
        obs.disable()
        obs.clear()


def test_span_series_counts_its_spans_toward_capacity():
    obs.enable(capacity=4)
    try:
        obs.event("a", "test")
        t = obs.epoch_ns()
        obs.span_series("s", "test", [t + 1000 * i for i in range(6)])  # 5 spans: a and s0 drop
        assert (obs.event_count(), obs.dropped_count()) == (4, 2)
        obs.event("b", "test")  # s1 drops
        evts = obs.events()
        assert [e.name for e in evts] == ["s", "s", "s", "b"]
        assert [e.ts_us for e in evts[:3]] == pytest.approx([2.0, 3.0, 4.0])
        assert {e.dur_us for e in evts[:3]} == {1.0}
        assert (obs.event_count(), obs.dropped_count()) == (4, 3)
    finally:
        obs.disable()
        obs.clear()


def test_chunk_loop_keeps_the_chunks_before_a_failure():
    def step(i):
        if i == 3:
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        with obs.capture() as cap:
            with obs.span("join", "test"):
                obs.chunk_loop("loop.chunk", step, [(i,) for i in range(6)])
    assert cap.span_count("loop.chunk", "dispatch") == 3 and cap.span_count("join") == 1


def test_span_nesting_depth_and_attrs():
    with obs.capture() as cap:
        with obs.span("outer", "test", a=1):
            with obs.span("inner", "test") as sp:
                sp.set(b=np.int64(2))  # numpy scalars must serialize
    outer = cap.spans("outer")[0]
    inner = cap.spans("inner")[0]
    assert outer.depth == 0 and inner.depth == 1
    assert outer.attrs["a"] == 1
    assert inner.attrs["b"] == 2
    assert inner.ts_us >= outer.ts_us
    assert inner.dur_us <= outer.dur_us
    json.dumps(cap.chrome_trace())  # attrs are JSON-clean


def test_capture_restores_prior_state():
    assert not obs.enabled()
    with obs.capture() as cap:
        assert obs.enabled()
        obs.event("in_cap", "test")
    assert not obs.enabled()
    assert obs.event_count() == 0
    assert cap.span_count("in_cap") == 1
    obs.enable()
    try:
        obs.event("before", "test")
        with obs.capture() as inner:
            obs.event("inside", "test")
        assert inner.span_count("inside") == 1
        assert inner.span_count("before") == 0
        assert obs.enabled()
    finally:
        obs.disable()
        obs.clear()


def test_capture_exception_still_collects():
    with pytest.raises(RuntimeError, match="boom"):
        with obs.capture() as cap:
            obs.event("pre_fail", "test")
            raise RuntimeError("boom")
    assert not obs.enabled()
    assert cap.span_count("pre_fail") == 1


# -- metrics registry --------------------------------------------------------

def test_registry_counter_gauge_histogram():
    reg = MetricsRegistry()
    c = reg.counter("req_total", "requests")
    c.inc(2, kind="a")
    c.inc(3, kind="b")
    g = reg.gauge("depth", "queue depth")
    g.set(5)
    g.inc(2)
    g.dec(3)
    h = reg.histogram("lat", "latency", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
    snap = reg.snapshot()
    assert obs.metric_value(snap, "req_total") == 5.0
    assert obs.metric_value(snap, "req_total", kind="a") == 2.0
    assert obs.metric_value(snap, "depth") == 4.0
    hv = snap[("lat", ())]
    assert hv.count == 3 and hv.sum == 55.5
    assert hv.bucket_counts == (1, 2, 3)
    with pytest.raises(TypeError):
        reg.gauge("req_total")
    with pytest.raises(ValueError):
        c.inc(-1)


def test_registry_diff_and_exports():
    reg = MetricsRegistry()
    reg.counter("c").inc(1, tier="indexed")
    reg.gauge("g").set(7)
    reg.histogram("h").observe(3.0)
    before = reg.snapshot()
    reg.counter("c").inc(4, tier="indexed")
    reg.counter("c").inc(2, tier="dense")
    reg.gauge("g").set(9)
    reg.histogram("h").observe(5.0)
    d = reg.diff(before)
    assert obs.metric_value(d, "c", tier="indexed") == 4.0
    assert obs.metric_value(d, "c", tier="dense") == 2.0
    assert obs.metric_value(d, "g") == 9.0
    assert obs.metric_value(d, "h") == 1.0
    txt = reg.to_prometheus_text()
    assert "# TYPE c counter" in txt
    assert 'c{tier="indexed"} 5' in txt
    assert 'h_bucket{le="+Inf"} 2' in txt
    assert "h_sum 8.0" in txt and "h_count 2" in txt
    doc = json.loads(reg.to_json())
    assert {m["name"] for m in doc} == {"c", "g", "h"}


# -- chrome trace + report ---------------------------------------------------

def test_chrome_trace_roundtrips_through_report(tmp_path):
    with obs.capture() as cap:
        with obs.span("phase.a", "plan", worker=0, round=1):
            obs.event("tick", "retry")
    path = str(tmp_path / "trace.json")
    cap.write_chrome_trace(path)
    events = obs_report.load_trace(path)
    rep = obs_report.build_report(events)
    assert rep["num_spans"] == 1 and rep["num_instants"] == 1
    assert rep["phases"]["plan"]["phase.a"]["count"] == 1
    assert rep["workers"]["0"]["count"] == 1
    assert rep["rounds"]["1"]["count"] == 1
    text = obs_report.format_report(rep)
    assert "phase.a" in text and "worker" in text
    assert obs_report.main([path]) == 0
    assert obs_report.main([path, "--json"]) == 0


@pytest.mark.parametrize("doc,msg", [
    ([{"name": "x"}], "no phase"),
    ([{"ph": "X", "name": "x", "ts": 0}], "bad dur"),
    ([{"ph": "X", "ts": 0, "dur": 1}], "no name"),
    ([{"ph": "i", "name": "x", "ts": "zero"}], "non-numeric ts"),
    ({"foo": []}, "missing 'traceEvents'"),
    ("nope", "top level"),
])
def test_malformed_trace_fails(tmp_path, doc, msg):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(obs_report.TraceFormatError, match=msg):
        obs_report.load_trace(path)
    assert obs_report.main([path]) == 1
    with pytest.raises(ref_report.TraceFormatError) as want:
        ref_report.load_trace(path)
    with pytest.raises(obs_report.TraceFormatError) as got:
        obs_report.load_trace(path)
    assert str(got.value) == str(want.value)


# -- engine parity matrix ----------------------------------------------------

def _engines(data, cfg):
    return (ref_core.SelfJoinEngine(data, ref_core.SelfJoinConfig(**cfg)),
            SelfJoinEngine(data, SelfJoinConfig(**cfg), device="cpu"))


# the port's spans that the reference has no counterpart of: the index
# build's phases and the copies of a join's answer to the host
PORT_ONLY = ("snapshot.", "engine.count.readback", "engine.pairs.readback")


def _span_counts(cap):
    """(name, category) counts, without the reference's "compile" instants
    (``engine.trace`` marks an XLA trace (a jit cache miss, so it depends on
    what the process compiled before); the port builds no programs) and
    without the port's own spans (``PORT_ONLY``): the port's spans are a
    superset of the reference's."""
    return collections.Counter((e.name, e.cat) for e in cap.events
                               if e.cat != "compile" and not e.name.startswith(PORT_ONLY))


@pytest.mark.parametrize("execution", ["indexed", "dense"])
def test_engine_dispatch_span_parity(dataset_case, execution):
    name, data, eps = dataset_case
    ref, eng = _engines(data, dict(eps=eps, k=4, tile_size=16, execution=execution))
    with obs.capture() as cap, ref_obs.capture() as ref_cap:
        cres = eng.count()
        pres = eng.pairs()
        ref.count()
        ref.pairs()
    expect = cres.stats.num_device_dispatches + pres.stats.num_device_dispatches
    assert cap.span_count(cat="dispatch") == expect, name
    assert cap.metric("selfjoin_device_dispatches_total", path="engine") == expect
    assert cap.metric("selfjoin_joins_total", path="engine") == 2
    assert cap.metric("selfjoin_results_total", path="engine", mode="pairs") == pres.stats.num_results
    np.testing.assert_array_equal(cres.counts, brute_counts(data, eps))
    assert pair_set(pres.pairs) == pair_set(brute_pairs(data, eps)), name
    # the same spans and metric values as the reference's, and the port's own
    assert _span_counts(cap) == _span_counts(ref_cap), name
    assert cap.span_count("engine.count.readback", "copy") == cap.span_count("engine.pairs.readback", "copy") == 1
    for metric in ("selfjoin_device_dispatches_total", "selfjoin_joins_total", "selfjoin_chunks_total",
                   "selfjoin_candidates_total", "selfjoin_results_total", "selfjoin_overflow_retries_total"):
        for mode in ("count", "pairs"):
            assert cap.metric(metric, path="engine", mode=mode) == ref_cap.metric(
                metric, path="engine", mode=mode), (metric, mode)


def test_engine_overflow_retry_events():
    d = make_dataset("clustered", 301, 8, seed=7)
    ref, eng = _engines(d, dict(eps=0.25, k=4, tile_size=16))
    truth = pair_set(brute_pairs(d, 0.25))
    with obs.capture() as cap, ref_obs.capture() as ref_cap:
        res = eng.pairs(_cap_hint=1)
        ref.pairs(_cap_hint=1)
    assert res.stats.overflow_retries >= 1
    assert cap.span_count(cat="retry") == res.stats.overflow_retries
    assert cap.span_count(cat="dispatch") == res.stats.num_device_dispatches
    assert cap.metric("selfjoin_overflow_retries_total", path="engine") == res.stats.overflow_retries
    assert pair_set(res.pairs) == truth
    assert _span_counts(cap) == _span_counts(ref_cap)
    assert [e.attrs["kind"] for e in cap.spans(cat="retry")] == [e.attrs["kind"] for e in ref_cap.spans(cat="retry")]


def test_index_auto_compact_span():
    pts = make_dataset("uniform", 64, 3, seed=2)
    idx = SimilarityIndex(pts, SelfJoinConfig(eps=0.2, k=2, tile_size=16), auto_compact_fraction=0.25,
                          device="cpu")
    ref = RefIndex(pts, ref_core.SelfJoinConfig(eps=0.2, k=2, tile_size=16), auto_compact_fraction=0.25)
    more = make_dataset("uniform", 40, 3, seed=3)
    with obs.capture() as cap, ref_obs.capture() as ref_cap:
        idx.insert(more)  # trips the spill
        ref.insert(more)
    assert idx.auto_compactions >= 1
    assert idx.auto_compactions == ref.auto_compactions
    for name in ("index.auto_compact", "index.prepare_compact", "index.apply_compact"):
        assert cap.span_count(name, "index") == ref_cap.span_count(name, "index") == idx.auto_compactions
    assert cap.metric("index_auto_compactions_total") == idx.auto_compactions
    assert cap.metric("index_compactions_total") == idx.auto_compactions
    assert _span_counts(cap) == _span_counts(ref_cap)


# -- the chunk loops ---------------------------------------------------------

def _join(eng, mode, data):
    """One join of ``mode`` on ``eng``: (the result, its dispatch spans' names)."""
    if mode == "count":
        return eng.count(), "engine.count.chunk"
    if mode == "count_query":
        return eng.count_query(data[:97]), "engine.count.chunk"
    return eng.pairs(), "engine.pairs.chunk"


MODES = ["count", "count_query", "pairs"]


@pytest.mark.parametrize("mode", MODES)
def test_untraced_chunk_loops_call_the_tracer_once_a_join(monkeypatch, mode):
    """Tracing off, a join makes as many tracer calls at one tile pair a
    chunk as at the default chunks: none of them per chunk."""
    d = make_dataset("exponential", 403, 16, seed=5)
    cfg = SelfJoinConfig(eps=0.06, k=4, tile_size=16)
    calls = collections.Counter()
    for name in ("span", "event", "span_series", "chunk_loop", "enabled", "inc", "observe", "set_gauge",
                 "mirror_selfjoin_stats"):
        real = getattr(obs, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(obs, name, counted)
    seen = {}
    for label, ecfg in (("default", EngineConfig()), ("one", EngineConfig(count_chunk=1, pairs_chunk=1))):
        eng = SelfJoinEngine(d, cfg, ecfg, device="cpu")
        calls.clear()
        res, _ = _join(eng, mode, d)
        seen[label] = (res.stats.num_device_dispatches, dict(calls))
    assert seen["one"][0] > 10 * seen["default"][0] > 0
    assert seen["one"][1] == seen["default"][1]
    assert obs.event_count() == 0


@pytest.mark.parametrize("mode", MODES)
def test_traced_chunk_spans_are_contiguous_inside_their_join(mode):
    d = make_dataset("exponential", 403, 16, seed=5)
    eng = SelfJoinEngine(d, SelfJoinConfig(eps=0.06, k=4, tile_size=16),
                         EngineConfig(count_chunk=3, pairs_chunk=3), device="cpu")
    with obs.capture() as cap:
        res, chunk = _join(eng, mode, d)
    assert cap.span_count(cat="dispatch") == res.stats.num_device_dispatches > 1
    assert cap.span_count(chunk, "dispatch") == res.stats.num_chunks
    join = cap.spans(cat="join")
    assert len(join) == 1
    join = join[0]
    spans = cap.spans(chunk)
    assert {e.depth for e in spans} == {join.depth + 1}
    assert join.ts_us <= spans[0].ts_us and spans[-1].ts_us + spans[-1].dur_us <= join.ts_us + join.dur_us
    for a, b in zip(spans, spans[1:]):
        assert a.ts_us + a.dur_us == pytest.approx(b.ts_us, abs=1e-6)
    readback = cap.spans(chunk.rsplit(".", 1)[0] + ".readback", "copy")
    assert len(readback) == 1
    assert readback[0].ts_us >= spans[-1].ts_us + spans[-1].dur_us - 1e-6
    if mode != "pairs":  # the pairs' copies follow their join span
        assert readback[0].ts_us + readback[0].dur_us <= join.ts_us + join.dur_us
        assert readback[0].depth == join.depth + 1


def test_a_small_capture_drops_exactly_the_excess():
    d = make_dataset("exponential", 403, 16, seed=5)
    cfg, ecfg = SelfJoinConfig(eps=0.06, k=4, tile_size=16), EngineConfig(count_chunk=2)
    with obs.capture() as full:
        res = SelfJoinEngine(d, cfg, ecfg, device="cpu").count()
    chunks = res.stats.num_chunks
    names = [e.name for e in full.events]
    assert full.dropped == 0 and chunks > 8
    for capacity in (5, chunks - 3, len(names) - 1):
        with obs.capture(capacity) as cap:
            SelfJoinEngine(d, cfg, ecfg, device="cpu").count()
        assert cap.dropped == len(names) - capacity
        assert [e.name for e in cap.events] == names[-capacity:]


@pytest.mark.parametrize("execution,reorder", [("indexed", True), ("dense", True), ("indexed", False)])
def test_index_build_phase_spans(execution, reorder):
    """The build's four phases nest in its span; the dense tables and each
    chunk size's list fire on their first join only."""
    d = make_dataset("exponential", 403, 16, seed=5)
    cfg = SelfJoinConfig(eps=0.06, k=4, tile_size=16, execution=execution, reorder=reorder)
    phases = ["snapshot.reorder"] * reorder + ["snapshot.grid", "snapshot.tile_plan", "snapshot.tables"]
    with obs.capture() as cap:
        eng = SelfJoinEngine(d, cfg, EngineConfig(count_chunk=8, pairs_chunk=4), device="cpu")
    build = cap.spans("engine.snapshot_build", "plan")[0]
    got = [e for e in cap.events if e.name.startswith("snapshot.")]
    assert [e.name for e in got] == phases
    for e in got:
        assert e.cat == "plan" and e.depth == build.depth + 1
        assert build.ts_us <= e.ts_us and e.ts_us + e.dur_us <= build.ts_us + build.dur_us
    plan = eng.snapshot.plan
    assert cap.spans("snapshot.tile_plan")[0].attrs == {
        "tiles": plan.num_tiles, "pairs": plan.num_pairs, "pairs_total": plan.num_tile_pairs_total, "path": "cpu"}
    lazy = ["snapshot.dense_tables"] * (execution == "dense") + ["snapshot.chunks"]
    with obs.capture() as cap:
        eng.count(0.05)
        eng.count(0.06)
        eng.pairs(0.06)
    names = [e.name for e in cap.events if e.name.startswith("snapshot.")]
    assert names == lazy + ["snapshot.chunks"]  # the pairs' chunk size
    assert [e.attrs["chunk"] for e in cap.spans("snapshot.chunks")] == [8, 4]
    with obs.capture() as cap:
        eng.count(0.06)
        eng.pairs(0.06)
    assert not [e for e in cap.events if e.name.startswith("snapshot.")]
    with obs.capture() as cap:
        eng.count(0.08)  # over the index's radius: a rebuild in the REORDER frame
    rebuild = cap.spans("engine.snapshot_rebuild", "plan")[0]
    got = [e for e in cap.events if e.name.startswith("snapshot.")
           and rebuild.ts_us <= e.ts_us <= rebuild.ts_us + rebuild.dur_us]
    assert [e.name for e in got] == phases and {e.depth for e in got} == {rebuild.depth + 1}
    assert [e.name for e in cap.events if e.name.startswith("snapshot.") and e not in got] == lazy


def test_spans_and_the_profiler_share_one_clock():
    """Under the bridge each span starts on the Unix clock just after its
    ``record_function`` range, and the Chrome export writes that time."""
    d = make_dataset("exponential", 403, 16, seed=5)
    eng = SelfJoinEngine(d, SelfJoinConfig(eps=0.06, k=4, tile_size=16), EngineConfig(count_chunk=16),
                         device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):  # the first range's one-time set-up
            pass
        with obs.capture(torch_bridge=True) as cap:
            eng.count()
            eng.pairs()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    spans = [e for e in cap.events if e.ph == "X"]
    ranges = collections.defaultdict(list)
    for e in prof.events():
        ranges[e.name].append(t0 + e.time_range.start * 1e3)
    starts = collections.defaultdict(list)
    for e in spans:
        starts[e.name].append(cap.epoch_ns + e.ts_us * 1e3)
    assert len(spans) > 20
    for name, got in starts.items():
        want = sorted(ranges[name])
        assert len(want) == len(got), name
        for g, w in zip(sorted(got), want):
            assert -50e3 <= g - w <= 1e6, (name, g - w)
    chrome = [e for e in cap.chrome_trace()["traceEvents"] if e["ph"] == "X"]
    for e, c in zip(spans, chrome):
        assert c["ts"] == pytest.approx(cap.epoch_ns / 1e3 + e.ts_us, abs=1.0)


# -- cross-package reports ---------------------------------------------------

def test_reports_read_each_others_traces(tmp_path):
    """The same join traced by each package; each package's report reads
    both traces, and the two reports of one trace are the same dict."""
    d = make_dataset("exponential", 403, 16, seed=5)
    ref, eng = _engines(d, dict(eps=0.06, k=4, tile_size=16))
    with obs.capture() as cap, ref_obs.capture() as ref_cap:
        eng.count()
        eng.pairs()
        ref.count()
        ref.pairs()
    port_path, ref_path = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    cap.write_chrome_trace(port_path)
    ref_cap.write_chrome_trace(ref_path)
    reports = {}
    for path in (port_path, ref_path):
        got = obs_report.build_report(obs_report.load_trace(path))
        assert got == ref_report.build_report(ref_report.load_trace(path))
        assert obs_report.format_report(got) == ref_report.format_report(got)
        reports[path] = got
    a, b = reports[port_path], reports[ref_path]
    compiles = ref_cap.span_count(cat="compile")
    own = sum(e.name.startswith(PORT_ONLY) for e in cap.events)
    assert own > 0
    assert (a["num_spans"] - own, a["num_instants"]) == (b["num_spans"], b["num_instants"] - compiles)

    def shared(rep):
        counts = {c: {n: v["count"] for n, v in names.items() if not n.startswith(PORT_ONLY)}
                  for c, names in rep["phases"].items() if c != "compile"}
        return {c: names for c, names in counts.items() if names}

    assert shared(a) == shared(b)
    # the CLI, as a user runs it
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", ref_path, "--json"],
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == b
    with open(ref_path) as f:
        text = f.read()
    bad = tmp_path / "truncated.json"
    bad.write_text(text[: len(text) // 2])
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", str(bad)],
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "cannot parse trace" in out.stderr


# -- the torch.profiler bridge ----------------------------------------------

def _ranges(prof, names):
    """Profiler ranges by name, restricted to ``names``."""
    return collections.Counter(e.name for e in prof.events() if e.name in names)


@pytest.mark.parametrize("bridge", [True, False])
def test_bridge_ranges_equal_spans(bridge):
    d = make_dataset("clustered", 403, 32, seed=22)
    eng = SelfJoinEngine(d, SelfJoinConfig(eps=0.25, k=4, tile_size=16), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.capture(torch_bridge=bridge) as cap:
            cres = eng.count()
            pres = eng.pairs()
    assert _state.bridge is None
    spans = collections.Counter(e.name for e in cap.events if e.ph == "X")
    got = _ranges(prof, set(spans))
    if not bridge:
        assert got == collections.Counter()
        return
    assert got == spans
    dispatch = {e.name for e in cap.spans(cat="dispatch")}
    assert sum(got[n] for n in dispatch) == cres.stats.num_device_dispatches + pres.stats.num_device_dispatches
    assert got["engine.count.chunk"] == cres.stats.num_chunks
    assert got["engine.count"] == 1


def test_bridge_closes_ranges_on_an_exception():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.capture(torch_bridge=True) as cap:
            with pytest.raises(RuntimeError, match="boom"):
                with obs.span("bridge.fails", "test"):
                    raise RuntimeError("boom")
            with obs.span("bridge.after", "test"):
                pass
    evts = {e.name: e for e in prof.events() if e.name.startswith("bridge.")}
    assert set(evts) == {"bridge.fails", "bridge.after"}
    assert evts["bridge.after"].cpu_parent is None or evts["bridge.after"].cpu_parent.name != "bridge.fails"
    assert evts["bridge.after"].time_range.start >= evts["bridge.fails"].time_range.end
    assert cap.span_count("bridge.fails") == cap.span_count("bridge.after") == 1


def test_nested_capture_restores_the_enclosing_bridge():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.capture(torch_bridge=True) as outer:
            with obs.capture() as inner:  # no bridge inside
                with obs.span("nested.inner", "test"):
                    pass
            with obs.span("nested.outer", "test"):  # the enclosing window's bridge again
                pass
        obs.enable()
        try:
            with obs.capture(torch_bridge=True):
                pass
            with obs.span("nested.plain", "test"):  # an enable() window without a bridge stays so
                pass
        finally:
            obs.disable()
            obs.clear()
        obs.enable(torch_bridge=True)
        obs.disable()
        obs.enable()  # disable() dropped the bridge
        try:
            with obs.span("nested.after_disable", "test"):
                pass
        finally:
            obs.disable()
            obs.clear()
    assert inner.span_count("nested.inner") == 1 and outer.span_count("nested.outer") == 1
    names = {"nested.inner", "nested.outer", "nested.plain", "nested.after_disable"}
    assert _ranges(prof, names) == collections.Counter({"nested.outer": 1})
