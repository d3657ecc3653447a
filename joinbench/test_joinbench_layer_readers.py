"""The index build's and the chunk loop's readers, on a made-up context."""
from types import SimpleNamespace

import pytest

from joinbench import devtrace, spec
from joinbench.harness import Context

SETUP = [("engine.snapshot_build", 9.0e6), ("snapshot.reorder", 1.0e6), ("snapshot.grid", 2.0e6),
         ("snapshot.tile_plan", 3.0e6), ("snapshot.tables", 0.5e6), ("snapshot.chunks", 0.25e6),
         ("snapshot.dense_tables", 0.125e6)]
READS = {"reorder_s": 1.0, "grid_build_s": 2.0, "tile_plan_s": 3.0, "tables_to_card_s": 0.625,
         "chunk_upload_s": 0.25}


def span(name, dur_us=1.0):
    return SimpleNamespace(name=name, dur_us=dur_us)


def context(mode="count", setup=(), spans=(), trace=None):
    cell = spec.Cell(name="c", config_name="k", config={}, traffic_name="t", traffic={"mode": mode},
                     end_to_end=[], per_layer=[])
    return Context(cell=cell, joins=[], window_s=0.0, setup_spans=[span(n, d) for n, d in setup],
                   spans=list(spans), trace=trace)


@pytest.mark.parametrize("name", sorted(READS))
def test_index_build_parts_read_their_setup_spans(name):
    read = spec.load_reader(name).read
    assert read(context(setup=SETUP)) == pytest.approx(READS[name])
    # absent where the program has no such span (an older program, REORDER off)
    assert read(context(setup=[("engine.snapshot_build", 9.0e6)])) is None


def test_launch_idle_reads_the_gaps_inside_chunk_spans():
    read = spec.load_reader("launch_idle_pct.count").read
    trace = devtrace.DeviceTrace(window=(0.0, 2.0), busy_s=1.5, kernels={}, ops={}, records=1,
                                 idle_by_span={"engine.count.chunk": 0.3, "engine.count.readback": 0.2})
    chunks = [span("engine.count.chunk")]
    assert read(context(spans=chunks, trace=trace)) == pytest.approx(15.0)
    trace.idle_by_span.pop("engine.count.chunk")  # no gap fell inside a launch
    assert read(context(spans=chunks, trace=trace)) == 0.0
    assert read(context(spans=chunks)) is None                          # untraced
    assert read(context(trace=trace)) is None                           # no chunk spans
    assert read(context(mode="pairs", spans=chunks, trace=trace)) is None
