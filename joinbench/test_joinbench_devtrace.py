"""The reading of a profiler session, on made-up events."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from joinbench import devtrace


def ev(name, start_us, end_us, device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device, time_range=SimpleNamespace(start=start_us, end=end_us))


def test_busy_idle_kernels_and_gaps_named_by_span():
    k = "void dense::dense_kernel<4, 2, 0>(dense::Args)"
    events = [
        ev(devtrace.JOIN_RANGE, 100, 1100, DeviceType.CPU),
        ev("cudaLaunchKernel", 150, 160, DeviceType.CPU),
        ev(devtrace.JOIN_RANGE, 100, 1100),                   # the range's mirror on the device: not work
        ev(k, 200, 400), ev(k, 300, 500),                     # overlap: busy 200-500
        ev("void dense::dense_kernel<4, 3, 0>(dense::Args)", 600, 700),
        ev("Memcpy DtoH (Device -> Pageable)", 900, 1000),
        ev(k, 2000, 2100),                                    # after the window
    ]
    # host spans on their own clock, 50 us behind the profiler's
    spans = [("joinbench.join", 50e-6, 1050e-6, 0), ("engine.pairs", 60e-6, 760e-6, 1),
             ("engine.pairs.chunk", 100e-6, 160e-6, 2)]
    tr = devtrace.read_events(events, spans, [50e-6])
    assert tr.window == (100e-6, 1100e-6)
    assert tr.busy_s == pytest.approx(500e-6)
    assert tr.kernels[("dense_kernel", 2)] == pytest.approx([200e-6, 200e-6])
    assert tr.kernel_mean_s(("dense_kernel", 3)) == pytest.approx(100e-6)
    assert tr.records == 4
    # gaps: 100-200 (mid 150: the chunk span), 500-600 and 700-900 (engine.pairs), 1000-1100 (the join)
    assert tr.idle_by_span == pytest.approx({"engine.pairs.chunk": 100e-6, "engine.pairs": 300e-6,
                                             "joinbench.join": 100e-6})
    b = tr.breakdown()
    assert b["device_ops"][0] == ["dense_kernel<4,2,0>", pytest.approx(400e-6)]
    assert b["idle_gaps"][0] == ["engine.pairs", pytest.approx(300e-6)]


def test_kernel_key_and_merge():
    assert devtrace.kernel_key("void k1::k1_kernel<4, 1, 16>(k1::Args, k1::Pairs)") == ("k1_kernel", 1)
    assert devtrace.kernel_key("Memcpy HtoD") is None
    assert devtrace.merge([(3, 4), (1, 2), (1.5, 3.5)]) == [(1, 4)]
    assert devtrace.gaps([(2, 3)], 1, 5) == [(1, 2), (3, 5)]
