"""The readers of the program's spans on planted traces: idle time outside
the spans is not counted, overlapping spans count once, and a reader finds
nothing without a trace or without its spans (the program before it
recorded them)."""

import types

import pytest

from benchmark import harness, tracing

WAIT = ("host_wait_ms.exact", "host_wait_ms.batch")
BUILD = ("build_host_s", "build_repair_s")


def _rec(device, host, window=(0, 10_000), calls=2):
    lo, hi = window
    busy = tracing.union_ns([(s, e) for _, s, e in device])
    t = {"device": device, "host": host, "window_ns": window, "window_s": (hi - lo) / 1e9,
         "busy_s": busy / 1e9, "calls": calls, "launches": {}, "counters": {}}
    return types.SimpleNamespace(trace=t, shapes={}, infos=[], calls=[])


# the device busy over [1000, 3000) and [6000, 9000) of a 10,000 ns window
DEVICE = [("scan_kloop_kernel", 1000, 2500), ("gatherTopK", 2000, 3000),
          ("scan_kloop_kernel", 6000, 9000)]


@pytest.mark.parametrize("name", WAIT)
def test_host_wait_counts_idle_under_the_call_spans_once(name):
    host = [("search.call", 500, 4000), ("search.prepare", 500, 900),  # a call and its child
            ("search.call", 3500, 9500),                                 # overlapping the first
            ("aten::copy_", 9600, 9900)]                                 # idle outside every call
    # idle stretches: [0, 1000), [3000, 6000), [9000, 10000); under the calls'
    # union [500, 9500): 500 + 3000 + 500 = 4000 ns over 2 calls
    got = harness.reader(name).read(_rec(DEVICE, host))
    assert got == pytest.approx(4000 / 2 / 1e6)
    # a span that pokes out of the window counts inside it only
    wide = [("search.call", -5000, 20_000)]
    assert harness.reader(name).read(_rec(DEVICE, wide)) == pytest.approx(5000 / 2 / 1e6)


def test_build_host_takes_its_spans_union_under_idle():
    host = [("build.insert", 0, 10_000),            # the root: not a host stage
            ("build.setup", 0, 1500), ("build.plan", 1200, 1800),
            ("build.round", 1800, 6000), ("build.part.build", 1800, 6000),
            ("program.capture", 4000, 5000),         # idle under a round part
            ("program.capture", 4500, 5500),         # overlapping the first
            ("build.flush", 8500, 9200), ("build.repair", 9200, 10_000)]
    # idle [0, 1000) under setup; [3000, 6000) under the captures' union
    # [4000, 5500): 1500; [9000, 10000) under flush and repair: 1000
    got = harness.reader("build_host_s").read(_rec(DEVICE, host, calls=1))
    assert got == pytest.approx((1000 + 1500 + 1000) / 1e9)
    # the repair's wall, device time included
    got = harness.reader("build_repair_s").read(_rec(DEVICE, host, calls=1))
    assert got == pytest.approx(800 / 1e9)
    twice = host + [("build.repair", 8000, 9600)]  # overlapping repair spans count once
    got = harness.reader("build_repair_s").read(_rec(DEVICE, twice, calls=1))
    assert got == pytest.approx(2000 / 1e9)


def test_idle_outside_the_spans_is_not_counted():
    host = [("search.call", 1000, 3000), ("build.setup", 6000, 9000)]  # all busy under them
    for name in WAIT + ("build_host_s",):
        assert harness.reader(name).read(_rec(DEVICE, host)) == 0.0
    # no device interval at all: the whole span is idle
    assert harness.reader("host_wait_ms.exact").read(
        _rec([], [("search.call", 1000, 3000)], calls=1)) == pytest.approx(2000 / 1e6)


@pytest.mark.parametrize("name", WAIT + BUILD)
def test_readers_find_nothing_without_a_trace_or_their_spans(name):
    assert harness.reader(name).read(
        types.SimpleNamespace(trace=None, shapes={}, infos=[None], calls=[])) is None
    # a parent program's trace: aten operations and graph launches, no span
    host = [("aten::copy_", 0, 2000), ("cudaGraphLaunch", 3000, 3100),
            ("cudaStreamSynchronize", 9000, 9500)]
    assert harness.reader(name).read(_rec(DEVICE, host)) is None
    assert harness.reader(name).read(_rec(DEVICE, host, calls=0)) is None
