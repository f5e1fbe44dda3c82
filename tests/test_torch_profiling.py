"""The port's tracing (``hnsw_tpu_torch/utils/profiling.py``) on the CPU:
off, a span is one shared no-op and nothing reaches a record, a report or a
``torch.profiler`` trace; on, the calling thread's spans sit in the
profiler's trace nested in time and on its clock, every record carries its
root's call id (the pipeline's worker threads' too), and the build sums its
counters over builds."""

import contextlib
import itertools
import tracemalloc

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from hnsw_tpu_torch import BruteForceIndex, Hnsw
from hnsw_tpu_torch.ops import program
from hnsw_tpu_torch.ops.beam_search import device_search_stream
from hnsw_tpu_torch.utils.profiling import PROFILER, enable_profiling

torch.set_num_threads(2)

CALLING = {"search.call", "search.prepare", "search.finish", "stream.start", "stream.wait",
           "stream.dispatch", "stream.drain"}
WORKERS = {"stream.upload", "stream.stage", "stream.fetch"}
GAUGES = ("build.keys", "build.pool_bytes", "build.uncaptured_keys", "build.points")


@pytest.fixture
def profiling():
    """The global profiler on and empty for the test, then off and empty."""
    was = PROFILER.enabled
    PROFILER.reset()
    enable_profiling()
    try:
        yield PROFILER
    finally:
        enable_profiling(was)
        PROFILER.reset()


@pytest.fixture
def profiling_off():
    was = PROFILER.enabled
    PROFILER.reset()
    enable_profiling(False)
    try:
        yield PROFILER
    finally:
        enable_profiling(was)
        PROFILER.reset()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    return rng.random((900, 8)).astype(np.float32), rng.random((96, 8)).astype(np.float32)


@pytest.fixture(scope="module")
def index(data):
    h = Hnsw(max_nb_connection=8, max_elements=1000, ef_construction=32, dist="L2",
             device="cpu")
    h.parallel_insert(data[0], mode="device", batch_size=128)
    return h


@pytest.fixture(scope="module")
def exact(data):
    """A ``BruteForceIndex`` on its scan route (``l2_topk_stream``, the
    pipelined stream) at this small size."""
    bf = BruteForceIndex("L2", device="cpu")
    bf.SCAN_MIN_POINTS = 1
    bf.parallel_insert(data[0])
    return bf


def _searches(index, exact, Q):
    """A 3-batch ``device_search_stream`` and an exact ``search_batch`` of 3
    stream batches of 2048, 2048 and 512 queries."""
    device_search_stream(index, Q, 5, 16, batch=32)
    exact.search_batch(np.tile(Q, (48, 1)), 5)


def _traced(fn):
    """The profiler's host events of ``fn``: [(name, start ns, end ns)]."""
    with record_function("warm"):  # the process' first one resolves its operator
        pass
    with profile(activities=[ProfilerActivity.CPU]) as p:
        fn()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in p.profiler.kineto_results.events()]


def _span_bytes(n: int) -> tuple:
    """(bytes left allocated, peak bytes above the start) over ``n`` spans
    with a counter bump inside each."""
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in itertools.repeat(None, n):
            with PROFILER.span("search.call"):
                PROFILER.add("stream.queries")
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return now - before, peak - before


def test_disabled_span_is_one_shared_no_op(profiling_off):
    a, b = PROFILER.span("search.call"), PROFILER.span("build.round", (1, 1))
    assert a is b and not hasattr(a, "__dict__")
    assert PROFILER.current() is None
    with a:
        PROFILER.add("stream.queries", 3)
    # the tracer's own bookkeeping is the same for 10 spans as for 5000
    assert _span_bytes(10) == _span_bytes(5000) and _span_bytes(5000)[0] == 0
    assert PROFILER.events() == [] and PROFILER.report() == {}
    enable_profiling()  # the same measure sees an enabled span's allocations
    assert _span_bytes(5000)[0] > 5000 * 16
    enable_profiling(False)


def test_disabled_leaves_no_record_report_or_trace_span(profiling_off, index, exact, data):
    _searches(index, exact, data[1])  # the first call of each shape outside the trace
    events = _traced(lambda: _searches(index, exact, data[1]))
    names = {n for n, _, _ in events}
    assert not names & (CALLING | WORKERS)
    assert not any(n.startswith(("search.", "stream.", "build.", "program.")) for n in names)
    assert PROFILER.events() == [] and PROFILER.report() == {}


def test_disabled_build_records_nothing(profiling_off, data):
    h = Hnsw(max_nb_connection=8, max_elements=400, ef_construction=24, dist="L2",
             device="cpu")
    h.parallel_insert(data[0][:300], mode="device", batch_size=64)
    assert len(h) == 300
    assert PROFILER.events() == [] and PROFILER.report() == {}


def _calls(records, name="search.call"):
    return sorted((r for r in records if r.name == name), key=lambda r: r.start_ns)


def test_calling_thread_spans_nest_in_the_profilers_trace(profiling, index, exact, data):
    _searches(index, exact, data[1])
    PROFILER.reset()
    events = _traced(lambda: _searches(index, exact, data[1]))
    names = {n for n, _, _ in events}
    assert CALLING <= names
    assert not names & WORKERS  # the profiler records the thread that started it
    roots = sorted((s, e) for n, s, e in events if n == "search.call")
    assert len(roots) == 2
    for n, s, e in events:
        if n in CALLING - {"search.call"}:
            assert any(a <= s and e <= b for a, b in roots), n
    # each call's children, in the records: three dispatches a call, the
    # stream's stages in order, prepare first and (exact) finish last
    recs = PROFILER.events()
    for root in _calls(recs):
        kids = sorted((r for r in recs if r.parent == root.span), key=lambda r: r.start_ns)
        on_thread = [r.name for r in kids if r.thread == root.thread]
        assert on_thread.count("stream.dispatch") == 3
        assert on_thread[0] == "search.prepare" and "stream.drain" in on_thread
        assert on_thread.index("stream.start") < on_thread.index("stream.wait")
        for r in kids:
            assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
    assert _calls(recs, "search.finish")


def test_worker_records_carry_their_roots_call_id(profiling, index, exact, data):
    for _ in range(2):
        _searches(index, exact, data[1])
    recs = PROFILER.events()
    roots = _calls(recs)
    assert len(roots) == 4 and len({r.call for r in roots}) == 4
    assert all(r.parent is None for r in roots)
    by_call = {r.call: r for r in roots}
    spans = {r.span: r for r in recs}
    for r in recs:
        assert r.call in by_call  # no record outside a call
        root = by_call[r.call]
        if r.name in WORKERS:
            assert r.thread != root.thread
            assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
        if r.parent is not None:  # a parent is of the same call
            assert spans[r.parent].call == r.call
    for root in roots:
        mine = [r for r in recs if r.call == root.call]
        assert sum(r.name == "stream.upload" for r in mine) == 3
        assert sum(r.name == "stream.fetch" for r in mine) == 3
        assert sum(r.name == "stream.stage" for r in mine) == 3
        stage = [r for r in mine if r.name == "stream.stage"]
        assert all(spans[r.parent].name == "stream.upload" for r in stage)
    assert PROFILER.report()["counters"]["stream.queries"] == 2 * len(data[1])


def test_records_agree_with_the_profilers_events(profiling, index, exact, data):
    """On the spans that run while no pipeline thread does: elsewhere a
    worker may hold the interpreter lock between the profiler's timestamp
    and the record's, for up to the switch interval."""
    _searches(index, exact, data[1])
    PROFILER.reset()
    events = _traced(lambda: _searches(index, exact, data[1]))
    recs = PROFILER.events()
    worst = 0
    for name in ("search.call", "search.prepare", "search.finish"):
        prof = sorted((s, e) for n, s, e in events if n == name)
        mine = sorted((r.start_ns, r.end_ns) for r in recs if r.name == name)
        assert len(prof) == len(mine) > 0, name
        for (ps, pe), (rs, re_) in zip(prof, mine):
            worst = max(worst, abs(ps - rs), abs(pe - re_))
    assert worst < 1_000_000  # 1 ms


class _Graph:
    def replay(self):
        pass


@contextlib.contextmanager
def _capture(graph):
    yield


class _Deferred(program.Piece):
    """As a CUDA graph does for a round: the capture runs nothing, each
    replay runs the piece once."""

    def __init__(self, fn, graph=None, capture=None):
        super().__init__(fn)
        self.graph = graph

    def replay(self):
        self.fn()


@pytest.mark.parametrize("form", ["eager", "programs"])
def test_builds_sum_rounds_and_add_no_gauge(profiling, monkeypatch, data, form):
    if form == "programs":  # the card's round programs, on stub graphs
        monkeypatch.setattr(program, "Piece", _Deferred)
        monkeypatch.setattr(program, "round_programs", lambda device, share=0.25:
                            program.BuildPrograms(device, _Graph, _capture, share))
    rounds = []
    for rows in (data[0][:400], data[0][400:800]):
        h = Hnsw(max_nb_connection=8, max_elements=500, ef_construction=24, dist="L2",
                 device="cpu")
        before = PROFILER.report().get("counters", {}).get("build.rounds", 0)
        h.parallel_insert(rows, mode="device", batch_size=64)
        rounds.append(PROFILER.report()["counters"]["build.rounds"] - before)
    rep = PROFILER.report()
    counters = rep["counters"]
    assert rounds[0] > 0 and rounds[1] > 0
    assert counters["build.rounds"] == sum(rounds) == rep["build.round"]["calls"]
    assert not set(GAUGES) & set(counters)
    names = {r.name for r in PROFILER.events()}
    assert {"build.insert", "build.setup", "build.plan", "build.round", "build.flush",
            "build.repair", "build.part.head", "build.part.build"} <= names
    inserts = _calls(PROFILER.events(), "build.insert")
    assert len(inserts) == 2 and inserts[0].call != inserts[1].call
    for r in PROFILER.events():
        assert r.call in {inserts[0].call, inserts[1].call}
    if form == "programs":
        assert counters["build.captures"] > 0 and "program.capture" in names
        assert h._round_stats["keys"] > 0  # the gauges stay in the build's stats
        caps = [r for r in PROFILER.events() if r.name == "program.capture"]
        spans = {r.span: r for r in PROFILER.events()}
        assert all(spans[r.parent].name.startswith("build.part.") for r in caps)
    else:
        assert "build.captures" not in counters
