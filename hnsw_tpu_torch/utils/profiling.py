"""The port's tracing: spans on the device trace's clock, span records keyed
by call, and counters (``hnsw_tpu/utils/profiling.py`` is the JAX package's
flat span registry, which this one extends).

Off by default: ``span`` then returns one shared no-op context manager
(nothing is allocated) and ``add`` returns at once. Enable with
``HNSW_PROFILE=1`` in the environment or ``enable_profiling()`` at run time.

An enabled span does two things on the thread that opens it:

* where a ``torch.profiler`` profile records that thread, it opens
  ``torch.profiler.record_function(name)``, so the trace holds the span
  beside the device's intervals, on the same clock (the benchmark's traced
  run names each idle stretch of the card by the innermost span over it:
  ``benchmark/tracing.py::breakdown``); elsewhere it skips it, which would
  reach no trace and cost about 12 us a span;
* it appends one ``SpanRecord`` (name, call id, span id, parent span id,
  thread, start and end in Unix-epoch nanoseconds, the profiler's clock) to
  a bounded list, ``PROFILER.events()``; past ``MAX_EVENTS`` records are
  counted in ``PROFILER.dropped`` and not kept.

A span opened with no span open on its thread is a root and takes the next
call id of a process-wide sequence; a nested span inherits its root's. A
thread inherits nothing, so code that hands work to a thread passes
``PROFILER.current()`` to the spans opened there (``within``). A
``torch.profiler`` profile records the thread that started it; the
pipeline's worker threads reach the records alone.

The spans (the calling thread's first):

* ``search.call``: one search entry (``device_search_stream``,
  ``Hnsw.search_batch``, ``BruteForceIndex.search_batch``,
  ``IvfFlatIndex.search_batch`` and ``search_stream``,
  ``ShardedHnsw.search_batch`` and ``search_stream``); ``search.prepare``
  (snapshot, codec, program lookup or capture) and ``search.finish`` (work
  on the answers: on the host, or ``ShardedHnsw``'s map to external ids on
  the first shard's device) inside it;
* ``shard.start`` (the queries copied to each shard's device, the programs
  started), ``shard.step`` (one chunk launched on the shards still running),
  ``shard.poll`` (the host reads of those shards' ``done``: the lockstep's
  wait on the slowest) and ``shard.merge`` (the shards' results masked and
  merged on the first shard's device): ``parallel/sharded.py``;
* ``stream.start`` (the pipeline's threads started), ``stream.wait`` (the
  dispatcher waiting for a staged batch), ``stream.dispatch`` and
  ``stream.drain`` (the last results fetched, the fetcher joined):
  ``ops/stream.py::pipelined_stream``;
* ``build.insert``: one device ``parallel_insert``; inside it
  ``build.setup`` (host state, vectors, levels and tables uploaded),
  ``build.plan`` (a round's host planning), ``build.round`` with one
  ``build.part.<kind>`` per part of the round (``round_plan``'s kinds:
  ``head``, ``descent``, ``build``, ``merge0``, ``merge_upper``),
  ``build.flush`` (the tables back to the host index, the round programs
  released) and ``build.repair`` (``ensure_navigable``);
* ``program.capture``: the capture of a program's CUDA graphs
  (``ops/program.py::Program._capture_all``), a host pass with the card idle;

and on the pipeline's worker threads ``stream.upload`` with ``stream.stage``
(pinned host buffer and copy) inside, and ``stream.fetch`` with
``stream.sync`` (the wait for the fetch stream) inside.

Counters (``PROFILER.add``): ``stream.queries`` (queries handed to the
device search stream); ``shard.steps`` (chunk launches summed over the
shards) and ``shard.idle_steps`` (per chunk, the shards already finished
while another still runs); ``build.rounds`` (device build rounds); on the card
the build's round programs' ``build.rounds_replayed``, ``build.first_runs``,
``build.captures``, ``build.capture_s``, ``build.chunk_graphs``,
``build.widen_replays`` and ``build.keep_replays`` (each build's own are in
``Hnsw._round_stats``).

Usage::

    from hnsw_tpu_torch.utils.profiling import enable_profiling, PROFILER
    enable_profiling()
    ... build / search ...
    PROFILER.report()   # the operator's view: totals by span name
    # {'build.flush': {'calls': 1, 'total_s': 0.41}, ..., 'search.call': ...,
    #  'counters': {'build.rounds': 54.0, 'stream.queries': 819200.0}}
    PROFILER.events()   # [SpanRecord(name='search.call', call=7, ...), ...]
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

MAX_EVENTS = 1 << 17


class SpanRecord(NamedTuple):
    name: str
    call: int                # the root span's call id
    span: int                # this span's id
    parent: Optional[int]    # the enclosing span's id; None for a root
    thread: int              # ``threading.get_ident()`` of the span's thread
    start_ns: int            # Unix-epoch ns, the profiler's clock
    end_ns: int


class _NoSpan:
    """The disabled span: one shared instance, nothing done."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("_prof", "_name", "_within", "_rf", "_call", "_id", "_parent", "_t0")

    def __init__(self, prof: "Profiler", name: str, within):
        self._prof, self._name, self._within = prof, name, within

    def __enter__(self):
        prof = self._prof
        stack = prof._stack()
        if stack:
            top = stack[-1]
            self._call, self._parent = top._call, top._id
        elif self._within is not None:
            self._call, self._parent = self._within
        else:
            self._call, self._parent = next(prof._calls), None
        self._id = next(prof._ids)
        stack.append(self)
        self._rf = None
        if _profiler_enabled():  # a profile records this thread
            self._rf = record_function(self._name)
            self._rf.__enter__()
        self._t0 = time.time_ns()  # inside the profiler's event, as close as can be
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._prof._stack().pop()
        self._prof._record(SpanRecord(self._name, self._call, self._id, self._parent,
                                      threading.get_ident(), self._t0, t1))
        return False


class Profiler:
    """Process-global spans, span records and counters (see the module
    docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._calls = itertools.count(1)
        self._ids = itertools.count(1)
        self._spans: dict[str, list] = {}  # name -> [calls, total_s]
        self._counters: dict[str, float] = {}
        self._events: list[SpanRecord] = []
        self.dropped = 0
        self.enabled = os.environ.get("HNSW_PROFILE", "0") == "1"

    def span(self, name: str, within=None):
        """A context manager over a scope (see the module docstring):
        ``within`` is another thread's ``current()``, for a span that opens
        a thread's work on that thread's call."""
        if not self.enabled:
            return _NO_SPAN
        return _Span(self, name, within)

    def current(self):
        """(call id, span id) of the innermost span open on this thread, or
        None: what a thread started here passes to its spans as ``within``."""
        if not self.enabled:
            return None
        stack = self._stack()
        return (stack[-1]._call, stack[-1]._id) if stack else None

    def add(self, name: str, value: float = 1.0):
        """Bump a counter."""
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def report(self) -> dict:
        """Snapshot: {span: {calls, total_s}, ..., 'counters': {...}}."""
        with self._lock:
            out = {k: {"calls": v[0], "total_s": round(v[1], 4)}
                   for k, v in sorted(self._spans.items())}
            if self._counters:
                out["counters"] = dict(sorted(self._counters.items()))
            return out

    def events(self) -> list:
        """The span records kept since the last ``reset``, in the order the
        spans closed."""
        with self._lock:
            return list(self._events)

    def reset(self):
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self._events.clear()
            self.dropped = 0

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            stack = self._local.stack = []
            return stack

    def _record(self, rec: SpanRecord):
        with self._lock:
            s = self._spans.setdefault(rec.name, [0, 0.0])
            s[0] += 1
            s[1] += (rec.end_ns - rec.start_ns) / 1e9
            if len(self._events) < MAX_EVENTS:
                self._events.append(rec)
            else:
                self.dropped += 1


PROFILER = Profiler()


def enable_profiling(on: bool = True):
    """Turn the global profiler on/off at runtime (HNSW_PROFILE=1 presets it)."""
    PROFILER.enabled = bool(on)


def profiling_report() -> dict:
    return PROFILER.report()
