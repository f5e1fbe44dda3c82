"""The serving programs as CUDA graphs, the counterparts of the JAX
package's jitted programs: ``search_program`` (``SearchProgram``;
``jax.jit(search_program)``, ``hnsw_tpu/ops/beam_search.py:632``), the exact
scan ``l2_topk`` (``ScanProgram``; ``jax.jit(pallas_l2_topk)``,
``hnsw_tpu/ops/pallas_topk.py:160``), the exact matmul route ``_bf_topk``
(``TopkProgram``; ``hnsw_tpu/models/brute.py:23``) and the IVF search
(``IvfProgram``; ``_ivf_route``, ``_ivf_probe``, ``_exact_refine``,
``hnsw_tpu/models/ivf.py:188,150,196``). ``Program`` holds what they share:
the warm-up, the capture into one memory pool per program and its bytes.

A ``SearchProgram`` is built once per static key (``program_key``), as
``jax.jit`` compiles once per set of static arguments and shapes: the index's
device state (its version and the identity of its ``GraphArrays`` and
``BeamCodec``), the batch and query dtype, every static argument of
``search_program`` and the device. Its shape follows the reference's own gate
(``beam_search.py:353-358``):

  * ``max_iters <= UNROLL_MAX``: one graph holds the entry, every beam
    iteration (each at its static index, so the history ring's slot is a
    static slice) and the exact rerank; no host read happens inside. This is
    the reference's unrolled loop.
  * above: a head graph (entry and beam set-up), one graph per chunk of
    ``CHUNK`` iterations and a tail graph (finish and rerank). The host reads
    ``done.all()`` once per chunk and skips the chunks left once every query
    is done: the reference's ``lax.while_loop`` at chunk granularity.

An iteration after every query is done changes no output (``beam_step``), so
a program answers bit for bit what the eager ``search_program`` answers.

Building runs the pieces once on a side stream (the warm-up: it builds the
kernels with nvcc at first use and sets the kernels' cached launch plans),
then captures each graph into the program's own memory pool. A capture
launches nothing, so the launch counters (``kernel_lib.LAUNCHES``) are put
back after it and the launches it recorded are added on every replay. A
failed capture raises: nothing falls back to the eager search on the card.

A call copies the caller's queries (and filter mask) into the program's
static inputs on the current stream, replays the graphs there and clones the
outputs right after, so the next replay cannot overwrite a batch that a
fetcher thread is still copying.

On the CPU the same pieces run in the same order on every call, without
capture, so the CPU tests exercise the program's structure.

The other three are one graph each (``CallProgram``): one call of a
function on static inputs, none of which reads the host, so a whole batch
replays with no host read. ``IvfProgram`` unrolls its ``nprobe`` probe steps
into the graph, as ``lax.scan`` with a static length compiles to one
program; ``TopkProgram``'s chunk loop has a static trip count. The k-means
assignment step of the IVF build is a ``CallProgram`` too.

The build's insertion rounds (``BuildPrograms``, the counterpart of
``jax.jit(round_step)``, ``hnsw_tpu/ops/insert_rounds.py:508``) are one
``RoundProgram`` per part of a round (the head, each layer's descent and
construction, the merges; ``ops/insert_rounds.py::round_plan``), keyed on
the statics the part reads, so every steady round replays the layer-0
construction, whose key holds neither ``B1`` nor ``max_obs``. A round writes
the tables in place, so nothing is warmed up: a key's first run is
uncaptured and measures the most memory its pieces hold; at its second run
the key captures and replays if the build's pool plus that peak stays
within the build's share of the card, and otherwise runs uncaptured for the
rest of the build (the same pieces, one host read per ``CHUNK`` steps), so a
build never fails where the eager rounds fit.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import time
from collections import OrderedDict
from typing import Optional

import torch

from ..utils.profiling import PROFILER
from . import kernel_lib
from .beam_search import BeamState, beam_step, search_begin, search_end, search_iters

# The reference unrolls the beam loop up to this many iterations and takes
# its while_loop above (beam_search.py:353-358); the program follows the same
# gate: one graph up to it, chunk graphs above.
UNROLL_MAX = 48
# Beam iterations per chunk graph. The chunked form serves the sharded search,
# whose cap (4*ef//E + 32: 128 at ef 96) is about 4x the ~30 iterations a batch
# needs: chunks of 8 stop at most 7 iterations past the last query's end (a
# quarter of the work needed) for one host read per 8 iterations.
CHUNK = 8
# Programs an index keeps, least recently used dropped first. Each holds its
# graphs' memory pool, the eager search's peak, until dropped: 1.1-1.9 GB at
# B=16384 on 200k rows, several GB at 1M (the entry's sort of [B, pivots]).
MAX_PROGRAMS = 8
# The share of a card's memory one index's programs may hold; past it the
# least recently used are dropped (before a build, room is kept for one more
# program as large as the largest held).
POOL_SHARE = 0.25

# the peaks (allocated, reserved) a build's first runs reset, by card
_PEAKS: dict = {}


def _card(device) -> int:
    if isinstance(device, int):
        return device
    device = torch.device("cuda") if device is None else torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


def _reset_peak(device):
    """``torch.cuda.reset_peak_memory_stats``, keeping the peaks it drops
    for ``peak_memory``."""
    old = _PEAKS.get(_card(device), (0, 0))
    _PEAKS[_card(device)] = (max(old[0], torch.cuda.max_memory_allocated(device)),
                             max(old[1], torch.cuda.max_memory_reserved(device)))
    torch.cuda.reset_peak_memory_stats(device)


def reset_peak_memory(device=None):
    """Start a window of ``peak_memory`` on the card: reset its peak memory
    statistics and the peaks a build's measurements kept."""
    if torch.cuda.is_available():
        torch.cuda.init()  # a fresh process has no allocator to reset yet
    _PEAKS.pop(_card(device), None)
    torch.cuda.reset_peak_memory_stats(_card(device))


def peak_memory(device=None) -> tuple:
    """(allocated, reserved) peak bytes on the card since
    ``reset_peak_memory``: ``torch.cuda``'s peaks, with those counted in that
    a build's first runs reset to measure their pieces."""
    old = _PEAKS.get(_card(device), (0, 0))
    return (max(old[0], torch.cuda.max_memory_allocated(_card(device))),
            max(old[1], torch.cuda.max_memory_reserved(_card(device))))


def cards(devices) -> list:
    """The distinct card indices of ``devices`` (a bare ``"cuda"`` is the
    current card), in order."""
    return sorted({_card(d) for d in devices})


def peak_memory_by_card(devices) -> dict:
    """{card index: ``peak_memory`` of that card} over the cards of
    ``devices`` (a sharded index's), each since its ``reset_peak_memory``."""
    return {c: peak_memory(c) for c in cards(devices)}


class Piece:
    """One piece of a program. With a ``graph``, ``fn`` is captured into it
    once (inside ``capture(graph)``) and ``replay`` replays the graph and adds
    the launches the capture counted (``launches``, and by card
    ``card_launches``), which the capture itself leaves uncounted. Without
    one (the CPU), ``replay`` runs ``fn``. A captured piece keeps no ``fn``
    (a method of its program), so a dropped program is freed at once, not by
    the cycle collector."""

    def __init__(self, fn, graph=None, capture=None):
        self.fn, self.graph, self.launches, self.card_launches = fn, graph, {}, {}
        if graph is None:
            return
        before = dict(kernel_lib.LAUNCHES), dict(kernel_lib.CARD_LAUNCHES)
        try:
            with capture(graph):
                fn()
        finally:
            counted = dict(kernel_lib.LAUNCHES), dict(kernel_lib.CARD_LAUNCHES)
            kernel_lib.LAUNCHES.update(before[0])
            kernel_lib.CARD_LAUNCHES.clear()
            kernel_lib.CARD_LAUNCHES.update(before[1])
        self.fn = None
        self.launches, self.card_launches = (
            {k: v - was.get(k, 0) for k, v in now.items() if v != was.get(k, 0)}
            for now, was in zip(counted, before))

    def replay(self):
        if self.graph is None:
            self.fn()
            return
        self.graph.replay()
        for k, v in self.launches.items():
            kernel_lib.LAUNCHES[k] += v
        for k, v in self.card_launches.items():
            kernel_lib.CARD_LAUNCHES[k] = kernel_lib.CARD_LAUNCHES.get(k, 0) + v


def program_key(g, codec, batch: int, dtype, device, **static) -> tuple:
    """What a program is built for: the device state's identity, the batch
    shape and dtype, the static arguments and the device. The program holds
    ``g`` and ``codec``, so their ids are not reused while it lives."""
    return (id(g), id(codec), int(batch), str(dtype), str(torch.device(device)),
            tuple(sorted(static.items())))


def call_key(held, batch: int, dtype, device, **static) -> tuple:
    """``program_key`` for a ``CallProgram``: the identity of every tensor in
    ``held`` (the program holds them all), the batch, dtype, device and the
    static arguments."""
    return (tuple(id(x) for x in held), int(batch), str(dtype),
            str(torch.device(device)), tuple(sorted(static.items())))


_CAPTURE_STREAMS: dict = {}


def _capture_stream(device):
    """The one warm-up and capture stream of ``device``: the caching allocator
    hands a pool's freed blocks only to allocations on the stream that freed
    them, so the captures that share a pool (a build's) share a stream."""
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


class Program:
    """What every program shares: its device, the warm-up and capture of its
    pieces into one memory pool, and the bytes that pool holds
    (``pool_bytes``). A subclass defines its pieces (functions of no
    argument that read and write the program's attributes) and ``_release``,
    which drops what a warm-up left on the program before the capture.

    ``graph_factory`` and ``capture`` stand in for ``torch.cuda.CUDAGraph``
    and ``torch.cuda.graph`` (the tests pass stubs)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool_bytes = 0

    def _release(self):
        pass

    def _pieces(self, fns, graph_factory=None, capture=None, warm=True, pool=None) -> list:
        """Captured pieces on the card (or with a stub graph); on the CPU
        pieces that run their function on every replay. ``warm=False``
        skips the warm-up (a round program's pieces ran once, uncaptured,
        just before); ``pool`` is a list that holds the memory pool several
        programs share (empty until the first capture into it)."""
        if self.device.type == "cuda" or graph_factory is not None:
            return self._capture_all(fns, graph_factory, capture, warm, pool)
        return [Piece(fn) for fn in fns]

    def _capture_all(self, fns, graph_factory, capture, warm=True, pool=None):
        on_card = self.device.type == "cuda"
        if graph_factory is None:
            graph_factory = torch.cuda.CUDAGraph
        ctx = torch.cuda.device(self.device) if on_card else contextlib.nullcontext()
        with ctx:
            side = None
            if on_card:
                side = _capture_stream(self.device)
                if warm:
                    cur = torch.cuda.current_stream(self.device)
                    side.wait_stream(cur)
                    with torch.cuda.stream(side):  # the warm-up
                        for fn in fns:
                            fn()
                    cur.wait_stream(side)
                    self._release()
                torch.cuda.synchronize(self.device)
                if warm:  # a round program captures mid-build: its cache stays
                    torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(self.device)
            pool = [] if pool is None else pool

            # torch.cuda.graph's own context would synchronize and empty the
            # allocator's caches (pinned host memory too) around every graph
            @contextlib.contextmanager
            def in_pool(graph):
                with torch.cuda.stream(side):
                    graph.capture_begin(*pool[:1])
                    try:
                        yield
                    finally:
                        graph.capture_end()
                if not pool:
                    pool.append(graph.pool())

            # the cycle collector stays off while capturing: a collection
            # could destroy another program's graph, which CUDA refuses while
            # a stream captures (a round program captures mid-build, chunk by
            # chunk, where a full collection each time would cost more than
            # the capture)
            with PROFILER.span("program.capture"):
                if warm:
                    gc.collect()
                gc.disable()
                try:
                    pieces = [Piece(fn, graph_factory(), capture or in_pool) for fn in fns]
                finally:
                    gc.enable()
            if on_card:
                self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        return pieces


class SearchProgram(Program):
    """``search_program`` for one static key, as CUDA graphs on the card (the
    pieces alone on the CPU). ``run(q, mask)`` answers one batch;
    ``start``/``step``/``finished``/``result`` let a caller interleave several
    programs chunk by chunk (the sharded search)."""

    def __init__(self, g, codec, batch: int, dtype, device, *, ef: int, knbn: int,
                 expand: int, use_mask: bool, max_iters=None, term_slack: float = 1.0,
                 rerank: Optional[int] = None, pool: Optional[int] = None,
                 seeds: int = 1, allow_fused: bool = True,
                 graph_factory=None, capture=None):
        super().__init__(device)
        dev = self.device
        self.g, self.codec = g, codec
        self.kw = dict(ef=int(ef), knbn=int(knbn), expand=int(expand),
                       use_mask=bool(use_mask), max_iters=max_iters, codec=codec,
                       term_slack=term_slack, rerank=rerank, pool=pool, seeds=int(seeds),
                       allow_fused=bool(allow_fused))
        self.iters = search_iters(ef, knbn, expand, max_iters, pool)
        self.unrolled = self.iters <= UNROLL_MAX
        self.q = torch.zeros((int(batch), g.vectors.shape[1]), dtype=dtype, device=dev)
        self.mask = (torch.zeros((g.cap1,), dtype=torch.bool, device=dev)
                     if use_mask else None)
        self._state = self._carry = self._out = None
        spans = ([(0, self.iters)] if self.unrolled else
                 [(lo, min(lo + CHUNK, self.iters)) for lo in range(0, self.iters, CHUNK)])
        self._flags = [None] * len(spans)
        if self.unrolled:
            fns = [self._whole]
        else:
            fns = ([self._begin]
                   + [functools.partial(self._chunk, j, lo, hi)
                      for j, (lo, hi) in enumerate(spans)]
                   + [self._end])
        pieces = self._pieces(fns, graph_factory, capture)
        if self.unrolled:
            self._head, self._chunks, self._tail = pieces[0], [], None
        else:
            self._head, self._chunks, self._tail = pieces[0], pieces[1:-1], pieces[-1]

    # -- the pieces (each reads and writes the program's attributes, so a
    #    captured piece and a piece run on every call see the same state)

    def _begin(self):
        self._state = search_begin(self.g, self.q, self.mask, **self.kw)
        if not self.unrolled:
            beam = self._state.beam
            self._carry = {f: getattr(beam, f) for f in BeamState.CARRY
                           if getattr(beam, f) is not None}

    def _iterate(self, lo: int, hi: int):
        for it in range(lo, hi):
            beam_step(self._state.beam, it)

    def _chunk(self, j: int, lo: int, hi: int):
        self._iterate(lo, hi)
        beam = self._state.beam
        for f, buf in self._carry.items():  # back into the head's buffers
            buf.copy_(getattr(beam, f))
            setattr(beam, f, buf)
        self._flags[j] = beam.done.all()

    def _end(self):
        # copied, so that the tail graph is never empty (without a codec or
        # a pool the outputs are views of the beam)
        self._out = tuple(t.clone() for t in search_end(self._state))

    def _whole(self):
        self._begin()
        self._iterate(0, self.iters)
        self._end()

    def _release(self):
        self._state = self._carry = self._out = None

    # -- running

    def start(self, q, mask=None):
        """Copy the batch (and mask) into the static inputs; replay the head."""
        self.q.copy_(q)
        if self.mask is not None:
            self.mask.copy_(mask)
        self._head.replay()

    @property
    def n_chunks(self) -> int:
        return len(self._chunks)

    def step(self, j: int):
        self._chunks[j].replay()

    def finished(self, j: int) -> bool:
        """Whether every query was done after chunk ``j`` (a host read)."""
        return bool(self._flags[j])

    def result(self):
        """Replay the tail; (ids, dists) cloned out of the program's pool."""
        if self._tail is not None:
            self._tail.replay()
        ids, dists = self._out
        return ids.clone(), dists.clone()

    def run(self, q, mask=None):
        """One batch: (ids [B, knbn], dists [B, knbn]), as ``search_program``."""
        self.start(q, mask)
        for j in range(self.n_chunks):
            self.step(j)
            if self.finished(j):
                break
        return self.result()


class CallProgram(Program):
    """One call of ``fn`` on static inputs, as one CUDA graph on the card (on
    the CPU, ``fn`` on every run). ``inputs`` gives each static input's
    (shape, dtype); ``fn`` holds every other tensor the graph reads, so they
    live as long as the program. ``run(*xs)`` copies ``xs`` into the static
    inputs on the current stream, replays, and clones the outputs out of the
    pool, so the next replay cannot overwrite a batch a fetcher thread is
    still copying. A failed capture raises."""

    def __init__(self, fn, inputs, device, graph_factory=None, capture=None):
        super().__init__(device)
        self.fn = fn
        self.inputs = [torch.zeros(shape, dtype=dtype, device=self.device)
                       for shape, dtype in inputs]
        self._out = None
        (self._piece,) = self._pieces([self._call], graph_factory, capture)

    def _call(self):
        self._out = self.fn(*self.inputs)

    def _release(self):
        self._out = None

    def run(self, *xs):
        for buf, x in zip(self.inputs, xs):
            buf.copy_(x)
        self._piece.replay()
        return tuple(t.clone() for t in self._out)


class ScanProgram(CallProgram):
    """The exact scan ``l2_topk`` (kernel B2, or B5 with ``packed=False``)
    for one key: the corpus tensors, the batch and query dtype, ``k, tn,
    group, acc, overfetch, refine, packed`` and the device; the counterpart
    of ``jax.jit(pallas_l2_topk)``. ``run(q)`` -> (dists [B, k], ids [B, k])."""

    def __init__(self, X, xsq, batch: int, dtype, device, *, k: int, tn: int, group: int,
                 acc: int, overfetch: int, refine: bool = True, packed: bool = True,
                 Xscan=None, graph_factory=None, capture=None):
        from .scan_topk import l2_topk
        self.kw = dict(k=int(k), tn=int(tn), group=int(group), acc=int(acc),
                       overfetch=int(overfetch), refine=bool(refine), packed=bool(packed))
        fn = functools.partial(l2_topk, X=X, xsq=xsq, Xscan=Xscan, **self.kw)
        super().__init__(fn, [((int(batch), X.shape[1]), dtype)], device,
                         graph_factory, capture)


class TopkProgram(CallProgram):
    """The exact matmul route ``_bf_topk`` (``models/brute.py``) for one key:
    the corpus, the batch, ``k``, the metric and the device.
    ``run(q)`` -> (scores [B, k], positions [B, k])."""

    def __init__(self, X, xsq, batch: int, device, *, k: int, metric: str,
                 graph_factory=None, capture=None):
        from ..models.brute import _bf_topk
        fn = functools.partial(_bf_topk, X=X, xsq=xsq, k=int(k), metric=metric)
        super().__init__(fn, [((int(batch), X.shape[1]), torch.float32)], device,
                         graph_factory, capture)


class IvfProgram(CallProgram):
    """The IVF search (``models/ivf.py::ivf_search``: route, the ``nprobe``
    probe steps, refine) for one key: the built lists, the batch and query
    dtype, ``nprobe``, ``kf``, the metric and the device.
    ``run(q)`` -> (packed rows [B, kf], dists [B, kf])."""

    def __init__(self, lists, batch: int, dtype, device, *, nprobe: int, kf: int,
                 metric: str, graph_factory=None, capture=None):
        from ..models.ivf import ivf_search
        cent, csq, Xs3, Xf3, xsq3 = lists
        fn = functools.partial(ivf_search, cent=cent, csq=csq, Xs3=Xs3, Xf3=Xf3,
                               xsq3=xsq3, nprobe=int(nprobe), kf=int(kf), metric=metric)
        super().__init__(fn, [((int(batch), cent.shape[1]), dtype)], device,
                         graph_factory, capture)


class KmeansProgram(CallProgram):
    """The IVF build's k-means assignment step (``models/ivf.py::
    _kmeans_assign``; the reference jits it, ``hnsw_tpu/models/ivf.py:57``)
    for one chunk shape: its static inputs are the chunk [rows, d], the
    centroids [C, d] and their squared norms [C]. ``run(Xc, cent, csq)`` ->
    (assign, top4, psum, pcnt, qerr)."""

    def __init__(self, rows: int, C: int, d: int, device, graph_factory=None, capture=None):
        from ..models.ivf import _kmeans_assign
        super().__init__(functools.partial(_kmeans_assign, C=int(C)),
                         [((int(rows), int(d)), torch.float32),
                          ((int(C), int(d)), torch.float32), ((int(C),), torch.float32)],
                         device, graph_factory, capture)


class RoundProgram(Program):
    """One part of an insertion round for one key (``round_plan`` of
    ``ops/insert_rounds.py``), the counterpart of that part of the
    reference's ``jax.jit(round_step)``. Its pieces: the part's ``begin``;
    one per chunk of ``CHUNK`` loop steps (beam iterations or descent hops),
    each followed by a host read of the part's ``finished`` flag, after which
    the chunks left are skipped (the reference's ``while_loop``, at chunk
    granularity: a step after the flag changes nothing); ``end``; with the
    widen pass, ``widen`` or ``keep`` after a host read of ``need.any()``
    (the reference's ``lax.cond``), then ``after``.

    A round writes the tables in place, so a warm-up would apply it twice.
    The first run of a key runs its pieces uncaptured (the round's own work
    and the warm-up of its kernels) and measures ``peak``, the most memory
    its pieces held above what was allocated when it started (what its
    captures would take from the pool). At the second run ``admit(self)``
    decides: captured (``captured`` True), the run captures ``begin``,
    ``end`` and the branches, which runs nothing on the card, and replays,
    and later runs replay; refused (False), every run calls the pieces
    uncaptured, as the first did, for the rest of the build. A chunk is
    captured the first time a captured run reaches it, so the chunks past
    where the loops end (a cap of 232 beam iterations where about 50 run)
    cost no capture. ``start``, ``step``, ``finished`` and ``finish`` let a
    caller interleave the programs of several shards chunk by chunk (each
    piece is measured alone, so the interleaving does not blur ``peak``).
    ``capture_s``, ``chunk_graphs`` and ``branch_replays`` count the
    captures' seconds, the chunk graphs and the replays of each widen branch
    since the build last read them; ``key`` is the part's key."""

    def __init__(self, part, device, graph_factory=None, capture=None, pool=None, key=None,
                 admit=None):
        super().__init__(device)
        self.part, self.key = part, key
        spans = [(lo, min(lo + CHUNK, part.iters)) for lo in range(0, part.iters, CHUNK)]
        self.n_chunks = len(spans)
        self._flags = [None] * len(spans)
        # a part without a loop is its begin alone (a graph may not be empty)
        self._fixed = ([part.begin] + ([part.end] if spans else [])
                       + ([part.widen, part.keep, part.after] if part.branches else []))
        self._chunk_fns = [functools.partial(self._chunk, j, lo, hi)
                           for j, (lo, hi) in enumerate(spans)]
        self._pieces_fixed = [Piece(fn) for fn in self._fixed]
        self._chunks = [Piece(fn) for fn in self._chunk_fns]
        self._capture_args = (graph_factory, capture, pool)
        self._admit = admit
        self.runs = 0
        self.peak = 0
        self.captured = None
        self._held = None  # during the first run: the bytes its pieces left allocated
        self.capture_s = 0.0
        self.chunk_graphs = 0
        self.branch_replays = {"widen": 0, "keep": 0}

    def _chunk(self, j: int, lo: int, hi: int):
        for it in range(lo, hi):
            self.part.step(it)
        self.part.carry()
        self._flags[j] = self.part.finished()

    def _capture(self, fns) -> list:
        factory, capture, pool = self._capture_args
        t0 = time.perf_counter()
        pieces = self._pieces(fns, factory, capture, warm=False, pool=pool)
        self.capture_s += time.perf_counter() - t0
        return pieces

    def _memory(self, fn) -> tuple:
        """Run ``fn``; on the card (bytes it left allocated, the most it
        allocated above what was allocated before it), elsewhere (0, 0)."""
        if self.device.type != "cuda":
            fn()
            return 0, 0
        base = torch.cuda.memory_allocated(self.device)
        _reset_peak(self.device)
        fn()
        return (torch.cuda.memory_allocated(self.device) - base,
                torch.cuda.max_memory_allocated(self.device) - base)

    def _replay(self, piece):
        """Replay ``piece``; during the key's first run, measured."""
        if self._held is None:
            piece.replay()
            return
        left, peak = self._memory(piece.replay)
        self.peak = max(self.peak, self._held + peak)
        self._held += left

    def start(self):
        """Decide at the key's second run, and capture if admitted; replay
        (or run) ``begin``."""
        if self.runs == 1:
            self.captured = self._admit is None or bool(self._admit(self))
            if self.captured:
                self._pieces_fixed = self._capture(self._fixed)
                self._chunks = [None] * self.n_chunks
            else:
                self._chunk_fns = None
            self._fixed = None
        self._held = 0 if self.runs == 0 else None
        self.runs += 1
        self._replay(self._pieces_fixed[0])

    def step(self, j: int):
        if self._chunks[j] is None:
            (self._chunks[j],) = self._capture([self._chunk_fns[j]])
            self._chunk_fns[j] = None
            self.chunk_graphs += 1
        self._replay(self._chunks[j])

    def finished(self, j: int) -> bool:
        """Whether the loop was done after chunk ``j`` (a host read)."""
        return bool(self._flags[j])

    def finish(self):
        rest = self._pieces_fixed[1:]
        if self.n_chunks:
            self._replay(rest[0])
        if self.part.branches:
            widen, keep, after = rest[-3:]
            name = "widen" if bool(self.part.need) else "keep"
            self._replay(widen if name == "widen" else keep)
            self._replay(after)
            if self.captured:
                self.branch_replays[name] += 1
        self._held = None

    def run(self):
        self.start()
        for j in range(self.n_chunks):
            self.step(j)
            if self.finished(j):
                break
        self.finish()

    def release(self):
        """Drop the pieces, the functions not captured yet (which refer back
        to the program) and the part, so that a dropped program frees its
        graphs and the build's tensors at once, not at the cycle collector's
        next pass."""
        self._fixed = self._chunk_fns = self._pieces_fixed = self._chunks = None
        self.part = self._admit = None


class BuildPrograms:
    """The round programs of one build on one device, the counterpart of the
    reference's ``jax.jit(round_step, static_argnames=("cfg",),
    donate_argnums=(3, 7))``. Each part of a round is a ``RoundProgram``
    keyed on its ``round_plan`` key (the statics it reads) and the identity
    of the build's tensors, which the build updates in place; the parts of a
    batch size meet in one ``RoundState``, allocated outside every capture.
    Every capture goes into one memory pool: the pieces of a build run one
    after another, and what a program keeps in the pool between its pieces
    (a beam's state) is dead once its ``end`` has run. The pool is kept
    within ``share`` of the card: a key is captured at its second run only
    if the pool plus the peak its first run measured fits (``admit``), and
    otherwise runs uncaptured for the rest of the build, so the build never
    refuses what the eager rounds would build and never thrashes.

    ``stats``: rounds; rounds replayed (every part from captured graphs);
    keys; captures; first runs (parts run uncaptured, one a key);
    ``uncaptured_keys``, the keys refused a capture; ``pool_bytes``;
    ``capture_s``, the seconds the captures took (on the card a capture runs
    its pieces' host work with the device idle); ``chunk_graphs``, the loop
    chunks captured; ``widen_replays`` and ``keep_replays``, the captured
    widen pass's branches replayed."""

    def __init__(self, device, graph_factory=None, capture=None, share: float = POOL_SHARE):
        self.device = torch.device(device)
        self._factory, self._capture, self.share = graph_factory, capture, share
        self._progs: dict = {}
        self._states: dict = {}
        self._pool: list = []
        self._round: list = []
        self._runs: list = []
        self.stats = {"rounds": 0, "rounds_replayed": 0, "keys": 0, "captures": 0,
                      "first_runs": 0, "uncaptured_keys": 0, "pool_bytes": 0,
                      "capture_s": 0.0, "chunk_graphs": 0, "widen_replays": 0,
                      "keep_replays": 0}

    def programs(self, bt, cfg, batch_ids, entry) -> list:
        """The programs of one round, in order, with its batch and entry
        copied into the batch size's ``RoundState``."""
        from .insert_rounds import RoundState, round_plan

        st = self._states.get(cfg.B)
        if st is None:
            st = self._states[cfg.B] = RoundState(cfg.B, bt.vectors.shape[1], self.device)
        st.start(batch_ids, entry)
        held = bt.held()
        progs = []
        for key, make in round_plan(cfg, bt.indeg0 is not None):
            prog = self._progs.get((held, key))
            if prog is None:
                prog = self._progs[(held, key)] = RoundProgram(
                    make(bt, st), self.device, self._factory, self._capture, self._pool, key,
                    self.admit)
            progs.append(prog)
        self._round, self._runs = progs, [p.runs for p in progs]
        return progs

    def admit(self, prog) -> bool:
        """Whether ``prog`` may capture at its key's second run: the pool
        plus the peak its first run measured within the budget."""
        return self.pool_bytes() + prog.peak <= self._budget()

    def account(self):
        """Count the round whose programs ``programs`` gave, once they ran."""
        s, runs = self.stats, self._runs
        s["rounds"] += 1
        s["rounds_replayed"] += all(r >= 1 and p.captured for p, r in zip(self._round, runs))
        s["first_runs"] += sum(r == 0 for r in runs)
        s["captures"] += sum(r == 1 and bool(p.captured) for p, r in zip(self._round, runs))
        s["keys"] = max(s["keys"], len(self._progs))
        s["uncaptured_keys"] = sum(p.captured is False for p in self._progs.values())
        s["pool_bytes"] = max(s["pool_bytes"], self.pool_bytes())
        for p in self._round:
            s["capture_s"] += p.capture_s
            s["chunk_graphs"] += p.chunk_graphs
            for name, n in p.branch_replays.items():
                s[f"{name}_replays"] += n
            p.capture_s, p.chunk_graphs = 0.0, 0
            p.branch_replays = {"widen": 0, "keep": 0}

    def round(self, bt, cfg, batch_ids, entry):
        """One round through the programs."""
        for prog in self.programs(bt, cfg, batch_ids, entry):
            with PROFILER.span("build.part." + prog.key[0]):
                prog.run()
        self.account()

    def pool_bytes(self) -> int:
        return sum(p.pool_bytes for p in self._progs.values())

    def _by_kind(self, value, keep=lambda p: True, add=True) -> dict:
        out: dict = {}
        for (_, key), p in self._progs.items():
            if keep(p):
                v = value(p)
                out[key[0]] = out.get(key[0], 0) + v if add else max(out.get(key[0], 0), v)
        return out

    def pools(self) -> dict:
        """The pool's bytes by the kind of part whose capture reserved them."""
        return self._by_kind(lambda p: p.pool_bytes)

    def peaks(self) -> dict:
        """The largest peak a first run measured, by the kind of part."""
        return self._by_kind(lambda p: p.peak, add=False)

    def uncaptured(self) -> dict:
        """The peaks of the keys refused a capture, summed by the kind of part."""
        return self._by_kind(lambda p: p.peak, keep=lambda p: p.captured is False)

    def report(self) -> dict:
        """``stats`` with the pools, peaks and uncaptured bytes by part (a
        build's ``_round_stats``)."""
        return dict(self.stats, pools=self.pools(), peaks=self.peaks(),
                    uncaptured=self.uncaptured())

    def _budget(self) -> float:
        if self.device.type != "cuda":
            return float("inf")
        return self.share * torch.cuda.get_device_properties(self.device).total_memory

    def clear(self):
        """Drop every program, its graphs and the pool."""
        for prog in self._progs.values():
            prog.release()
        self._progs.clear()
        self._round = []
        self._states.clear()
        self._pool.clear()


def round_programs(device, share: float = POOL_SHARE) -> Optional[BuildPrograms]:
    """A build's round programs on ``device`` (their pool within ``share``
    of the card): a new ``BuildPrograms`` on the card; None on the CPU,
    where the build runs the eager ``round_step``."""
    device = torch.device(device)
    return BuildPrograms(device, share=share) if device.type == "cuda" else None


def search_fixed(g, q, mask, **kw):
    """The program's pieces called directly, without capture: the entry,
    every beam iteration up to the cap with no host read, the rerank
    (``kw`` as ``search_program``'s). The replay's reference on the card."""
    s = search_begin(g, q, mask, **kw)
    for it in range(s.beam.max_iters):
        beam_step(s.beam, it)
    return search_end(s)


class ProgramCache:
    """The programs of one index, keyed by ``program_key`` (or ``call_key``): at most
    ``MAX_PROGRAMS``, holding at most ``share`` of a card's memory in their
    pools, least recently used dropped first, all dropped when the index's
    ``tag`` (its version) changes or on ``clear``. A captured graph holds raw
    pointers to the tensors it was captured on, so a program of an older
    device state must never replay."""

    def __init__(self, share: float = POOL_SHARE):
        self._progs: OrderedDict = OrderedDict()
        self._tag = None
        self.share = share

    def get(self, tag, key, build) -> Program:
        if tag != self._tag:
            self.clear()
            self._tag = tag
        prog = self._progs.get(key)
        if prog is not None:
            self._progs.move_to_end(key)
            return prog
        room = max((p.pool_bytes for p in self._progs.values()), default=0)
        self._drop_oldest(lambda: (len(self._progs) >= MAX_PROGRAMS
                                   or self.pool_bytes() + room > self._budget()), keep=0)
        prog = self._progs[key] = build()
        self._drop_oldest(lambda: self.pool_bytes() > self._budget(), keep=1)
        return prog

    def _drop_oldest(self, over, keep: int):
        while len(self._progs) > keep and over():
            self._progs.popitem(last=False)

    def _budget(self) -> float:
        dev = next((p.device for p in self._progs.values() if p.device.type == "cuda"), None)
        if dev is None:
            return float("inf")
        return self.share * torch.cuda.get_device_properties(dev).total_memory

    def clear(self):
        self._progs.clear()

    def __len__(self):
        return len(self._progs)

    def pool_bytes(self) -> int:
        """Bytes the cached programs' memory pools hold on the card."""
        return sum(p.pool_bytes for p in self._progs.values())
