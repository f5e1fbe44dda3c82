"""Corpus-sharded index over a list of devices — counterpart of
``hnsw_tpu/parallel/sharded.py``.

The JAX package runs one program over a device mesh (``shard_map``), driven
by one Python process. The port keeps that single-controller design without
``torch.distributed``: shard ``s`` lives on ``devices[s]`` and runs the
one-card device layer there: its ``GraphArrays`` snapshot
(``GraphArrays.shards``, one geometry for all shards), its ``BeamCodec``
(without id rows: kernel B3) and its search programs, keyed by
``program_key`` as the one-card ones are. A device may repeat (several
shards on one card share its pool budget; the CPU in the tests). The shards'
launches overlap across cards because CUDA is asynchronous, each with its
card current (``_on``), and answer bit for bit what they answer on one card.

  * **build**: the corpus is dealt round-robin; ``mode="mesh"`` runs one
    synchronized round per shard per step on one shared geometry, on the
    card through each shard's round programs (``BuildPrograms``), part by
    part in ``_lockstep``, on the CPU the eager ``round_step``; the device
    tables then seed the snapshots;
  * **search**: every shard's chunked program (the cap ``4*ef//E + 32``) in
    ``_lockstep``: chunk j on every shard still running, then one host read
    of each one's ``done``. The shards' (local id, distance) rows are merged
    on ``devices[0]`` by a stable sort (the mesh's ``all_gather`` and
    replicated sort) and one gather there maps them to int64 external ids
    before the fetch. The fan-out, lockstep and merge record the ``shard.*``
    spans and counters of ``utils/profiling.py``;
  * **exact search**: every shard scans its slice (kernel B2 over a bf16
    copy, or a tiled running top-k), a captured ``CallProgram`` each, and
    the same merge follows.

Left out, as TPU habits: the batch padding to a multiple of 8, ``pick_tn``,
the codec's M0 padding and width rounding to 8. Kept: stable sorts (ties to
the lower position) and the mesh build's in-degree guarantee whatever
``HNSW_BUILD_PROTECT`` and ``HNSW_MIN_INDEG`` say (a fault of the
reference, ``sharded.py:209``, reproduced on purpose).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..io.hnswio import HnswIo
from ..models.hnsw import Hnsw
from ..ops.beam_search import _device_mask, smallest
from ..ops.distances import get_metric
from ..ops.graph_arrays import BeamCodec, GraphArrays, codec_kind
from ..ops import program
from ..ops.insert_rounds import (BuildTensors, HostBuildState, RoundConfig, _next_pow2,
                                 round_step)
from ..ops.program import POOL_SHARE, CallProgram, ProgramCache, SearchProgram, program_key
from ..ops.scan_topk import (SCAN_GROUP, SCAN_TN, l2_topk, refine_width, scan_acc,
                             scan_depth)
from ..ops.stream import fetch_host, pipelined_stream, query_stream, upload_batch
from ..utils.device import resolve_device
from ..utils.profiling import PROFILER

INF = float("inf")


def default_devices(n_shards: Optional[int] = None, device=None) -> list:
    """The devices of ``n_shards`` shards: ``device`` (default ``"cuda"``)
    for every shard when it names one device (``"cpu"``, ``"cuda:0"``); a
    bare ``"cuda"`` deals the shards round-robin over the visible cards
    (default: one shard per card). Raises where CUDA is absent unless the
    CPU is asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        return [torch.device("cuda", s % count) for s in range(n_shards or count)]
    return [dev] * (n_shards or 1)


def _card_device(d) -> torch.device:
    """``d`` as a torch device, a bare ``"cuda"`` named by the index of the
    current card, so that the shards of one card count alike whatever name
    they came by (``pool_shares``, the copies of ``_per_device``). Raises
    where CUDA is absent unless the CPU is asked for."""
    d = resolve_device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def pool_shares(devices) -> list:
    """Each shard's share of its card for its programs' pools (the search's
    ``ProgramCache``, the build's ``BuildPrograms``): ``POOL_SHARE`` of the
    card split evenly over the shards the card holds, so one shard a card
    has the card's whole share."""
    return [POOL_SHARE / devices.count(d) for d in devices]


def _on(dev):
    """The current CUDA device for a shard's launches (the kernels launch on
    the current device's stream); nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _per_device(x, devices):
    """``x`` on each shard's device, copied once per distinct device."""
    out = {}
    return [out.setdefault(d, x.to(d, non_blocking=True)) for d in devices]


@dataclasses.dataclass
class _ShardState:
    """The sharded search's device state at one set of graph versions: one
    snapshot a shard on one shared geometry, the external ids of every
    shard's rows, and what is built on the snapshots."""

    graphs: list  # per shard: its GraphArrays, on its device (``n`` its live rows)
    origin: torch.Tensor  # [D, cap1] int64 external ids (-1 pad), on devices[0]:
    # ids stay 64-bit (reference DataId is usize, src/hnsw.rs:51); the merge
    # carries (shard, local id) pairs and one gather maps them before the fetch
    codec: Optional[tuple] = None  # ((kind, width), one BeamCodec a shard)
    scans: dict = dataclasses.field(default_factory=dict)  # tn: the exact scan's copies

    @property
    def cap1(self) -> int:
        return self.graphs[0].cap1


class ShardedHnsw:
    """A corpus-sharded HNSW over a list of devices. Each shard is a full
    ``Hnsw`` (so filters, dump and reload and flatten apply per shard); the
    per-shard device state serves the sharded search."""

    axis = "shard"  # the JAX package's mesh axis name, kept in the manifest

    def __init__(self, devices: Optional[Sequence] = None, n_shards: Optional[int] = None,
                 **hnsw_kwargs):
        device = hnsw_kwargs.pop("device", None)
        self.devices = ([_card_device(d) for d in devices] if devices is not None
                        else default_devices(n_shards, device))
        self.n_shards = len(self.devices)
        self.hnsw_kwargs = dict(hnsw_kwargs)
        seed = self.hnsw_kwargs.pop("seed", 397)
        self.shards = [Hnsw(seed=seed + 1000 * s, device=self.devices[s], **self.hnsw_kwargs)
                       for s in range(self.n_shards)]
        self._state: Optional[_ShardState] = None
        self._versions = None
        self._codec_kind = "auto"
        self._codec_width = None
        # per shard: its captured search programs (ops/program.py), the
        # shards of one card sharing an index's share of its memory
        self._programs = [ProgramCache(share) for share in pool_shares(self.devices)]
        self._placement = None  # lazy {external id: shard}; rebuilt after inserts
        self._mesh_rounds = 0  # steps of the last mesh build

    def __len__(self):
        return sum(len(s) for s in self.shards)

    def shard_of(self, k: int) -> int:
        """The shard holding external id ``k`` (recorded placement: ids need
        not be an ``arange``). Raises KeyError for an unknown id."""
        versions = tuple(s._version for s in self.shards)
        if self._placement is None or self._placement[0] != versions:
            pl = {}
            for s, sh in enumerate(self.shards):
                for o in sh._origin[: sh._nb_point].tolist():
                    pl[int(o)] = s
            self._placement = (versions, pl)
        return self._placement[1][int(k)]

    def set_keeping_pruned(self, flag: bool):
        """``Hnsw.set_keeping_pruned`` on every shard; the mesh build reads it."""
        for h in self.shards:
            h.set_keeping_pruned(flag)

    def modify_level_scale(self, factor: float):
        """``Hnsw.modify_level_scale`` on every shard: each shard's level
        generator draws its rows' levels at the new scale."""
        for h in self.shards:
            h.modify_level_scale(factor)

    def set_traversal_codec(self, kind, width=None):
        """Per-shard beam-traversal codec of the sharded search — the contract
        of ``Hnsw.set_traversal_codec`` (``"i8"``/``"bf16"``/``None``/``"auto"``)."""
        if kind not in ("i8", "bf16", "auto", None):
            raise ValueError(f"unknown codec kind {kind!r}")
        self._codec_kind = kind
        self._codec_width = width
        if self._state is not None:
            self._state.codec = None
        for c in self._programs:
            c.clear()

    # ----------------------------------------------------------------- build -----

    def parallel_insert(self, data_with_ids: Sequence[tuple], mode: str = "auto",
                        batch_size: Optional[int] = None):
        """Deal the points round-robin over the shards, then build.
        ``mode="mesh"`` (chosen by ``"auto"`` for more than one shard and 1024
        points a shard) advances every shard by one synchronized round per
        step; ``"device"``/``"serial"`` build the shards one after another.
        On the card a build resets the CUDA peak memory statistics, as
        ``device_parallel_insert`` says: read peaks across it with
        ``ops.program.peak_memory``."""
        dt = self.shards[0].dtype
        if isinstance(data_with_ids, np.ndarray) and data_with_ids.ndim == 2:
            X = np.asarray(data_with_ids, dtype=dt)
            ids = np.arange(len(X), dtype=np.int64)
        elif (isinstance(data_with_ids, tuple) and len(data_with_ids) == 2
              and isinstance(data_with_ids[0], np.ndarray)
              and np.asarray(data_with_ids[0]).ndim == 2):
            X = np.asarray(data_with_ids[0], dtype=dt)
            ids = np.asarray(data_with_ids[1], dtype=np.int64)
            if len(ids) != len(X):
                raise ValueError(f"ids length {len(ids)} != rows {len(X)}")
        else:
            vs, iis = [], []
            for v, i in data_with_ids:
                vs.append(np.asarray(v, dtype=dt))
                iis.append(int(i))
            X = np.stack(vs) if vs else np.zeros((0, 0), dt)
            ids = np.asarray(iis, np.int64)
        # strided split: bucket sizes within one of each other for any n
        buckets = [(X[s::self.n_shards], ids[s::self.n_shards])
                   for s in range(self.n_shards)]
        if mode == "auto":
            per = max((len(b[0]) for b in buckets), default=0)
            mode = "mesh" if (self.n_shards > 1 and per >= 1024) else (
                "device" if per >= 2048 else "serial")
        if mode == "mesh":
            self._mesh_insert(buckets, batch_size=batch_size)
        else:
            for s, (Xb, ib) in enumerate(buckets):
                if len(Xb):
                    with _on(self.devices[s]):
                        self.shards[s].parallel_insert((Xb, ib), mode=mode,
                                                       batch_size=batch_size)
            self._state = None

    def _mesh_insert(self, buckets, batch_size: Optional[int] = None, expand: int = 8):
        """The sharded build: each step runs one round on every shard, through
        the shards' round programs on the card (``sharded_program_round``;
        ``self._round_stats``, one dict a shard) and ``round_step`` on the CPU
        (``sharded_insert_round_fn``); afterwards the device tables seed the
        shards' snapshots directly."""
        D = self.n_shards
        dim = next((b[0].shape[1] for b in buckets if len(b[0])), None)
        if dim is None:
            return
        for s in range(D):
            Xb, ib = buckets[s]
            self.shards[s]._set_dim(dim)
            if self.shards[s]._nb_point == 0 and len(Xb):
                self.shards[s].insert(Xb[0], int(ib[0]))  # seed the entry point
                buckets[s] = (Xb[1:], ib[1:])
        if not any(len(b[0]) for b in buckets):
            self._state = None
            return
        states = [HostBuildState(self.shards[s], buckets[s]) for s in range(D)]
        # one geometry for all shards; a shard whose table was already widened
        # keeps its width
        L = max(st.L for st in states)
        widths = tuple(max([self.shards[0]._layer_width(l)]
                           + [st.widths[l] for st in states if l < st.L])
                       for l in range(L))
        cap1 = max(st.cap1 for st in states)
        for st in states:
            st.conform(L, widths, cap1)
        devs = self.devices
        vectors = [torch.as_tensor(st.vec_np(), device=devs[s]) for s, st in enumerate(states)]
        sqnorms = [(v * v).sum(-1) for v in vectors]
        levels = [torch.as_tensor(st.levels_np(), device=devs[s])
                  for s, st in enumerate(states)]
        tables = [[(torch.as_tensor(i, device=devs[s]), torch.as_tensor(d, device=devs[s]))
                   for i, d in st.tables_np()] for s, st in enumerate(states)]
        # the layer-0 in-degree guarantee on every shard (RoundConfig.min_indeg)
        indeg = [torch.as_tensor(st.indeg0_np(), device=devs[s]) for s, st in enumerate(states)]
        B = int(batch_size) if batch_size else int(
            min(4096, max(64, max(st.remaining for st in states))))
        h0 = self.shards[0]
        self._mesh_rounds = 0
        progs = [program.round_programs(d, share) for d, share in zip(devs, pool_shares(devs))]
        if any(p is None for p in progs):
            progs = None
        else:
            bts = [BuildTensors(vectors[s], sqnorms[s], levels[s], tables[s], None, indeg[s])
                   for s in range(D)]
        while any(st.remaining for st in states):
            self._mesh_rounds += 1
            Br = min(st.ramp(B) for st in states if st.remaining)
            max_obs = max(st.entry_level for st in states)
            nonempty = tuple(bool(any(st.counts[l] > 0 for st in states)) for l in range(L))
            entry = [int(st.entry) for st in states]
            bidx = np.empty((D, Br), np.int32)
            n_hi = 0
            for s, st in enumerate(states):
                bidx[s], nh = st.round_batch(Br)
                n_hi = max(n_hi, nh)
            B1 = 0 if n_hi == 0 else int(min(Br, _next_pow2(max(8, n_hi))))
            cfg = RoundConfig(B=Br, cap1=cap1, num_layers=L, widths=widths,
                              efc=h0.ef_construction, M=h0.max_nb_connection,
                              metric=h0.metric.name, expand=int(expand),
                              max_obs=max_obs, nonempty=nonempty,
                              keep_pruned=bool(h0.keep_pruned),
                              extend=bool(h0.extend_candidates), B1=B1)
            if progs is None:
                tables, indeg = sharded_insert_round_fn(devs, cfg)(
                    vectors, sqnorms, levels, tables, bidx, entry, indeg)
            else:
                sharded_program_round(devs, progs, bts, cfg, bidx, entry)
        for s, st in enumerate(states):
            st.flush([(i.cpu().numpy(), d.cpu().numpy()) for i, d in tables[s]])
        if progs is not None:
            self._round_stats = [p.report() for p in progs]
            for p in progs:
                p.clear()
        nonempty = tuple(bool(any(st.counts[l] > 0 for st in states)) for l in range(L))
        level = max(st.entry_level for st in states)
        self._build_state([
            GraphArrays(vectors=vectors[s], sqnorms=sqnorms[s], levels=levels[s],
                        layer_ids=tuple(t[0] for t in tables[s]), layer_dists=(),
                        entry=int(st.entry), n=self.shards[s]._nb_point, cap1=cap1,
                        entry_level=level, layer_nonempty=nonempty,
                        metric_name=h0.metric.name, version=self.shards[s]._version)
            for s, st in enumerate(states)])

    # ---------------------------------------------------------- device state -----

    def _build_state(self, graphs=None) -> _ShardState:
        """The search state on the shards' snapshots: ``graphs`` (the mesh
        build's), else ``GraphArrays.shards`` of the host shards; cached per
        graph version."""
        versions = tuple(s._version for s in self.shards)
        if graphs is None:
            if self._state is not None and self._versions == versions:
                return self._state
            graphs = GraphArrays.shards(self.shards)
        org = np.full((self.n_shards, graphs[0].cap1), -1, np.int64)
        for s, h in enumerate(self.shards):
            org[s, :h._nb_point] = h._origin[:h._nb_point]
        self._state = _ShardState(graphs, torch.as_tensor(org, device=self.devices[0]))
        self._versions = versions
        return self._state

    def _codecs(self) -> Optional[list]:
        """Every shard's traversal codec, ``BeamCodec.build`` on its snapshot
        without id rows (kernel B3 scores it), or None. Cached per graph
        version and codec setting."""
        def est():  # "auto": all the shards' blocks as on one card
            g = self._build_state().graphs[0]
            w = g.layer_ids[0].shape[1]
            w = w if self._codec_width is None else min(int(self._codec_width), w)
            return self.n_shards * g.cap1 * w * g.vectors.shape[1]

        kind = codec_kind(self._codec_kind, self.shards[0].metric.name, len(self), est)
        if kind is None:
            return None
        st, key = self._build_state(), (kind, self._codec_width)
        if st.codec is None or st.codec[0] != key:
            codecs = []
            for g, dev in zip(st.graphs, self.devices):
                with _on(dev):
                    codecs.append(BeamCodec.build(g, kind, width=self._codec_width,
                                                  with_ids=False))
            st.codec = (key, codecs)
        return st.codec[1]

    def device_codec_arrays(self):
        """``_codecs`` as ``(blocks, blocks_sq, scale, M0, dim)``, a list of
        each shard's tensors in the first three, or None."""
        codecs = self._codecs()
        if codecs is None:
            return None
        return ([c.blocks for c in codecs], [c.blocks_sq for c in codecs],
                [c.scale for c in codecs], codecs[0].M0, codecs[0].dim)

    def _masks(self, filter, st: _ShardState):
        """The filter as one [cap1] bool mask per shard, on its device."""
        return [_device_mask(h, g, filter) for h, g in zip(self.shards, st.graphs)]

    @staticmethod
    def _external(st: _ShardState, local, shard, dists):
        """The merged rows (``_merge_shard_topk``, on ``devices[0]``) as
        external ids [B, k] int64, -1 where there is no answer, and their
        distances, INF there: one gather from ``st.origin`` on the card, so
        the host copies only the answers."""
        ok = torch.isfinite(dists) & (local >= 0)
        ids = st.origin[shard.long(), local.clamp_min(0).long()]
        return torch.where(ok, ids, -1), torch.where(ok, dists, INF)

    @classmethod
    def _to_external(cls, st: _ShardState, local, shard, dists):
        """``_external``, fetched: (ids, dists) as numpy arrays."""
        return tuple(x.cpu().numpy() for x in cls._external(st, local, shard, dists))

    # ---------------------------------------------------------------- search -----

    def _search_fn(self, knbn, ef, filter, expand, rerank):
        """The sharded search for these arguments: ``(st, programs, run)``,
        where ``programs(batch, dtype)`` builds (or finds) every shard's
        search program for a batch shape and ``run(q)`` answers a batch."""
        st = self._build_state()
        codecs = self._codecs() or [None] * self.n_shards
        masks = self._masks(filter, st) if filter is not None else [None] * self.n_shards
        # the beam's own cap (4*ef//E + 32: the chunked program) and no pivot
        # seeds, as the JAX package's shards search
        static = dict(ef=int(ef), knbn=int(knbn), expand=int(expand),
                      use_mask=filter is not None, max_iters=None, term_slack=1.0,
                      rerank=None if rerank is None else int(rerank), pool=None, seeds=1,
                      allow_fused=True)
        tag = self._program_tag()

        def programs(batch, dtype):
            return [self._programs[s].get(
                tag, program_key(g, c, batch, dtype, dev, **static),
                lambda g=g, c=c, dev=dev: SearchProgram(g, c, batch, dtype, dev, **static))
                for s, (g, c, dev) in enumerate(zip(st.graphs, codecs, self.devices))]

        def run(q):
            return _sharded_search(self.devices, programs(q.shape[0], q.dtype), q, masks,
                                   int(knbn))
        return st, programs, run

    def _program_tag(self):
        """The device state every shard's programs were captured on: the graph
        versions and the codec (``ProgramCache``'s tag)."""
        return (tuple(s._version for s in self.shards), self._codec_kind, self._codec_width)

    def search_batch(self, queries, knbn: int, ef: int, filter=None,
                     expand: int = 4, rerank: Optional[int] = None):
        """Sharded batched search: the single-card search program on every
        shard (int8 codec with kernel B3 and the exact rerank when the codec
        is on), then the merge on ``devices[0]``. Returns (external ids
        [B, k] int64, -1 padded, dists [B, k])."""
        with PROFILER.span("search.call"):
            q = np.atleast_2d(np.asarray(queries, np.float32))
            with PROFILER.span("search.prepare"):
                st, _, run = self._search_fn(knbn, ef, filter, expand, rerank)
            out = run(torch.as_tensor(q, device=self.devices[0]))
            with PROFILER.span("search.finish"):
                return self._to_external(st, *out)

    def _scan_arrays(self, tn: int):
        """Per-shard bf16 scan copy padded to a multiple of ``tn`` rows (and
        with zero columns up to the kernel's 16-column step, ``scan_depth``), and
        its squared norms with 3e38 past the live rows so that padding never
        enters a top-k (the sharded counterpart of ``pad_corpus``); cached per
        graph version."""
        st = self._build_state()
        if tn in st.scans:
            return st.scans[tn]
        Np = -(-st.cap1 // tn) * tn
        Xp, xsqp = [], []
        for g in st.graphs:
            v, sq, n = g.vectors, g.sqnorms, g.n
            vb = torch.zeros((Np, scan_depth(v.shape[1])), dtype=torch.bfloat16,
                             device=v.device)
            vb[: st.cap1, : v.shape[1]] = v.to(torch.bfloat16)
            xs = torch.full((Np,), 3.0e38, dtype=torch.float32, device=v.device)
            xs[:n] = sq[:n]
            Xp.append(vb)
            xsqp.append(xs)
        st.scans[tn] = (Xp, xsqp, Np)
        return st.scans[tn]

    def search_stream(self, queries, knbn: int, ef: int, filter=None,
                      expand: int = 4, rerank: Optional[int] = None,
                      batch: int = 4096, query_dtype=None):
        """Pipelined sharded serving (``ops/stream.py``): the upload of batch
        i+1 and the fetch of batch i-1 overlap the search of batch i; a filter
        mask uploads once for the stream. ``query_dtype="f16"`` sends the
        queries as float16 (the search runs in f32). Returns (external ids
        [nq, k] int64, -1 padded, dists [nq, k])."""
        with PROFILER.span("search.call"):
            q, out_i, out_d, work = query_stream(queries, knbn, batch, query_dtype)
            with PROFILER.span("search.prepare"):
                st, programs, run = self._search_fn(knbn, ef, filter, expand, rerank)
                dtype = torch.from_numpy(q[:0]).dtype
                for size in {we - ws for ws, we in work}:  # built before the threads start
                    programs(size, dtype)

            def _upload(w):
                return upload_batch(q[w[0]:w[1]], self.devices[0])

            def _dispatch(w, staged):
                with _on(self.devices[0]):
                    out = run(staged.wait())
                    with PROFILER.span("search.finish"):
                        return fetch_host(self._external(st, *out))

            def _fetch(w, out):
                ws, we = w
                out_i[ws:we], out_d[ws:we] = out.get()

            pipelined_stream(work, _upload, _dispatch, _fetch)
            return out_i, out_d

    def exact_search_batch(self, queries, knbn: int, filter=None,
                           mode: str = "auto", tile: int = 16384):
        """Sharded exact search: every shard scans its slice and keeps a
        local top-k, and the same merge follows; the union of the shards'
        exact top-k holds the global one. ``mode``:

          * ``"pallas"``: the packed exact scan (kernel B2) over each shard's
            bf16 copy keeps the reference's 32-aligned candidate count, then
            an f32 direct-form refine. L2 only, unfiltered, k <= 128.
          * ``"tiled"``: a loop over ``tile``-row slices with a running
            top-k ([B, tile] of workspace); any metric with a matmul form,
            filters.
          * ``"auto"``: ``"pallas"`` where it applies, else ``"tiled"``.

        Each shard's scan replays a captured program (``CallProgram``, a
        CUDA graph on the card) kept in the shard's ``ProgramCache``; the
        merge follows on ``devices[0]``."""
        metric = self.shards[0].metric.name
        if get_metric(metric).matmul_scores is None:
            raise ValueError(f"exact sharded scan needs a matmul-form metric, got {metric!r}")
        st = self._build_state()
        if mode == "auto":
            mode = ("pallas" if metric in ("L2", "DistL2") and filter is None
                    and knbn <= 128 else "tiled")
        qd = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                             device=self.devices[0])
        k = int(min(knbn, st.cap1))
        masks = None
        if mode == "pallas":
            if metric not in ("L2", "DistL2") or filter is not None:
                raise ValueError("pallas sharded scan is L2-only, unfiltered")
            Xp, xsqp, Np = self._scan_arrays(SCAN_TN)
            local_scan = _sharded_scan_pallas_fn(k, SCAN_TN, Np, st.cap1)
            held = [(g.vectors, g.n, x, xs) for g, x, xs in zip(st.graphs, Xp, xsqp)]
            tile = None
        elif mode == "tiled":
            tile = int(min(tile, st.cap1))
            local_scan = _sharded_scan_fn(metric, k, tile)
            held = [(g.vectors, g.sqnorms, g.n) for g in st.graphs]
            if filter is not None:
                masks = self._masks(filter, st)
        else:
            raise ValueError(f"unknown exact mode {mode!r}")
        inputs = [(tuple(qd.shape), torch.float32)]
        if masks is not None:
            inputs.append(((st.cap1,), torch.bool))
        key = ("exact", mode, int(qd.shape[0]), k, tile, masks is not None)
        qs = _per_device(qd, self.devices)
        ids, dists = [], []
        for s, dev in enumerate(self.devices):
            prog = self._programs[s].get(
                self._program_tag(), key,
                lambda s=s: CallProgram(functools.partial(local_scan, *held[s]), inputs,
                                        self.devices[s]))
            with _on(dev):
                i, d = prog.run(qs[s], *(() if masks is None else (masks[s],)))
            ids.append(i)
            dists.append(d)
        local, shard, dists = _merge_shard_topk(ids, dists, k, self.devices[0])
        ids, dists = self._to_external(st, local, shard, dists)
        pad = ((0, 0), (0, knbn - ids.shape[1]))  # k past the rows: -1 / inf
        return np.pad(ids, pad, constant_values=-1), np.pad(dists, pad, constant_values=INF)

    # --------------------------------------------------------------- persist -----

    def file_dump(self, path, basename: str) -> str:
        """One reference-format dump per shard (``<basename>.shard<i>.hnsw.*``)
        and a manifest ``<basename>.shards.json`` in the JAX package's format
        (``hnsw_tpu.sharded.v1``), so each package reloads the other's."""
        for s, sh in enumerate(self.shards):
            sh.file_dump(path, f"{basename}.shard{s}")
        manifest = {"format": "hnsw_tpu.sharded.v1", "n_shards": self.n_shards,
                    "axis": self.axis, "basename": basename}
        with open(os.path.join(path, f"{basename}.shards.json"), "w") as f:
            json.dump(manifest, f)
        return basename

    @classmethod
    def load(cls, path, basename: str, devices: Optional[Sequence] = None,
             **hnsw_kwargs) -> "ShardedHnsw":
        """Reload a sharded dump. ``devices`` may be longer than the dump's
        shard count (the extra shards start empty), never shorter."""
        with open(os.path.join(path, f"{basename}.shards.json")) as f:
            manifest = json.load(f)
        n = int(manifest["n_shards"])
        obj = cls(devices=devices, n_shards=None if devices is not None else n, **hnsw_kwargs)
        if obj.n_shards < n:
            raise ValueError(f"{obj.n_shards} devices; the dump has {n} shards")
        loaded = []
        for s in range(n):
            with _on(obj.devices[s]):
                loaded.append(HnswIo(path, f"{basename}.shard{s}").load_hnsw(
                    device=obj.devices[s]))
        obj.shards = loaded + obj.shards[n:]
        obj._state = obj._versions = obj._placement = None
        return obj

    def searcher(self):
        """The per-shard device state the sharded search programs read."""
        return self._build_state()


def sharded_insert_round_fn(devices, cfg):
    """One synchronized insertion round on every shard (``round_step`` on
    ``devices[s]``): subgraphs are independent, so a step moves nothing
    between shards. The returned function takes per-shard lists and returns
    (tables, in-degrees), updated in place."""
    def step(vectors, sqnorms, levels, tables, batch_ids, entry, indeg):
        out_t, out_i = [], []
        for s, dev in enumerate(devices):
            with _on(dev):
                t, ind = round_step(vectors[s], sqnorms[s], levels[s], tables[s],
                                    torch.as_tensor(batch_ids[s], device=dev), entry[s],
                                    None, indeg[s], cfg=cfg)
            out_t.append(list(t))
            out_i.append(ind)
        return out_t, out_i
    return step


def _lockstep(devices, parts, inputs=None, traced=False):
    """Run one program a shard (``parts[s]`` on ``devices[s]``: a search's
    ``SearchProgram`` or a part of a build round) in lockstep: ``start`` on
    every card (with ``inputs()``'s arguments, one tuple a shard), then chunk
    j on every shard still looping, each with its card current, and one host
    read of each one's flag, so no shard's launches wait on another's read.
    ``traced`` (the search) records the spans ``shard.start``, ``.step`` and
    ``.poll`` and adds each chunk's live shards to ``shard.steps``, its
    finished ones to ``shard.idle_steps`` (the two sum to shards x chunks)."""
    span = PROFILER.span if traced else (lambda name: contextlib.nullcontext())
    with span("shard.start"):
        for p, dev, args in zip(parts, devices, inputs() if inputs else [()] * len(parts)):
            with _on(dev):
                p.start(*args)
    live = list(range(len(parts)))
    for j in range(parts[0].n_chunks):
        with span("shard.step"):
            for s in live:
                with _on(devices[s]):
                    parts[s].step(j)
        if traced:
            PROFILER.add("shard.steps", len(live))
            PROFILER.add("shard.idle_steps", len(parts) - len(live))
        with span("shard.poll"):
            live = [s for s in live if not parts[s].finished(j)]
        if not live:
            break


def sharded_program_round(devices, programs, bts, cfg, batch_ids, entry):
    """One synchronized insertion round on every shard through its round
    programs (``programs[s]``, a ``BuildPrograms`` on ``devices[s]``, on the
    shard's ``BuildTensors`` ``bts[s]``), part by part: each part in
    ``_lockstep`` across the shards, then its ``end`` on every shard. The
    tables and in-degrees are updated in place."""
    rounds = []
    for s, dev in enumerate(devices):
        with _on(dev):
            rounds.append(programs[s].programs(bts[s], cfg, batch_ids[s], entry[s]))
    for parts in zip(*rounds):
        _lockstep(devices, parts)
        for p, dev in zip(parts, devices):
            with _on(dev):
                p.finish()
    for p in programs:
        p.account()


def _merge_shard_topk(ids, dists, k, device):
    """Merge the shards' top-k rows on ``device``: each shard's [B, k_local]
    rows are copied there and one stable sort keeps the best ``k`` (ties to
    the lower shard and position). Returns (local ids [B,k], shard [B,k],
    dists [B,k])."""
    all_ids = torch.stack([i.to(device) for i in ids])  # [D, B, k_local]
    all_d = torch.stack([d.to(device) for d in dists])
    D_, B_, k_ = all_ids.shape
    flat_ids = all_ids.permute(1, 0, 2).reshape(B_, D_ * k_)
    flat_d = all_d.permute(1, 0, 2).reshape(B_, D_ * k_)
    v, order = smallest(flat_d, k)
    return torch.gather(flat_ids, 1, order), (order // k_).to(torch.int32), v


def _sharded_scan_fn(metric: str, k: int, tile: int):
    """The tiled exact scan of one shard, ``local_scan(v, xsq, n_live, qf[,
    mask])`` -> (local ids [B, k] int32, dists [B, k]): a loop over
    ``tile``-row slices (a static trip count) with a running top-k, so the
    workspace is [B, tile]. The last slice's start clamps into range; rows an
    earlier slice covered are masked by their index, so duplicates never
    displace results."""
    m = get_metric(metric)

    def local_scan(v, xsq, n_live, qf, mask_full=None):
        cap1, d = v.shape
        TN = min(tile, cap1)
        B = qf.shape[0]
        bd = torch.full((B, k), INF, device=v.device)
        bi = torch.full((B, k), -1, dtype=torch.int32, device=v.device)
        for i in range(-(-cap1 // TN)):
            s = i * TN
            start = min(s, cap1 - TN)
            dt = m.matmul_scores(qf, v[start:start + TN], xsq[start:start + TN])
            gidx = start + torch.arange(TN, dtype=torch.int32, device=v.device)[None, :]
            alive = (gidx >= s) & (gidx < n_live)
            if mask_full is not None:
                alive = alive & mask_full[start:start + TN][None, :]
            dt = torch.where(alive, dt.to(torch.float32), INF)
            cd = torch.cat([bd, dt], 1)
            ci = torch.cat([bi, gidx.expand(B, TN)], 1)
            bd, pos = smallest(cd, k)
            bi = torch.gather(ci, 1, pos)
        fin = torch.isfinite(bd)
        return torch.where(fin, bi, -1), torch.where(fin, bd, INF)
    return local_scan


def _sharded_scan_pallas_fn(k: int, tn: int, Np: int, cap1: int):
    """The exact scan of one shard through the packed scan kernel (B2 on the
    card, ``ops/scan_topk.py``), ``local_scan(v, n_live, Xp, xsqp, qf)`` ->
    (local ids [B, k] int32, dists [B, k]): the shard's bf16 copy keeps
    ``refine_width(k, 8)`` candidates (the reference's 32-aligned count), which
    are re-scored in f32 direct form against the shard's vectors."""
    acc = scan_acc(Np, tn)
    n_blocks = -(-(Np // tn) // acc)
    cand_w = n_blocks * 2 * (tn // SCAN_GROUP)
    kk = refine_width(k, 8, min(Np, cand_w))
    assert k <= kk, (k, kk)  # large k goes to the tiled scan

    def local_scan(v, n_live, Xp, xsqp, qf):
        dd, ids = l2_topk(qf, Xp, xsqp, kk, tn=tn, group=SCAN_GROUP, refine=False, acc=acc)
        safe = torch.clamp(ids, 0, cap1 - 1)
        diff = v[safe].to(torch.float32) - qf[:, None, :]
        d2 = (diff * diff).sum(-1)
        bad = (ids >= n_live) | ~torch.isfinite(dd) | (dd >= 1e18)
        v2, pos = smallest(torch.where(bad, INF, d2), k)
        dists = torch.sqrt(torch.clamp_min(v2, 0.0))  # inf stays inf for misses
        out = torch.where(torch.isfinite(dists), torch.gather(safe, 1, pos), -1)
        return out.to(torch.int32), dists
    return local_scan


def _sharded_search(devices, programs, q, masks, knbn):
    """The sharded search: every shard's search program (the blocked int8
    codec, kernel B3 on the card, the exact f32 rerank and the in-search
    filter mask) on its device, in ``_lockstep`` (the point of the
    reference's ``shard_map``: no shard's launches wait on another's read),
    then the merge on ``devices[0]``, which waits on the shards' streams, not
    on the host."""
    _lockstep(devices, programs, lambda: zip(_per_device(q, devices), masks), traced=True)
    with PROFILER.span("shard.merge"):
        ids, dists = [], []
        for p, dev in zip(programs, devices):
            with _on(dev):
                i, d = p.result()
                n = p.g.n
                # an empty or padded shard can answer a valid-looking id (the
                # entry against zero padding): mask by the live count before the
                # merge (with a codec, the rerank has already restored exact f32
                # distances, so the merge compares exact values across the
                # shards' scales)
                valid = (i >= 0) & (i < n)
                ids.append(torch.where(valid, i, -1))
                dists.append(torch.where(valid, d, INF))
        return _merge_shard_topk(ids, dists, knbn, devices[0])
