"""IVF-Flat engine — counterpart of ``hnsw_tpu/models/ivf.py``.

Inverted lists for clustered corpora, where beam traversal of a graph misses
neighbours it cannot reach:

  * routing: one ``[B,d] x [C,d]`` matmul scores every query against every
    centroid; the ``nprobe`` nearest lists are taken with a stable sort
    (ties to the lower list id, as ``lax.top_k``).
  * lists: the corpus is permuted list-major into uniform ``cap``-row slabs
    ``[L, cap, d]``, so a probed list is one contiguous block; the probe
    streams a bf16 copy and the exact f32 refine re-scores the top
    ``k + overfetch`` rows, so returned distances are exact.
  * balance: k-means lists are capped at ``BALANCE`` x the mean size; an
    oversized cluster is split by recursive median cuts (``_median_cut``).

k-means runs its assignment on the index's device (the routing matmul, the
four nearest centroids through ``smallest`` and the partial sums through
``index_add_``), replayed as a captured program per chunk shape
(``ops/program.py::KmeansProgram``; the reference jits it), and the Lloyd
update on the host in fp64, as the JAX package does; ``index_add_`` on CUDA
accumulates with atomics, so centroids may differ in their last bits from run
to run there. The probe is a Python loop over the
``nprobe`` steps: one ``[B, cap, d]`` slab per query per step, merged into a
running top-``kf``. None of this is a kernel in the JAX package either (plain
``jnp`` programs), so none is one here. The search (route, probe, refine:
``ivf_search``) replays a captured program (``ops/program.py::IvfProgram``,
one CUDA graph on the card with the probe steps unrolled), built once per
batch shape, query dtype, ``nprobe`` and ``kf`` as the reference jits its
three pieces, kept in the index's ``ProgramCache`` and dropped when the lists
change.

API-compatible subset of ``Hnsw`` (insert / parallel_insert / search /
search_batch / parallel_search with filters), for the inner-product metrics
(L2, Dot, Cosine). ``save_native`` writes the JAX package's ``kind="ivf-flat"``
``.npz``; either package reads the other's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.beam_search import smallest
from ..ops.distances import get_metric, scores_gathered, scores_matmul
from ..ops.id_scores import id_scores
from ..ops.program import IvfProgram, KmeansProgram, ProgramCache, call_key
from ..utils.device import resolve_device
from ..utils.profiling import PROFILER

_IP_METRICS = ("L2", "DistL2", "Dot", "DistDot", "Cosine", "DistCosine")
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, None: None}


def _kmeans_assign(Xc, cent, csq, C: int):
    """One Lloyd chunk: nearest centroid, top-4 alternates, partial sums.
    Returns (assign[n], top4[n,4], psum[C,d], pcnt[C], qerr[n])."""
    d = scores_matmul("L2", Xc, cent, csq)  # [n, C]
    v, top4 = smallest(d, min(4, C))
    assign = top4[:, 0]
    psum = torch.zeros((C, Xc.shape[1]), dtype=torch.float32, device=Xc.device)
    psum.index_add_(0, assign, Xc)
    pcnt = torch.zeros((C,), dtype=torch.float32, device=Xc.device)
    pcnt.index_add_(0, assign, torch.ones((Xc.shape[0],), dtype=torch.float32,
                                          device=Xc.device))
    return assign, top4, psum, pcnt, v[:, 0]


def _kmeans(X: np.ndarray, C: int, iters: int, seed: int, chunk: int = 65536,
            device=None):
    """Chunked k-means on ``device``, each chunk's assignment a replay of its
    shape's ``KmeansProgram`` (the full chunks share one, the ragged tail has
    its own). Returns (centroids[C,d] f32, top4[n,4] i32)."""
    n, d = X.shape
    rng = np.random.default_rng(seed)
    cent = X[rng.permutation(n)[:C]].astype(np.float32)
    if len(cent) < C:  # corpus smaller than C: pad with jittered repeats
        extra = X[rng.integers(0, n, C - len(cent))] + rng.normal(
            0, 1e-3, (C - len(cent), d)).astype(np.float32)
        cent = np.concatenate([cent, extra.astype(np.float32)])
    dev = resolve_device(device)
    Xd = [torch.as_tensor(X[s:s + chunk].astype(np.float32), device=dev)
          for s in range(0, n, chunk)]
    programs = {rows: KmeansProgram(rows, C, d, dev) for rows in {len(x) for x in Xd}}
    top4 = np.zeros((n, min(4, C)), np.int32)
    for it in range(iters):
        cd = torch.as_tensor(cent, device=dev)
        csq = (cd * cd).sum(-1)
        sums = np.zeros((C, d), np.float64)
        cnts = np.zeros(C, np.float64)
        ofs = 0
        for Xc in Xd:
            _, t4, ps, pc, _ = programs[len(Xc)].run(Xc, cd, csq)
            if it == iters - 1:
                top4[ofs:ofs + Xc.shape[0]] = t4.cpu().numpy()
            sums += ps.cpu().numpy().astype(np.float64)
            cnts += pc.cpu().numpy().astype(np.float64)
            ofs += Xc.shape[0]
        dead = cnts == 0
        cnts[dead] = 1.0
        cent = (sums / cnts[:, None]).astype(np.float32)
        if dead.any():  # reseed dead centroids on random points
            cent[dead] = X[rng.integers(0, n, int(dead.sum()))]
    return cent, top4


def _median_cut(X: np.ndarray, idx: np.ndarray, cap: int):
    """Split one oversized cluster's members into <=``cap``-sized parts by
    recursive median cuts on the widest-variance axis: each part stays a
    compact region of the cluster, so its mean is an honest routing centroid."""
    out = []
    stack = [idx]
    while stack:
        ids = stack.pop()
        if len(ids) <= cap:
            out.append(ids)
            continue
        V = X[ids]
        ax = int(V.var(axis=0).argmax())
        order = np.argsort(V[:, ax], kind="stable")
        half = len(ids) // 2
        stack.append(ids[order[:half]])
        stack.append(ids[order[half:]])
    return out


def _build_lists(X: np.ndarray, cent: np.ndarray, top1: np.ndarray, cap: int):
    """(routing centroid, member index array) per list: k-means clusters pass
    through when they fit, oversized ones split locally, empty ones go."""
    lists = []
    order = np.argsort(top1, kind="stable")
    bounds = np.searchsorted(top1[order], np.arange(len(cent) + 1))
    for c in range(len(cent)):
        m = order[bounds[c]:bounds[c + 1]]
        if len(m) == 0:
            continue
        if len(m) <= cap:
            lists.append((cent[c], m))
        else:
            for part in _median_cut(X, m, cap):
                lists.append((X[part].mean(axis=0), part))
    return lists


def _ivf_route(q, cent, csq, nprobe: int, metric: str):
    """[B,d] x [C,d] routing matmul -> the ``nprobe`` nearest list ids, [nprobe, B]."""
    cs = scores_matmul(metric, q.to(torch.float32), cent, csq)  # [B, C]
    _, pc = smallest(cs, nprobe)
    return pc.T


def _ivf_probe(q, Xpk3, xsq3, pcT, kf: int, metric: str):
    """Score one slab per query per probe step and fold it into a running
    top-``kf``. Live memory is one ``[B, cap, d]`` slab batch whatever
    ``nprobe`` is. ``pcT``: [nprobe, B] probed list per step. Returns packed
    rows [B, kf] (-1 where unfilled) and their probe scores."""
    qf = q.to(torch.float32)
    B = q.shape[0]
    cap = Xpk3.shape[1]
    dev = q.device
    vals = torch.full((B, kf), float("inf"), device=dev)
    rows = torch.full((B, kf), -1, dtype=torch.int64, device=dev)
    ar = torch.arange(cap, device=dev)
    for lists in pcT:
        slab = Xpk3[lists]  # [B, cap, d] block gather
        ssq = xsq3[lists]  # [B, cap]
        d = scores_gathered(metric, qf, slab, ssq)
        # padding rows carry the xsq=inf sentinel; only the L2 form reads xsq,
        # so under Dot/Cosine a zero pad row would score a finite 1.0 and could
        # out-rank real negative-similarity candidates: mask explicitly
        d = torch.where(torch.isinf(ssq), float("inf"), d)
        rid = lists[:, None] * cap + ar[None, :]
        vals, idx = smallest(torch.cat([vals, d], 1), kf)
        rows = torch.gather(torch.cat([rows, rid], 1), 1, idx)
    return rows, vals


def _exact_refine(q, Xf3, xsq3, rows, metric: str):
    """Re-score candidate packed rows against the f32 slabs; ascending."""
    L, cap, d = Xf3.shape
    Xf = Xf3.reshape(L * cap, d)
    xsqf = xsq3.reshape(L * cap)
    safe = torch.clamp(rows, 0, L * cap - 1)
    # rows < 0 (unfilled slots) score inf; so do slab padding rows (xsq = inf)
    dd = id_scores(metric, q.to(torch.float32), Xf, xsqf, rows)
    dd = torch.where(~torch.isinf(xsqf[safe]), dd, float("inf"))
    dd, o = torch.sort(dd, dim=1, stable=True)
    return torch.gather(rows, 1, o), dd


def ivf_search(q, cent, csq, Xs3, Xf3, xsq3, nprobe: int, kf: int, metric: str):
    """One batch through route, probe and refine: (packed rows [B, kf],
    dists [B, kf]). What ``IvfProgram`` captures, and the replay's reference."""
    pcT = _ivf_route(q, cent, csq, nprobe, metric)
    rows, _ = _ivf_probe(q, Xs3, xsq3, pcT, kf, metric)
    return _exact_refine(q, Xf3, xsq3, rows, metric)


class IvfFlatIndex:
    """Inverted-file flat index (see the module docstring). API-compatible
    subset of ``Hnsw``; L2, Dot and Cosine. Runs on ``device`` (default
    ``"cuda"``; ``device="cpu"`` runs it on the CPU)."""

    SCAN_DTYPE: Optional[str] = "bfloat16"  # probe-stage slab precision
    OVERFETCH = 8  # first-stage keep = k + OVERFETCH rounded up to 32
    KMEANS_ITERS = 8
    BALANCE = 1.25  # list cap = BALANCE * mean size, rounded up to 8

    def __init__(self, dist="L2", n_clusters: Optional[int] = None,
                 nprobe: int = 8, dtype=np.float32, seed: int = 0x1BF, device=None):
        self.metric = get_metric(dist)
        if self.metric.name not in _IP_METRICS:
            raise ValueError(f"IvfFlatIndex supports {_IP_METRICS}, "
                             f"got {self.metric.name}")
        self.device = resolve_device(device)
        self.dtype = np.dtype(dtype)
        self.n_clusters = n_clusters
        self.nprobe = int(nprobe)
        self.seed = int(seed)
        self._X: Optional[np.ndarray] = None
        self._ids: Optional[np.ndarray] = None
        self._built = None  # (cent, csq, Xpk_scan, Xpk_f32, xsq, row2idx, cap)
        self._programs = ProgramCache()  # the search's programs on ``_built``

    def __len__(self):
        return 0 if self._X is None else len(self._X)

    # ------------------------------------------------------------- ingest ----
    def insert(self, data, origin_id=None):
        if origin_id is None:
            data, origin_id = data
        v = np.asarray(data, np.float32)[None, :]
        self._X = v if self._X is None else np.concatenate([self._X, v])
        i = np.array([origin_id], np.int64)
        self._ids = i if self._ids is None else np.concatenate([self._ids, i])
        self._set_unbuilt()

    def parallel_insert(self, data_with_ids, **kw):
        """Add ``(vector, id)`` pairs, a 2-D array (ids = arange), or an
        ``(X, ids)`` pair of arrays."""
        if isinstance(data_with_ids, np.ndarray):
            X = data_with_ids.astype(np.float32)
            ids = np.arange(len(X), dtype=np.int64)
        elif (isinstance(data_with_ids, tuple) and len(data_with_ids) == 2
              and isinstance(data_with_ids[0], np.ndarray)):
            X = data_with_ids[0].astype(np.float32)
            ids = np.asarray(data_with_ids[1], np.int64)
        else:
            X = np.stack([np.asarray(v, np.float32) for v, _ in data_with_ids])
            ids = np.array([int(i) for _, i in data_with_ids], np.int64)
        self._X = X if self._X is None else np.concatenate([self._X, X])
        self._ids = ids if self._ids is None else np.concatenate([self._ids, ids])
        self._set_unbuilt()

    def _set_unbuilt(self):
        # a captured graph holds raw pointers to the lists it read
        self._built = None
        self.drop_programs()

    def drop_programs(self):
        """Release the captured search programs and their memory pools."""
        self._programs.clear()

    # -------------------------------------------------------------- build ----
    def build(self):
        """k-means + balanced packing into uniform list slabs."""
        if self._built is not None:
            return
        self._build()

    def _build(self):
        n, d = self._X.shape
        C = self.n_clusters or int(np.clip(2 * np.sqrt(n), 16, 4096))
        C = min(C, n)
        X = self._X.astype(np.float32)
        if self.metric.needs_normalized:  # Dot: the reference l2-normalizes inserts
            X = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-30)
        cent, top4 = _kmeans(X, C, self.KMEANS_ITERS, self.seed, device=self.device)
        cap = int(np.ceil(self.BALANCE * n / C))
        cap = max(8, -(-cap // 8) * 8)
        lists = _build_lists(X, cent, top4[:, 0], cap)
        L = len(lists)
        cent = np.stack([c for c, _ in lists]).astype(np.float32)
        # list-major packed layout; padding rows get +inf sqnorm
        row2idx = np.full(L * cap, -1, np.int64)  # packed row -> corpus index
        Xpk = np.zeros((L * cap, d), np.float32)
        for c, (_, m) in enumerate(lists):
            row2idx[c * cap:c * cap + len(m)] = m
            Xpk[c * cap:c * cap + len(m)] = X[m]
        xsq = np.where(row2idx >= 0, (Xpk * Xpk).sum(-1), np.inf).astype(np.float32)
        self._set_built(cent, Xpk, xsq, row2idx, cap)

    def _set_built(self, cent, Xpk, xsq, row2idx, cap: int):
        """Move a packed layout onto the device (``build`` and ``ivf_from_arrays``)."""
        dev = self.device
        cd = torch.as_tensor(np.asarray(cent, np.float32), device=dev)
        L = len(cd)
        Xf3 = torch.as_tensor(np.asarray(Xpk, np.float32), device=dev).reshape(L, cap, -1)
        scan = _DTYPES[self.SCAN_DTYPE]
        Xs3 = Xf3 if scan is None else Xf3.to(scan)
        xsq3 = torch.as_tensor(np.asarray(xsq, np.float32), device=dev).reshape(L, cap)
        self.drop_programs()
        self._built = (cd, (cd * cd).sum(-1), Xs3, Xf3, xsq3,
                       np.asarray(row2idx, np.int64), int(cap))

    @property
    def n_lists(self) -> int:
        self.build()
        return int(self._built[0].shape[0])

    # ------------------------------------------------------------- search ----
    def _queries(self, queries) -> np.ndarray:
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self.metric.needs_normalized:
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
        return q

    def _program(self, batch: int, dtype, np_eff: int, kf: int) -> IvfProgram:
        """The search's program for a batch shape and query dtype (built at
        first use)."""
        lists = self._built[:5]
        static = dict(nprobe=int(np_eff), kf=int(kf), metric=self.metric.name)
        return self._programs.get(None, call_key(lists, batch, dtype, self.device, **static),
                                  lambda: IvfProgram(lists, batch, dtype, self.device,
                                                     **static))

    def _dispatch(self, qs, np_eff: int, kf: int):
        """(packed rows, dists) of one batch on the device, replayed."""
        return self._program(qs.shape[0], qs.dtype, np_eff, kf).run(qs)

    def search_batch(self, queries, knbn: int, ef: int = 0, filter=None,
                     nprobe: Optional[int] = None, chunk: int = 512):
        """Batched search. ``nprobe`` overrides the instance default; ``ef``,
        the graph engine's knob, widens nprobe to at least ``ef / cap`` lists."""
        if self._X is None or len(np.atleast_2d(queries)) == 0:  # no program to run
            q = np.atleast_2d(queries)
            return (np.full((len(q), knbn), -1, np.int64),
                    np.full((len(q), knbn), np.inf, np.float32))
        with PROFILER.span("search.call"):
            with PROFILER.span("search.prepare"):
                self.build()
                np_eff, kf = self._probe_plan(knbn, ef, nprobe, filter)
            q = self._queries(queries)
            qd = torch.as_tensor(q, device=self.device)
            outs = [self._dispatch(qd[s:s + chunk], np_eff, kf)
                    for s in range(0, len(q), chunk)]
            rn = torch.cat([r for r, _ in outs]).cpu().numpy()
            out_d = torch.cat([dd for _, dd in outs]).cpu().numpy()
            with PROFILER.span("search.finish"):
                return self._finish(rn, out_d, knbn, filter)

    def _probe_plan(self, knbn: int, ef: int = 0, nprobe: Optional[int] = None,
                    filter=None):
        """``search_batch``'s (nprobe, kf): ``ef`` widens nprobe to at least
        ``ef / cap`` lists; ``kf`` overfetches for the bf16 probe's rank noise,
        and further under a filter."""
        cent, cap = self._built[0], self._built[6]
        np_eff = int(nprobe or self.nprobe)
        if ef:  # ef ~ candidate budget: match nprobe to it
            np_eff = max(np_eff, -(-int(ef) // cap))
        np_eff = min(np_eff, cent.shape[0])
        k = min(knbn, len(self._X))
        kf = k + self.OVERFETCH if filter is None else 4 * k + self.OVERFETCH
        return np_eff, min(-(-kf // 32) * 32, np_eff * cap)

    def _finish(self, rn, out_d, knbn: int, filter=None):
        """Packed rows and their distances, [B, kf] -> external ids and
        distances [B, knbn]: the filter's host-side post-mask, then -1/inf
        padding."""
        row2idx = self._built[5]
        out_i = np.where(rn >= 0, row2idx[rn], -1)
        ids = np.where(out_i >= 0, self._ids[np.clip(out_i, 0, len(self._ids) - 1)], -1)
        d = np.where(out_i >= 0, out_d, np.inf)
        if filter is not None:
            from ..filter import filter_mask
            ok = filter_mask(filter, ids.reshape(-1)).reshape(ids.shape)
            d = np.where(ok & (ids >= 0), d, np.inf)
            order = np.argsort(d, axis=1, kind="stable")
            d = np.take_along_axis(d, order, 1)
            ids = np.take_along_axis(ids, order, 1)
            ids[~np.isfinite(d)] = -1
        ids, d = ids[:, :knbn], d[:, :knbn]
        if ids.shape[1] < knbn:
            pad = knbn - ids.shape[1]
            ids = np.concatenate([ids, np.full((len(ids), pad), -1, np.int64)], 1)
            d = np.concatenate([d, np.full((len(d), pad), np.inf, np.float32)], 1)
        return ids, d

    def search_stream(self, queries, knbn: int, nprobe: Optional[int] = None,
                      batch: int = 8192, query_dtype="float16"):
        """Pipelined batched search: upload / route + probe + refine / fetch
        overlapped (``ops.stream.pipelined_stream``), f16 query ingest by
        default (device math is f32 either way). Returns
        ``(ids[nq, knbn] int64, dists[nq, knbn] f32)``."""
        from ..ops.stream import fetch_host, pipelined_stream, query_stream, upload_batch

        with PROFILER.span("search.call"):
            q, out_i, out_d, work = query_stream(self._queries(queries), knbn, batch,
                                                 query_dtype)
            with PROFILER.span("search.prepare"):
                self.build()
                row2idx = self._built[5]
                np_eff, kf = self._probe_plan(knbn, 0, nprobe)
                k = min(knbn, len(self._X))
                # every batch shape's program is built before the threads start:
                # a capture must not overlap their copies
                dtype = torch.from_numpy(q[:0]).dtype
                for size in {we - ws for ws, we in work}:
                    self._program(size, dtype, np_eff, kf)

            def upload(w):
                return upload_batch(q[w[0]:w[1]], self.device)

            def dispatch(w, staged):
                return fetch_host(self._dispatch(staged.wait(), np_eff, kf))

            def fetch(w, out):
                ws, we = w
                rows, dd = out.get()
                rn = rows[:, :k]
                ii = np.where(rn >= 0, row2idx[rn], -1)
                out_i[ws:we, :k] = np.where(
                    ii >= 0, self._ids[np.clip(ii, 0, len(self._ids) - 1)], -1)
                out_d[ws:we, :k] = np.where(ii >= 0, dd[:, :k], np.inf)

            pipelined_stream(work, upload, dispatch, fetch)
            return out_i, out_d

    def search(self, data, knbn: int, ef: int = 0, filter=None):
        from .hnsw import Neighbour
        ids, d = self.search_batch(np.asarray(data)[None, :], knbn, ef, filter)
        return [Neighbour(int(i), float(dd), (0, int(i)))
                for i, dd in zip(ids[0], d[0]) if i >= 0]

    def parallel_search(self, queries, knbn: int, ef: int = 0, filter=None,
                        mode: str = "auto"):
        from .hnsw import Neighbour
        ids, d = self.search_batch(queries, knbn, ef, filter)
        return [[Neighbour(int(i), float(dd), (0, int(i)))
                 for i, dd in zip(ids[b], d[b]) if i >= 0]
                for b in range(len(ids))]

    # -------------------------------------------------------- persistence ----
    def save_native(self, path: str):
        """``.npz`` snapshot: raw vectors, ids and build parameters; the packed
        layout is rebuilt from the seeded k-means on load."""
        np.savez_compressed(path, kind="ivf-flat", X=self._X, ids=self._ids,
                            dist=self.metric.name, seed=self.seed,
                            nprobe=self.nprobe,
                            n_clusters=self.n_clusters or 0)

    @classmethod
    def load_native(cls, path: str, device=None) -> "IvfFlatIndex":
        z = np.load(path, allow_pickle=False)
        if str(z.get("kind", "")) != "ivf-flat":
            raise ValueError(f"{path} is not an ivf-flat snapshot")
        ix = cls(dist=str(z["dist"]), seed=int(z["seed"]),
                 nprobe=int(z["nprobe"]),
                 n_clusters=int(z["n_clusters"]) or None, device=device)
        ix._X = z["X"]
        ix._ids = z["ids"]
        return ix


def clusteredness(X: np.ndarray, sample: int = 8192, C: int = 64,
                  seed: int = 7, device=None) -> float:
    """Quantization gain of a small k-means over a sample: 1 - E||x-c||^2 /
    E||x-mu||^2. About 0 for isotropic gaussians, towards 1 for tight
    clusters. ``AutoIndex`` routes clustered corpora by it."""
    rng = np.random.default_rng(seed)
    S = X[rng.permutation(len(X))[:sample]].astype(np.float32)
    cent, top = _kmeans(S, min(C, len(S)), 4, seed, chunk=len(S), device=device)
    qe = float(np.mean(np.sum((S - cent[top[:, 0]]) ** 2, -1)))
    tot = float(np.mean(np.sum((S - S.mean(0)) ** 2, -1)))
    return 1.0 - qe / max(tot, 1e-30)
