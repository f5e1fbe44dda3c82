"""Exact nearest-neighbour search by brute force — counterpart of
``hnsw_tpu/models/brute.py``.

L2 corpora of ``SCAN_MIN_POINTS`` rows and more go through the exact scan
(kernel B2, ``ops/scan_topk.py``): a bf16 scan keeps
``scan_topk.refine_width(k, overfetch)`` finalists per query (32 at k=10),
re-scored in f32. Smaller corpora and metrics with a
matmul form (L1, Dot, Cosine, user metrics with ``matmul_scores``) take one
matmul + top-k (``_bf_topk``); the others score the broadcast corpus through
their gathered form, a chunk of queries at a time.

Both routes replay captured programs (``ops/program.py``: ``ScanProgram``
and ``TopkProgram``, CUDA graphs on the card), kept in the index's
``ProgramCache`` and dropped on every insert, as the JAX package runs
``pallas_l2_topk`` and ``_bf_topk`` jitted.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.beam_search import scores_gathered, smallest
from ..ops.distances import get_metric
from ..ops.program import ProgramCache, TopkProgram, call_key
from ..utils.device import resolve_device
from ..utils.profiling import PROFILER

# elements of one [queries, N, d] broadcast block of the gathered fallback
_BROADCAST_ELEMS = 1 << 27


def _bf_topk(q, X, xsq, k: int, metric: str):
    m = get_metric(metric)
    if m.matmul_scores is not None:
        return smallest(m.matmul_scores(q, X, xsq), k)
    N, d = X.shape
    step = max(1, _BROADCAST_ELEMS // max(1, N * d))
    vs, ix = [], []
    for s in range(0, q.shape[0], step):
        qs = q[s:s + step]
        v, i = smallest(scores_gathered(metric, qs, X[None].expand(qs.shape[0], N, d)), k)
        vs.append(v)
        ix.append(i)
    return torch.cat(vs), torch.cat(ix)


class BruteForceIndex:
    """Exact nearest-neighbour index (flat). API-compatible subset of ``Hnsw``."""

    SCAN_MIN_POINTS = 32_768
    # Scan precision: bf16 corpus copy and queries, f32 products; the refine
    # re-scores refine_width(k, SCAN_OVERFETCH) finalists against the f32 corpus.
    # None scans the f32 corpus itself (the full-precision first stage: entry
    # "tf32x3" on the card), as the JAX package's SCAN_DTYPE = None does.
    SCAN_DTYPE: Optional[torch.dtype] = torch.bfloat16
    SCAN_OVERFETCH = 8

    def __init__(self, dist="L2", dtype=np.float32, device=None):
        self.metric = get_metric(dist)
        self.dtype = np.dtype(dtype)
        self.device = resolve_device(device)
        self._X: Optional[np.ndarray] = None
        self._ids: Optional[np.ndarray] = None
        self._dev = None
        self._dev_scan = None
        self._programs = ProgramCache()  # both routes' programs, keyed by call_key

    def __len__(self):
        return 0 if self._X is None else len(self._X)

    def insert(self, data, origin_id=None):
        if origin_id is None:
            data, origin_id = data
        v = np.asarray(data, self.dtype)[None, :]
        self._X = v if self._X is None else np.concatenate([self._X, v])
        i = np.array([origin_id], np.int64)
        self._ids = i if self._ids is None else np.concatenate([self._ids, i])
        self._reset_device()

    def _reset_device(self):
        # a captured graph holds raw pointers to the tensors it read
        self._dev = self._dev_scan = None
        self.drop_programs()

    def drop_programs(self):
        """Release the captured programs and their memory pools."""
        self._programs.clear()

    def parallel_insert(self, data_with_ids, **kw):
        """Add ``(vector, id)`` pairs, a 2-D array (ids = arange), or an
        ``(X, ids)`` pair of arrays."""
        if isinstance(data_with_ids, np.ndarray):
            X = np.asarray(data_with_ids, self.dtype)
            ids = np.arange(len(self), len(self) + len(X), dtype=np.int64)
        elif (isinstance(data_with_ids, tuple) and len(data_with_ids) == 2
              and isinstance(data_with_ids[0], np.ndarray)):
            X = np.asarray(data_with_ids[0], self.dtype)
            ids = np.asarray(data_with_ids[1], np.int64)
        else:
            X = np.stack([np.asarray(v, self.dtype) for v, _ in data_with_ids])
            ids = np.array([int(i) for _, i in data_with_ids], np.int64)
        self._X = X if self._X is None else np.concatenate([self._X, X])
        self._ids = ids if self._ids is None else np.concatenate([self._ids, ids])
        self._reset_device()

    def _device(self):
        if self._dev is None:
            Xd = torch.as_tensor(self._X.astype(np.float32), device=self.device)
            self._dev = (Xd, (Xd * Xd).sum(-1))
        return self._dev

    def _use_scan(self) -> bool:
        return (self.metric.name in ("L2", "DistL2") and self._X is not None
                and len(self._X) >= self.SCAN_MIN_POINTS)

    def _scan_device(self):
        if self._dev_scan is None:
            from ..ops.scan_topk import pad_corpus, scan_acc, scan_copy, SCAN_TN
            # shuffled row order (perm maps scan row -> our row), see pad_corpus
            Xp, xsq, perm = pad_corpus(self._X.astype(np.float32), tn=SCAN_TN)
            Xd = torch.as_tensor(Xp, device=self.device)
            # bf16 with zero columns up to the kernel's 16-column step; with
            # SCAN_DTYPE None the f32 rows themselves (a zero-padded copy only
            # where d is not a multiple of the f32 scan's 4-column step)
            Xscan = scan_copy(Xd, self.SCAN_DTYPE or torch.float32)
            self._dev_scan = (Xd, torch.as_tensor(xsq, device=self.device),
                              None if Xscan is Xd else Xscan, perm, scan_acc(Xp.shape[0]),
                              self._programs)
        return self._dev_scan

    def search_batch(self, queries, knbn: int, ef: int = 0, filter=None):
        if self._X is None or len(np.atleast_2d(queries)) == 0:  # no program to run
            q = np.atleast_2d(queries)
            return (np.full((len(q), knbn), -1, np.int64),
                    np.full((len(q), knbn), np.inf, np.float32))
        with PROFILER.span("search.call"):
            q = np.atleast_2d(np.asarray(queries, np.float32))
            kf = self._fetch_width(knbn, filter)
            if self._use_scan():
                from ..ops.scan_topk import l2_topk_stream
                with PROFILER.span("search.prepare"):
                    Xd, xsq, Xscan, perm, acc, programs = self._scan_device()
                d, idx = l2_topk_stream(q, Xd, xsq, kf, Xscan=Xscan,
                                        overfetch=self.SCAN_OVERFETCH, acc=acc,
                                        batch=min(2048, max(256, len(q))), programs=programs)
                with PROFILER.span("search.finish"):
                    return self._finish(d, perm[np.clip(idx, 0, len(perm) - 1)], knbn,
                                        filter)
            with PROFILER.span("search.prepare"):
                Xd, xsq = self._device()
                prog = self._programs.get(
                    None, call_key((Xd, xsq), len(q), torch.float32, self.device, k=kf,
                                   metric=self.metric.name),
                    lambda: TopkProgram(Xd, xsq, len(q), self.device, k=kf,
                                        metric=self.metric.name))
            dj, ij = prog.run(torch.as_tensor(q, device=self.device))
            d = dj.cpu().numpy()
            idx = ij.cpu().numpy()
            with PROFILER.span("search.finish"):
                return self._finish(d, idx, knbn, filter)

    def _fetch_width(self, knbn: int, filter=None) -> int:
        """Candidates a search fetches: ``k``, or ``kf`` under a filter."""
        k = min(knbn, len(self._X))
        # a filter post-masks the fetched candidates, on both routes: fetch kf
        # so the filtered answer still holds k survivors at moderate
        # selectivity (the JAX package overfetches on its scan only and gives
        # its matmul route k, which leaves filtered rows short)
        return k if filter is None else min(len(self._X), ((4 * k + 63) // 32) * 32)

    def _finish(self, d, idx, knbn: int, filter=None):
        """Rows of the corpus and their distances, [B, kf] -> external ids and
        distances [B, knbn]: the filter's host-side post-mask, then -1/inf
        padding."""
        ids = self._ids[idx]
        if filter is not None:
            from ..filter import filter_mask
            ok = filter_mask(filter, ids.reshape(-1)).reshape(ids.shape)
            d = np.where(ok, d, np.inf)
            order = np.argsort(d, axis=1, kind="stable")
            d = np.take_along_axis(d, order, 1)
            ids = np.take_along_axis(ids, order, 1)
            ids[~np.isfinite(d)] = -1
        ids = ids[:, :knbn]
        d = d[:, :knbn]
        if ids.shape[1] < knbn:
            pad = knbn - ids.shape[1]
            ids = np.concatenate([ids, np.full((len(ids), pad), -1, np.int64)], 1)
            d = np.concatenate([d, np.full((len(d), pad), np.inf, np.float32)], 1)
        return ids, d

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
