"""Automatic engine selection — counterpart of ``hnsw_tpu/models/auto.py``.

Three engines answer the same search surface: the exact scan
(``BruteForceIndex``; kernel B2 for L2 corpora of ``SCAN_MIN_POINTS`` rows
and more), the HNSW graph (``Hnsw``) and inverted lists (``IvfFlatIndex``).
The scan answers with recall 1.0 and costs O(N·d) per query; the graph costs
about O(log N) per query at a recall that ef tunes; IVF serves clustered
corpora, where beam traversal misses neighbours it cannot reach.

``AutoIndex`` buffers inserts, picks the engine at build time from (N, d,
metric, clusteredness of a sample, recall target) and delegates the search
surface to it. ``engine="hnsw" | "scan" | "ivf"`` forces the choice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .brute import BruteForceIndex
from .hnsw import Hnsw
from .ivf import IvfFlatIndex, clusteredness
from ..ops.distances import get_metric
from ..utils.device import resolve_device


class AutoIndex:
    """Engine-selecting ANN index. API-compatible subset of ``Hnsw``; the
    engine it builds runs on ``device`` (default ``"cuda"``).

    Selection rule (``choose_engine``):

      * fewer than ``SCAN_MIN`` points: exact scan, whatever the metric;
      * other metrics than L2: IVF-Flat for a clustered Dot or Cosine corpus
        (sampled k-means quantization gain >= ``IVF_CLUSTEREDNESS``), else
        the graph (the scan kernel is L2-only);
      * d >= ``HIGH_D``: exact scan;
      * a clustered L2 corpus: exact scan while N·d <= ``IVF_BUDGET``, IVF
        beyond;
      * recall_target >= 0.99 and N·d <= ``SCAN_BUDGET``: exact scan;
      * otherwise: the graph.
    """

    # The JAX package's crossovers, kept as they are so that both packages
    # choose the same engine for the same corpus. They were measured on its
    # accelerator and not on this card: re-measuring them here is open.
    SCAN_MIN = 32_768
    HIGH_D = 512
    SCAN_BUDGET = 5.0e8
    IVF_BUDGET = 3.3e8
    IVF_CLUSTEREDNESS = 0.65  # sampled quantization gain (models/ivf.clusteredness)

    def __init__(self, dist="L2", recall_target: float = 0.98,
                 engine: Optional[str] = None, device=None, **hnsw_kwargs):
        if engine not in (None, "hnsw", "scan", "ivf"):
            raise ValueError(f"engine must be 'hnsw' | 'scan' | 'ivf' | None, "
                             f"got {engine!r}")
        self.metric = get_metric(dist)
        self.device = resolve_device(device)
        self.recall_target = float(recall_target)
        self._forced = engine
        self._hnsw_kwargs = dict(hnsw_kwargs)
        self._buf_v: list[np.ndarray] = []
        self._buf_id: list[int] = []
        self._engine = None  # built lazily

    # ------------------------------------------------------------- ingest ----
    def insert(self, data, origin_id=None):
        if origin_id is None:
            data, origin_id = data
        if self._engine is not None:
            self._engine.insert(data, origin_id)
            return
        self._buf_v.append(np.asarray(data, np.float32))
        self._buf_id.append(int(origin_id))

    def parallel_insert(self, data_with_ids, **kw):
        if self._engine is not None:
            self._engine.parallel_insert(data_with_ids, **kw)
            return
        for v, i in data_with_ids:
            self._buf_v.append(np.asarray(v, np.float32))
            self._buf_id.append(int(i))

    def __len__(self):
        return len(self._buf_v) if self._engine is None else len(self._engine)

    # -------------------------------------------------------------- build ----
    def _clustered(self) -> bool:
        X = np.stack(self._buf_v[: 8192])
        return clusteredness(X, device=self.device) >= self.IVF_CLUSTEREDNESS

    def choose_engine(self) -> str:
        """The selection rule, exposed for inspection and tests."""
        if self._forced:
            return self._forced
        n = len(self._buf_v)
        d = self._buf_v[0].shape[-1] if n else 0
        if n < self.SCAN_MIN:
            return "scan"
        if self.metric.name not in ("L2", "DistL2"):
            if (self.metric.name in ("Dot", "DistDot", "Cosine", "DistCosine")
                    and self._clustered()):
                return "ivf"
            return "hnsw"
        if d >= self.HIGH_D:
            return "scan"
        if self._clustered():
            return "scan" if n * d <= self.IVF_BUDGET else "ivf"
        if self.recall_target >= 0.99 and n * d <= self.SCAN_BUDGET:
            return "scan"
        return "hnsw"

    def build(self):
        """Materialize the chosen engine from the buffered inserts."""
        if self._engine is not None:
            return self._engine
        kind = self.choose_engine()
        pairs = list(zip(self._buf_v, self._buf_id))
        if kind == "scan":
            eng = BruteForceIndex(dist=self.metric, device=self.device)
            if pairs:
                eng.parallel_insert(pairs)
        elif kind == "ivf":
            eng = IvfFlatIndex(dist=self.metric, device=self.device)
            if pairs:
                eng.parallel_insert(pairs)
            eng.build()
        else:
            kw = dict(self._hnsw_kwargs)
            kw.setdefault("max_elements", max(len(pairs), 1))
            eng = Hnsw(dist=self.metric, device=self.device, **kw)
            if pairs:
                eng.parallel_insert(pairs)
        self._engine = eng
        self._buf_v, self._buf_id = [], []
        return eng

    @property
    def engine(self):
        return self.build()

    @property
    def engine_name(self) -> str:
        eng = self.engine
        if isinstance(eng, BruteForceIndex):
            return "scan"
        return "ivf" if isinstance(eng, IvfFlatIndex) else "hnsw"

    # ------------------------------------------------------------- search ----
    def search(self, data, knbn: int, ef: int = 0, filter=None):
        eng = self.engine
        if isinstance(eng, Hnsw):
            return eng.search_possible_filter(data, knbn, ef, filter)
        return eng.search(data, knbn, ef, filter=filter)

    def search_batch(self, queries, knbn: int, ef: int = 0, filter=None):
        return self.engine.search_batch(queries, knbn, ef, filter=filter)

    def search_filter(self, data, knbn: int, ef: int, filter):
        return self.search(data, knbn, ef, filter=filter)

    def parallel_search(self, queries, knbn: int, ef: int = 0, filter=None,
                        mode: str = "auto"):
        eng = self.engine
        if isinstance(eng, Hnsw):
            return eng.parallel_search(queries, knbn, ef, filter=filter, mode=mode)
        return eng.parallel_search(queries, knbn, ef, filter=filter)

    def file_dump(self, path, basename: str) -> str:
        """Reference-format dump; the graph engine only (the scan and IVF keep
        no graph: construct ``AutoIndex(engine="hnsw")`` for it)."""
        eng = self.engine
        if not isinstance(eng, Hnsw):
            raise ValueError("file_dump requires the hnsw engine; "
                             "construct AutoIndex(engine='hnsw') for "
                             "reference-format persistence")
        return eng.file_dump(path, basename)
