"""HNSW index with a flat-array representation, host oracle core, and device
delegates — counterpart of ``hnsw_tpu/models/hnsw.py``.

The graph is dense per-layer tables (``ids: int32[cap, width_l]`` /
``dists: float32[cap, width_l]``, -1 padded; ``width_0 = 2*M``, ``width_l = M``)
indexed by insertion order, so the same arrays serve the host oracle (the
reference's serial semantics: ``search_layer``, ``insert``,
``select_neighbours``, ``reverse_update_neighborhood_simple``,
``search_filter``, reference ``src/hnsw.rs:922-1599``), the batched torch
paths (``ops/beam_search.py``, ``ops/insert_rounds.py``) and the parity tests.
The host side is numpy, as in the JAX package; the batched paths run on
``Hnsw.device`` (default ``"cuda"``; ``device="cpu"`` runs them on the CPU).

``file_dump`` and ``save_native`` delegate to ``io/hnswio.py``; a reload with
``ReloadOptions(datamap=True)`` leaves ``_data`` a ``LazyMmapData`` view over
the dump's data file (``io/datamap.py``) instead of an array.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from ..ops.distances import Metric, get_metric
from ..utils.rng import LevelSampler, DEFAULT_SEED
from ..filter import resolve_filter
from ..utils.device import resolve_device
from ..utils.profiling import PROFILER

NB_LAYER_MAX = 16  # reference src/hnsw.rs:42
MAX_NB_CONNECTION = 256  # reference src/hnsw.rs:784-787


@dataclasses.dataclass(frozen=True)
class Neighbour:
    """Search answer, mirroring reference ``Neighbour`` (``src/hnsw.rs:98-125``):
    external id, distance to the query, and internal (layer, rank) coordinate."""

    d_id: int
    distance: float
    p_id: tuple[int, int]

    def __lt__(self, other):  # ordered by distance, as reference src/flatten.rs:19-43
        return self.distance < other.distance


@dataclasses.dataclass
class PointIdWithOrder:
    """A (layer, rank) PointId carrying a distance to an external reference
    point — reference ``PointIdWithOrder`` (``src/hnsw.rs:59-92``): equality and
    ordering are BY DISTANCE ONLY (the id is payload), the comparator contract
    its brute-force test harness sorts candidate lists with."""

    point_id: tuple[int, int]
    dist_to_ref: float

    def __eq__(self, other):
        return self.dist_to_ref == other.dist_to_ref

    def __lt__(self, other):
        return self.dist_to_ref < other.dist_to_ref


def _point_keys(h, n: int) -> np.ndarray:
    """Each of the first ``n`` points' PointId (layer, rank) as one int64."""
    return (np.asarray(h._level[:n], np.int64) << 32) + np.asarray(h._rank_in_layer[:n],
                                                                   np.int64)


def _sorted_rows(h, layer: int, order, keys, width: int):
    """``layer``'s rows of ``h`` in ``order``: (the neighbours' PointId keys,
    their distances rounded to 5 decimals), each row sorted by (key, distance)
    and padded to ``width`` with (int64 max, inf)."""
    n = len(order)
    big = np.iinfo(np.int64).max
    K = np.full((n, width), big, np.int64)
    D = np.full((n, width), np.inf, np.float64)
    t = h._layers.get(layer)
    if t is not None:
        w = t.ids.shape[1]
        ids = np.asarray(t.ids[:n])[order]
        valid = np.arange(w)[None, :] < np.asarray(t.counts[:n])[order][:, None]
        K[:, :w] = np.where(valid, keys[np.clip(ids, 0, n - 1)], big)
        D[:, :w] = np.where(valid, np.round(np.asarray(t.dists[:n], np.float64)[order], 5),
                            np.inf)
    o = np.argsort(D, axis=1, kind="stable")
    K, D = np.take_along_axis(K, o, 1), np.take_along_axis(D, o, 1)
    o = np.argsort(K, axis=1, kind="stable")
    return np.take_along_axis(K, o, 1), np.take_along_axis(D, o, 1)


def _same_rows(a, b) -> bool:
    """The same PointIds with the same origin ids, and in every layer each
    point's (neighbour PointId, distance to 5 decimals) pairs equal."""
    n = a._nb_point
    ka, kb = _point_keys(a, n), _point_keys(b, n)
    oa, ob = np.argsort(ka, kind="stable"), np.argsort(kb, kind="stable")
    if not (np.array_equal(ka[oa], kb[ob])
            and np.array_equal(np.asarray(a._origin[:n])[oa], np.asarray(b._origin[:n])[ob])):
        return False
    for layer in set(a._layers) | set(b._layers):
        w = max(h._layers[layer].ids.shape[1] for h in (a, b) if layer in h._layers)
        (xa, da), (xb, db) = (_sorted_rows(a, layer, oa, ka, w),
                              _sorted_rows(b, layer, ob, kb, w))
        if not (np.array_equal(xa, xb) and np.array_equal(da, db)):
            return False
    return True


class _LayerTable:
    """Dense neighbor table for one layer: row per global point index."""

    __slots__ = ("ids", "dists", "counts", "width")

    def __init__(self, cap: int, width: int):
        self.width = width
        self.ids = np.full((cap, width), -1, dtype=np.int32)
        self.dists = np.full((cap, width), np.inf, dtype=np.float32)
        self.counts = np.zeros(cap, dtype=np.int32)

    def grow(self, new_cap: int):
        pad = new_cap - self.ids.shape[0]
        if pad <= 0:
            return
        self.ids = np.concatenate([self.ids, np.full((pad, self.width), -1, np.int32)])
        self.dists = np.concatenate([self.dists, np.full((pad, self.width), np.inf, np.float32)])
        self.counts = np.concatenate([self.counts, np.zeros(pad, np.int32)])

    def grow_width(self, new_width: int):
        """Add reserve columns (navigability repair links live past the prune's
        budget — evicting from full rows just re-orphans the evicted target)."""
        pad = new_width - self.width
        if pad <= 0:
            return
        r = self.ids.shape[0]
        self.ids = np.concatenate([self.ids, np.full((r, pad), -1, np.int32)], 1)
        self.dists = np.concatenate([self.dists, np.full((r, pad), np.inf, np.float32)], 1)
        self.width = new_width

    def row(self, i: int):
        c = self.counts[i]
        return self.ids[i, :c], self.dists[i, :c]

    def set_row(self, i: int, ids, dists):
        n = len(ids)
        if n > self.width:  # e.g. reloading a dump of a repaired (widened) graph
            self.grow_width(n)
        self.ids[i, :n] = ids
        self.dists[i, :n] = dists
        self.ids[i, n:] = -1
        self.dists[i, n:] = np.inf
        self.counts[i] = n


class Hnsw:
    """HNSW index (PyTorch port).

    Parameters mirror reference ``Hnsw::new`` (``src/hnsw.rs:766-787``):
    ``max_nb_connection`` (M), ``max_elements`` (capacity hint), ``max_layer`` (≤16),
    ``ef_construction``, and the distance (name, :class:`Metric`, ``UserMetric``
    or a Python pair function).
    ``device`` is where the batched build and search run (default ``"cuda"``;
    raises when CUDA is absent unless ``device="cpu"``).
    """

    def __init__(self, max_nb_connection: int = 16, max_elements: int = 10_000,
                 max_layer: int = 16, ef_construction: int = 200, dist="L2",
                 dtype=np.float32, seed: int = DEFAULT_SEED, level_scale: float | None = None,
                 device=None):
        if max_nb_connection > MAX_NB_CONNECTION:
            raise ValueError(f"max_nb_connection must be <= {MAX_NB_CONNECTION}")
        if not (0 < max_layer <= NB_LAYER_MAX):
            raise ValueError(f"max_layer must be in (0, {NB_LAYER_MAX}]")
        self.device = resolve_device(device)
        self.max_nb_connection = int(max_nb_connection)
        self.max_layer = int(max_layer)
        self.ef_construction = int(ef_construction)
        self.metric: Metric = get_metric(dist)
        self.dtype = np.dtype(dtype)
        self.extend_candidates = False  # reference default, src/hnsw.rs:806
        self.keep_pruned = False  # reference default, src/hnsw.rs:807
        self.searching = False  # reference src/hnsw.rs:759-760 (advisory flag)
        self.datamap_opt = False
        self.level_sampler = LevelSampler(max_nb_connection, max_layer, seed=seed, scale=level_scale)

        self._cap = max(int(max_elements), 8)
        self._dim: Optional[int] = None
        self._data: Optional[np.ndarray] = None  # [cap, dim] of self.dtype
        self._origin = np.full(self._cap, -1, dtype=np.int64)
        self._level = np.full(self._cap, -1, dtype=np.int32)
        self._rank_in_layer = np.full(self._cap, -1, dtype=np.int32)
        self._layers: dict[int, _LayerTable] = {}
        self._layer_npoints = np.zeros(NB_LAYER_MAX, dtype=np.int64)  # points with level == l
        self._entry: int = -1
        self._nb_point: int = 0
        self._version: int = 0  # bumped on any mutation; invalidates device caches
        self._device_cache = None
        self._codec_kind = "auto"  # beam-traversal codec policy (set_traversal_codec)
        self._codec_cache = None
        self._programs = None  # captured search programs (ops/program.py), per version

    # ------------------------------------------------------------------ accessors ---

    def __len__(self):
        return self._nb_point

    def get_nb_point(self) -> int:
        return self._nb_point

    def get_ef_construction(self) -> int:
        return self.ef_construction

    def get_max_nb_connection(self) -> int:
        return self.max_nb_connection

    def get_max_level(self) -> int:
        return self.max_layer

    def get_max_level_observed(self) -> int:
        # reference: level of the entry point (src/hnsw.rs:474-481)
        return int(self._level[self._entry]) if self._entry >= 0 else 0

    def get_distance_name(self) -> str:
        return self.metric.name

    def get_distance(self) -> Metric:
        return self.metric

    def set_extend_candidates(self, flag: bool):
        self.extend_candidates = bool(flag)

    def set_keeping_pruned(self, flag: bool):
        self.keep_pruned = bool(flag)

    def set_searching_mode(self, flag: bool):
        self.searching = bool(flag)

    def set_datamap(self, flag: bool):
        self.datamap_opt = bool(flag)

    def modify_level_scale(self, factor: float):
        # reference warns when called on a non-empty index (src/hnsw.rs:884-887)
        if self._nb_point > 0:
            import logging
            logging.getLogger(__name__).warning(
                "modify_level_scale called on a non-empty index; levels already sampled keep the old scale")
        self.level_sampler.set_scale_modification(factor)

    def get_level_scale(self) -> float:
        return self.level_sampler.get_scale()

    def get_layer_nb_point(self, layer: int) -> int:
        return int(self._layer_npoints[layer]) if layer < NB_LAYER_MAX else 0

    def dump_layer_info(self):
        for l in range(self.get_max_level_observed() + 1):
            print(f" layer {l} : length : {self._layer_npoints[l]}")

    def get_point_id(self, idx: int) -> tuple[int, int]:
        return (int(self._level[idx]), int(self._rank_in_layer[idx]))

    def get_point_data(self, p_id: tuple[int, int]) -> Optional[np.ndarray]:
        """Vector for a (layer, rank) PointId, or None when the id is not
        coherent — reference ``get_point_data`` (``src/hnsw.rs:587-598``),
        the random accessor used after reloading a dump. Returns a copy."""
        layer, rank = int(p_id[0]), int(p_id[1])
        if rank < 0 or layer > self.get_max_level_observed() \
                or rank >= self.get_layer_nb_point(layer):
            return None
        n = self._nb_point
        idx = np.flatnonzero((self._level[:n] == layer)
                             & (self._rank_in_layer[:n] == rank))
        if not len(idx):
            return None
        return np.array(self._data[int(idx[0])])

    def get_vector(self, idx: int) -> np.ndarray:
        return self._data[idx]

    def get_origin_id(self, idx: int) -> int:
        return int(self._origin[idx])

    def iter_points(self) -> Iterable[tuple[int, np.ndarray]]:
        """Yield (origin_id, vector) over all points, layer 0 upward then by rank —
        the traversal order of reference ``IterPoint`` (``src/hnsw.rs:629-729``)."""
        order = self._iteration_order()
        for i in order:
            yield int(self._origin[i]), self._data[i]

    def iter_layer(self, layer: int) -> Iterable[tuple[int, np.ndarray]]:
        for i in np.flatnonzero(self._level[: self._nb_point] == layer):
            yield int(self._origin[i]), self._data[i]

    def _iteration_order(self) -> np.ndarray:
        n = self._nb_point
        lv = self._level[:n]
        rk = self._rank_in_layer[:n]
        return np.lexsort((rk, lv))

    def neighbour_row(self, idx: int, layer: int):
        t = self._layers.get(layer)
        if t is None:
            return np.empty(0, np.int32), np.empty(0, np.float32)
        return t.row(idx)

    # ---------------------------------------------------------------- allocation ----

    def _ensure_cap(self, need: int):
        if need <= self._cap:
            return
        new_cap = self._cap
        while new_cap < need:
            new_cap *= 2
        if isinstance(self._data, np.ndarray):
            self._data = np.concatenate(
                [self._data, np.zeros((new_cap - self._cap, self._dim), self.dtype)])
        elif self._data is not None:  # LazyMmapData grows its permutation only
            self._data.grow(new_cap)
        for a_name in ("_origin", "_level", "_rank_in_layer"):
            old = getattr(self, a_name)
            pad = np.full(new_cap - self._cap, -1, old.dtype)
            setattr(self, a_name, np.concatenate([old, pad]))
        for t in self._layers.values():
            t.grow(new_cap)
        self._cap = new_cap

    def _layer_width(self, layer: int) -> int:
        return 2 * self.max_nb_connection if layer == 0 else self.max_nb_connection

    def _layer_table(self, layer: int) -> _LayerTable:
        t = self._layers.get(layer)
        if t is None:
            t = _LayerTable(self._cap, self._layer_width(layer))
            self._layers[layer] = t
        return t

    def _set_dim(self, dim: int):
        if self._dim is None:
            self._dim = int(dim)
            self._data = np.zeros((self._cap, self._dim), self.dtype)
        elif dim != self._dim:
            raise ValueError(f"dimension mismatch: index built with dim={self._dim}, got {dim}")

    def _allocate(self, data: np.ndarray, origin_id: int, level: Optional[int] = None) -> int:
        """Reference ``generate_new_point`` (``src/hnsw.rs:503-531``): sample the level,
        assign (level, rank) coordinate, store the vector."""
        self._set_dim(len(data))
        self._ensure_cap(self._nb_point + 1)
        idx = self._nb_point
        lv = self.level_sampler.generate_one() if level is None else int(level)
        self._data[idx] = np.asarray(data, dtype=self.dtype)
        self._origin[idx] = origin_id
        self._level[idx] = lv
        self._rank_in_layer[idx] = self._layer_npoints[lv]
        self._layer_npoints[lv] += 1
        self._nb_point += 1
        self._version += 1
        return idx

    # ------------------------------------------------------------- search_layer -----

    def _dists_to(self, q: np.ndarray, idxs: np.ndarray) -> np.ndarray:
        return self.metric.np_batch(q, self._data[idxs]).astype(np.float64)

    def _search_layer(self, q: np.ndarray, ep: int, ef: int, layer: int,
                      filt: Optional[Callable[[int], bool]] = None) -> list[tuple[float, int]]:
        """Greedy best-first search within one layer — exact semantics of reference
        ``search_layer`` (``src/hnsw.rs:922-1064``). Returns up to ``ef`` (distance,
        idx) pairs, unsorted (heap order)."""
        if self.get_layer_nb_point(layer) == 0:
            return []
        table = self._layers.get(layer)
        d0 = float(self.metric.np_batch(q, self._data[ep][None, :])[0])
        visited = {ep}
        candidates = [(d0, ep)]  # min-heap on distance to q
        results = [(-d0, ep)]  # max-heap via negation, capped at ef
        while candidates:
            c_d, c = heapq.heappop(candidates)
            if not results:
                # every retained result was filtered away and nothing refilled —
                # the reference bails out of the scan in this state (src/hnsw.rs:1023-1029)
                return results
            if c_d > -results[0][0]:
                # c is farther than the worst retained result ("fast return" check)
                if filt is None:
                    break
                if len(results) >= ef:
                    # filtered mode: retain only filter-passing results and KEEP
                    # scanning — later candidates may refill (src/hnsw.rs:993-1002)
                    results = [(nd, i) for (nd, i) in results
                               if filt(int(self._origin[i]))]
                    heapq.heapify(results)
            if table is None:
                continue
            nb_ids, _ = table.row(c)
            fresh = [int(e) for e in nb_ids if int(e) not in visited]
            if not fresh:
                continue
            visited.update(fresh)
            e_dists = self._dists_to(q, np.array(fresh, dtype=np.int64))
            for e, e_d in zip(fresh, e_dists):
                if not results:
                    return results  # src/hnsw.rs:1023-1029
                e_d = float(e_d)
                if e_d < -results[0][0] or len(results) < ef:
                    heapq.heappush(candidates, (e_d, e))
                    if filt is None:
                        heapq.heappush(results, (-e_d, e))
                    elif filt(int(self._origin[e])):
                        # if the sole retained result is only there as the seed and
                        # fails the filter, evict it for the first passing point
                        # (src/hnsw.rs:1040-1048)
                        if (len(results) == 1
                                and not filt(int(self._origin[results[0][1]]))):
                            results.clear()
                        heapq.heappush(results, (-e_d, e))
                    if len(results) > ef:
                        heapq.heappop(results)
        return results

    # ------------------------------------------------------------ select_neighbours --

    def _select_neighbours(self, q: np.ndarray, candidates: list[tuple[float, int]],
                           nb_asked: int, extend: bool, layer: int,
                           keep_pruned: bool) -> list[tuple[float, int]]:
        """Heuristic neighbor selection (paper Alg. 4) — semantics of reference
        ``select_neighbours`` (``src/hnsw.rs:1299-1421``). ``candidates`` are
        (dist, idx); returns (dist, idx) list (diversity-kept prefix sorted by
        distance, pruned refills appended)."""
        cand = sorted(candidates)
        if len(cand) <= nb_asked and not extend:
            return cand
        if len(cand) <= nb_asked and extend:
            seen = {i for _, i in cand}
            table = self._layers.get(layer)
            extra = []
            if table is not None:
                for _, i in list(cand):
                    nb_ids, _ = table.row(i)
                    for e in nb_ids:
                        e = int(e)
                        if e not in seen:
                            seen.add(e)
                            extra.append(e)
            if extra:
                e_dists = self._dists_to(q, np.array(extra, dtype=np.int64))
                cand = sorted(cand + list(zip(map(float, e_dists), extra)))
        kept: list[tuple[float, int]] = []
        discarded: list[tuple[float, int]] = []
        for e_d, e in cand:
            if len(kept) >= nb_asked:
                break
            ok = True
            if kept:
                kept_idx = np.array([i for _, i in kept], dtype=np.int64)
                dd = self.metric.np_batch(self._data[e], self._data[kept_idx])
                ok = not bool((dd <= e_d).any())
            if ok:
                kept.append((e_d, e))
            elif keep_pruned:
                heapq.heappush(discarded, (e_d, e))
        while discarded and len(kept) < nb_asked:
            kept.append(heapq.heappop(discarded))
        return kept

    # ------------------------------------------------------------------- insert -----

    def insert(self, data, origin_id: Optional[int] = None):
        """Serial insert — reference ``insert_slice`` (``src/hnsw.rs:1077-1215``).
        Accepts ``insert((vec, id))`` (reference tuple style) or ``insert(vec, id)``."""
        if origin_id is None:
            data, origin_id = data
        data = np.asarray(data, dtype=self.dtype)
        idx = self._allocate(data, origin_id)
        level = int(self._level[idx])
        if self._nb_point == 1 or self._entry < 0:
            self._entry = idx
            return idx
        max_level_observed = int(self._level[self._entry])
        ep = self._entry
        dist_to_entry = float(self.metric.np_batch(data, self._data[ep][None, :])[0])
        # upper-layer greedy descent with ef=1, recording "projection" links
        # (reference src/hnsw.rs:1114-1155)
        for l in range(max_level_observed, level, -1):
            res = self._search_layer(data, ep, 1, l, None)
            if res:
                e_d, e_idx = -res[0][0], res[0][1]
                t = self._layer_table(l)
                if t.counts[idx] < self.max_nb_connection:
                    ids, dists = t.row(idx)
                    t.set_row(idx, np.append(ids, e_idx), np.append(dists, e_d))
                if e_d < dist_to_entry:
                    ep = e_idx
                    dist_to_entry = e_d
        # construction loop, layers level..0 (reference src/hnsw.rs:1156-1205)
        for l in range(level, -1, -1):
            res = self._search_layer(data, ep, self.ef_construction, l, None)
            if not res:
                continue
            cand = [(-nd, i) for nd, i in res]
            if l == 0:
                nb_conn, extend = 2 * self.max_nb_connection, self.extend_candidates
            else:
                nb_conn, extend = self.max_nb_connection, False
            neighbours = self._select_neighbours(data, cand, nb_conn, extend, l, self.keep_pruned)
            neighbours.sort()
            t = self._layer_table(l)
            t.set_row(idx, np.array([i for _, i in neighbours], np.int32),
                      np.array([d for d, _ in neighbours], np.float32))
            if neighbours:
                ep = neighbours[0][1]
        self._reverse_update(idx, level)
        if level > int(self._level[self._entry]):
            self._entry = idx  # reference check_entry_point (src/hnsw.rs:534-557)
        self._version += 1
        return idx

    def _reverse_update(self, idx: int, level: int):
        """Back-link insertion — reference ``reverse_update_neighborhood_simple``
        (``src/hnsw.rs:1241-1289``). Backlinks always recorded at layer ``l_n`` =
        the new point's level, deduped, sorted, shrunk to the layer threshold."""
        l_n = level
        threshold = 2 * self.max_nb_connection if l_n == 0 else self.max_nb_connection
        t_ln = self._layer_table(l_n)
        for l in range(level, -1, -1):
            t = self._layers.get(l)
            if t is None:
                continue
            q_ids, q_dists = t.row(idx)
            for q, d in zip(q_ids, q_dists):
                q = int(q)
                if q == idx:
                    continue
                ids, dists = t_ln.row(q)
                if idx in ids:
                    continue
                ids = np.append(ids, idx)
                dists = np.append(dists, np.float32(d))
                order = np.argsort(dists, kind="stable")
                ids, dists = ids[order], dists[order]
                if len(ids) > threshold:
                    ids, dists = ids[:-1], dists[:-1]
                t_ln.set_row(q, ids, dists)

    # ------------------------------------------------------------------- search -----

    def search_filter(self, data, knbn: int, ef_arg: int, filter=None) -> list[Neighbour]:
        """Production search path — reference ``search_filter``
        (``src/hnsw.rs:1487-1599``): one-scan-per-layer greedy descent from the entry
        point's level down to layer 1, then ``search_layer`` at the lowest non-empty
        layer with ``ef = max(ef, knbn)``."""
        if self._entry < 0:
            return []
        filt = resolve_filter(filter)
        data = np.asarray(data, dtype=self.dtype)
        pivot = self._entry
        dist_to_entry = float(self.metric.np_batch(data, self._data[pivot][None, :])[0])
        for layer in range(int(self._level[self._entry]), 0, -1):
            t = self._layers.get(layer)
            if t is None:
                continue
            nb_ids, _ = t.row(pivot)
            if len(nb_ids) == 0:
                continue
            dd = self._dists_to(data, nb_ids.astype(np.int64))
            j = int(np.argmin(dd))
            if dd[j] < dist_to_entry:
                dist_to_entry = float(dd[j])
                pivot = int(nb_ids[j])
        ef = max(ef_arg, knbn)
        layer_to_search = 0
        while self.get_layer_nb_point(layer_to_search) == 0:
            layer_to_search += 1
        res = self._search_layer(data, pivot, ef, layer_to_search, filt)
        res_sorted = sorted([(-nd, i) for nd, i in res])
        last = min(knbn, ef, len(res_sorted))
        out = []
        for d, i in res_sorted[:last]:
            oid = int(self._origin[i])
            if filt is None or filt(oid):
                out.append(Neighbour(oid, float(d), self.get_point_id(i)))
        return out

    def search_general(self, data, knbn: int, ef_arg: int) -> list[Neighbour]:
        """Textbook top-down search (paper Alg. 5) — reference ``search_general``
        (``src/hnsw.rs:1433-1482``, unused by its production path but part of the
        API): full ``search_layer`` with ef=1 per upper layer, then ef at layer 0."""
        if self._entry < 0:
            return []
        data = np.asarray(data, dtype=self.dtype)
        ep = self._entry
        for layer in range(int(self._level[self._entry]), 0, -1):
            res = self._search_layer(data, ep, 1, layer, None)
            if res:
                ep = res[0][1]
        ef = max(ef_arg, knbn)
        res = self._search_layer(data, ep, ef, 0, None)
        res_sorted = sorted([(-nd, i) for nd, i in res])[: min(knbn, ef, len(res))]
        return [Neighbour(int(self._origin[i]), float(d), self.get_point_id(i))
                for d, i in res_sorted]

    def search(self, data, knbn: int, ef_arg: int) -> list[Neighbour]:
        return self.search_filter(data, knbn, ef_arg, None)

    def search_possible_filter(self, data, knbn, ef_arg, filter=None):
        return self.search_filter(data, knbn, ef_arg, filter)

    # ---------------------------------------------------- batched / parallel paths ---

    def _batched_mode(self, mode: str, large: bool) -> str:
        """Resolve ``mode`` to ``"device"`` or ``"serial"``. ``"auto"`` takes
        the device when the work is ``large`` and the metric has a batched
        form (every builtin but NoDist, a ``UserMetric`` given ``scores``),
        else the serial host path. An explicit ``"device"`` with a metric that
        has none (NoDist, a bare callable) raises: the caller asked for the
        accelerator and would get the host without notice."""
        if mode == "auto":
            return "device" if large and self.metric.scores is not None else "serial"
        if mode == "device" and self.metric.scores is None:
            raise ValueError(f"mode='device': metric {self.metric.name!r} has no batched "
                             "form; use mode='serial' or mode='auto'")
        return mode

    def parallel_insert(self, data_with_ids: Sequence[tuple], mode: str = "auto",
                        batch_size: Optional[int] = None,
                        build_max_iters: Optional[int] = None):
        """Batched insertion — capability analog of reference ``parallel_insert``
        (``src/hnsw.rs:1224-1238``). ``mode="device"`` runs synchronized batched
        rounds on the accelerator (intra-round points don't see each other — the same
        "small deviation" contract the reference documents for its thread races,
        ``src/hnsw.rs:1222-1223``); ``mode="serial"`` loops the exact serial oracle;
        ``"auto"`` picks by size.

        Fast array form: pass a 2-D array (ids become ``arange``) or an
        ``(X, ids)`` tuple of arrays — the build then bulk-copies rows instead
        of iterating a million Python tuples (the reference's slice-of-tuples
        ingestion is a rayon-ism; arrays are the natural device-side input).

        A ``"device"`` build on the card resets the card's CUDA peak memory
        statistics (``torch.cuda.reset_peak_memory_stats``) to measure its
        round programs (``device_parallel_insert``): read a peak taken across
        it with ``ops.program.peak_memory``, started with
        ``ops.program.reset_peak_memory``."""
        X = ids = None
        if isinstance(data_with_ids, np.ndarray) and data_with_ids.ndim == 2:
            X = np.asarray(data_with_ids, dtype=self.dtype)
            ids = np.arange(len(X), dtype=np.int64)
        elif (isinstance(data_with_ids, tuple) and len(data_with_ids) == 2
              and isinstance(data_with_ids[0], np.ndarray)
              and np.asarray(data_with_ids[0]).ndim == 2):
            X = np.asarray(data_with_ids[0], dtype=self.dtype)
            ids = np.asarray(data_with_ids[1], dtype=np.int64)
            if len(ids) != len(X):
                raise ValueError(f"ids length {len(ids)} != rows {len(X)}")
        if X is not None:
            n = len(X)
            mode = self._batched_mode(mode, n >= 2048)
            if mode == "serial":
                for j in range(n):
                    self.insert(X[j], int(ids[j]))
                return
            from ..ops.insert_rounds import device_parallel_insert
            device_parallel_insert(self, (X, ids), batch_size=batch_size,
                                   build_max_iters=build_max_iters)
            return
        pairs = [(np.asarray(v, dtype=self.dtype), int(i)) for v, i in data_with_ids]
        mode = self._batched_mode(mode, len(pairs) >= 2048)
        if mode == "serial":
            for v, i in pairs:
                self.insert(v, i)
            return
        from ..ops.insert_rounds import device_parallel_insert
        device_parallel_insert(self, pairs, batch_size=batch_size,
                               build_max_iters=build_max_iters)

    def parallel_insert_slice(self, data_with_ids, **kw):
        self.parallel_insert(data_with_ids, **kw)

    def _pair_dists(self, a_idx, b_idx, chunk: int = 1024) -> np.ndarray:
        """Elementwise metric distances between point pairs (a_idx[i], b_idx[i])."""
        out = np.empty(len(a_idx))
        for s in range(0, len(a_idx), chunk):
            out[s:s + chunk] = self.metric.pairs(self._data[a_idx[s:s + chunk]],
                                                 self._data[b_idx[s:s + chunk]])
        return out

    def ensure_navigable(self, max_rounds: int = 4096, sample: int = 8192,
                         min_indegree: int = 2,
                         time_budget_s: Optional[float] = None) -> int:
        """Make every point reachable by the search, returning repair-link count.

        Directed-BFS the layer-0 table from the same entry-pivot set the search
        snapshot seeds from; for each unreached point add one backlink from its
        nearest *reached* forward-neighbor (evicting that row's farthest link
        when full); when an island has no edge into the reached set at all,
        bridge the closest sampled cross pair bidirectionally. Repeats with a
        full re-verification BFS until clean (an eviction can in principle
        re-orphan the evicted target).

        Why this exists: the diversity prune (reference ``src/hnsw.rs:1365-1395``)
        starves points of in-links on clustered corpora — measured 19,109 of
        40,000 points with in-degree ZERO and recall plateaued at 0.50
        regardless of ef, with 99% of missed ground-truth ids simply
        unreachable (see ops/components.py). The reference has the identical
        failure mode (0.28 recall @ ef=512 on the same corpus) and no repair;
        here reachability is a build-time guarantee instead of luck. Cost: one
        host BFS over the dense table plus O(#orphans) row edits — seconds at
        1M — and each repair evicts only some row's farthest link.
        """
        n = self._nb_point
        t = self._layers.get(0)
        if n < 2 or t is None or self._data is None:
            return 0  # (graph-only reloads carry no vectors to score links)
        import os

        from ..ops.graph_arrays import compute_pivots
        from ..utils.logging import init_logging

        W_cap = t.width + 16  # reserve-column budget for repair links
        pv = compute_pivots(self, t.ids[:n], n)
        if pv is None:
            lv = np.flatnonzero(self._level[:n] >= 1)
            ent = [self._entry] if self._entry >= 0 else []
            pv = np.unique(np.concatenate([lv, ent]).astype(np.int64)) if (len(lv) or ent) else np.array([0])
        rng = np.random.default_rng(0x5EED)
        repairs = 0
        self._repair_incomplete = 0  # unreached count when the budget fires
        import time as _time
        if time_budget_s is None:
            time_budget_s = float(os.environ.get("HNSW_REPAIR_BUDGET_S", "600"))
        deadline = _time.monotonic() + time_budget_s

        def force_link(r_idx, u_idx, d):
            """Vectorized grouped append: link (u, d) into rows r, where r_idx
            MAY repeat — each parent row absorbs as many orphans as it has
            free columns below W_cap this round (plus always at least one,
            growing reserve columns when saturated). NEVER evicts — an
            eviction can silently remove some point's last in-link, and
            measured both failure modes: an evict-based repair churned 30k
            links at 40k points with reachability stuck at 0.55, and a
            reserve-capped variant regressed reachability 0.979 -> 0.959
            because its last-resort evictions landed after verification.
            One-orphan-per-parent-per-round (the previous form) made repair
            rounds scale with the largest orphan group; grouping bounds the
            round count by free capacity instead. Returns the mask of pairs
            actually linked this call."""
            if not len(r_idx):
                return np.zeros(0, bool)
            order = np.argsort(r_idx, kind="stable")
            r_s, u_s, d_s = r_idx[order], u_idx[order], d[order]
            first = np.searchsorted(r_s, r_s)
            rank = np.arange(len(r_s)) - first  # position within parent group
            slot = t.counts[r_s] + rank
            keep = (slot < W_cap) | (rank == 0)  # rank0 may grow past W_cap
            r_s, u_s, d_s, slot = r_s[keep], u_s[keep], d_s[keep], slot[keep]
            need = int(slot.max()) + 1
            if need > t.width:
                # quantum 8, as in the JAX package: the repaired table width
                # (and with it the codec's block geometry) stays identical
                # between the two implementations
                t.grow_width(-(-need // 8) * 8)
            t.ids[r_s, slot] = u_s
            t.dists[r_s, slot] = d_s
            uniq, cnts = np.unique(r_s, return_counts=True)
            t.counts[uniq] += cnts.astype(t.counts.dtype)
            rd = t.dists[uniq]
            o = np.argsort(rd, 1, kind="stable")
            t.dists[uniq] = np.take_along_axis(rd, o, 1)
            t.ids[uniq] = np.take_along_axis(t.ids[uniq], o, 1)
            linked = np.zeros(len(r_idx), bool)
            linked[order[keep]] = True
            return linked

        for _ in range(8):  # verification passes (evictions can re-orphan)
            reached = np.zeros(n, bool)
            reached[pv] = True
            frontier = np.asarray(pv)

            def expand(frontier):
                while len(frontier):
                    nb = t.ids[frontier]
                    nb = nb[nb >= 0]
                    nb = np.unique(nb)
                    frontier = nb[~reached[nb]]
                    reached[frontier] = True

            expand(frontier)
            if reached.all():
                break
            for _ in range(max_rounds):
                U = np.flatnonzero(~reached)
                if not len(U):
                    break
                rows = t.ids[U]
                ok = (rows >= 0) & reached[np.clip(rows, 0, n - 1)]
                has = ok.any(1)
                if has.any():
                    # Repair-row choice: the NEAREST reached forward-neighbor
                    # WITH SPARE CAPACITY (rows are distance-sorted, so the
                    # first such column is the nearest); fall back to the
                    # least-full reached neighbor when all are saturated.
                    # Nearest-first alone concentrated repairs on a few hub
                    # rows — measured: hubs overflowed the reserve, fell back
                    # to evictions, and churned (23.6k repairs, reachability
                    # stuck at 0.63). Pure load-balancing converged (0.979)
                    # but attached orphans to far parents the beam rarely
                    # expands (recall stuck at 0.69 @ ef=256). force_link
                    # groups repeated parents, filling each row's free
                    # columns in one round.
                    cnt = t.counts[np.clip(rows, 0, n - 1)]
                    load = np.where(ok, cnt, np.iinfo(np.int32).max)
                    # two-tier: a row with a FREE slot (no table growth —
                    # growing widens every row's hot-path gather) beats a row
                    # that needs reserve columns, beats eviction
                    cand0 = ok & (cnt < t.width)
                    cand = np.where(cand0.any(1, keepdims=True), cand0,
                                    ok & (cnt < W_cap))
                    use = cand.any(1)
                    m = np.flatnonzero(has)
                    best = np.where(use[m], np.argmax(cand[m], 1),
                                    np.argmin(load[m], 1))
                    u_c = U[m]
                    r_c = rows[m, best]
                    linked = force_link(r_c, u_c, self._pair_dists(r_c, u_c))
                    u_sel = u_c[linked]
                    reached[u_sel] = True
                    expand(u_sel)
                    repairs += len(u_sel)
                    if _time.monotonic() > deadline:
                        self._repair_incomplete = int((~reached).sum())
                        init_logging().warning(
                            "ensure_navigable: time budget %.0fs exhausted "
                            "mid-reachability (%d repairs; %d still "
                            "unreached)", time_budget_s, repairs,
                            self._repair_incomplete)
                        return self._finish_repair(repairs)
                else:
                    # island with zero edges into the reached set: bridge the
                    # closest sampled cross pair, bidirectionally
                    us = U if len(U) <= sample else rng.choice(U, sample, False)
                    rs_all = np.flatnonzero(reached)
                    rs = (rs_all if len(rs_all) <= sample
                          else rng.choice(rs_all, sample, False))
                    dm = self.metric.np_batch(self._data[us], self._data[rs])
                    iu, ir = np.unravel_index(np.argmin(dm), dm.shape)
                    u, r, d = int(us[iu]), int(rs[ir]), float(dm[iu, ir])
                    force_link(np.array([r]), np.array([u]), np.array([d]))
                    force_link(np.array([u]), np.array([r]), np.array([d]))
                    reached[u] = True
                    expand(np.array([u]))
                    repairs += 2
        # In-degree reinforcement: reachability alone leaves repaired points
        # with ONE in-link from one specific parent the beam must happen to
        # expand — measured misses after the reachability pass were exactly
        # the indeg==1 points (recall stuck at 0.69 @ ef=256 on the clustered
        # family). Give every non-pivot point >= min_indegree in-links from
        # its nearest forward-neighbors with spare row capacity.
        if min_indegree > 0:
            is_pv = np.zeros(n, bool)
            is_pv[pv] = True
            prev_deficit = None
            for _ in range(max_rounds):
                valid = t.ids[:n]
                # bincount, not np.add.at: the scatter-add form is ~30x
                # slower and this runs once per reinforcement round over the
                # full [n, width] table
                indeg = np.bincount(valid[valid >= 0], minlength=n)
                low = np.flatnonzero((indeg[:n] < min_indegree) & ~is_pv)
                deficit = int((min_indegree - indeg[low]).sum())
                if not len(low) or deficit == prev_deficit:
                    break  # done, or no progress (unlinkable stragglers)
                prev_deficit = deficit
                rows = t.ids[low]
                cnt = t.counts[np.clip(rows, 0, n - 1)]
                free = (rows >= 0) & (cnt < t.width)
                space = np.where(free.any(1, keepdims=True), free,
                                 (rows >= 0) & (cnt < W_cap))
                # skip parents that already link to u (duplicate edge)
                dup = np.zeros_like(space)
                for s in range(0, len(low), 2048):
                    rr = np.clip(rows[s:s + 2048], 0, n - 1)
                    dup[s:s + 2048] = (t.ids[rr] ==
                                       low[s:s + 2048, None, None]).any(2)
                cand = space & ~dup
                hasc = cand.any(1)
                if not hasc.any():
                    break  # remaining low-indeg points have no linkable parent
                m = np.flatnonzero(hasc)
                # nearest linkable parent (rows are distance-sorted; measured
                # equal to an in-degree/"visibility"-weighted choice and 2x
                # cheaper)
                pick = np.argmax(cand[m], 1)
                r_c = rows[m, pick]
                u_c = low[m]
                linked = force_link(r_c, u_c, self._pair_dists(r_c, u_c))
                repairs += int(linked.sum())
                if _time.monotonic() > deadline:
                    init_logging().warning(
                        "ensure_navigable: time budget %.0fs exhausted during "
                        "in-degree reinforcement (%d repairs)",
                        time_budget_s, repairs)
                    break
        return self._finish_repair(repairs)

    def _finish_repair(self, repairs: int) -> int:
        """EVERY ``ensure_navigable`` exit path must pass through here: the
        version bump invalidates the device/codec caches (keyed on ``_version``
        in ``_device_graph``/``_device_codec``), so even a budget-truncated
        repair is served instead of a stale pre-repair snapshot."""
        if repairs:
            self._version += 1
        return repairs

    def parallel_search(self, queries, knbn: int, ef: int, filter=None,
                        mode: str = "auto") -> list[list[Neighbour]]:
        """Batched search — analog of reference ``parallel_search``
        (``src/hnsw.rs:1601-1635``); answers are returned in input order. On device the
        whole batch runs as one batched beam search."""
        queries = np.asarray(queries, dtype=self.dtype)
        if queries.ndim == 1:
            queries = queries[None, :]
        mode = self._batched_mode(mode, len(queries) >= 4 and self._nb_point >= 64)
        if mode == "serial":
            return [self.search_filter(q, knbn, ef, filter) for q in queries]
        ids, dists = self.search_batch(queries, knbn, ef, filter=filter)
        out = []
        for b in range(ids.shape[0]):
            row = []
            for j in range(ids.shape[1]):
                i = int(ids[b, j])
                if i < 0:
                    continue
                row.append(Neighbour(int(self._origin[i]), float(dists[b, j]), self.get_point_id(i)))
            out.append(row)
        return out

    def search_batch(self, queries, knbn: int, ef: int, filter=None,
                     pool: Optional[int] = None, seeds: int = 4):
        """Device batched search over the dense graph: returns (internal_ids[B,k],
        dists[B,k]); ids are ``-1`` padded. ``pool`` (>= knbn) accumulates every
        scored candidate into a reservoir and reranks it exactly — the large-k
        serving mode (beam stays narrow while the pool carries the results)."""
        from ..ops.beam_search import device_search_batch
        with PROFILER.span("search.call"):
            return device_search_batch(self, np.asarray(queries, dtype=self.dtype),
                                       knbn, ef, filter, pool=pool, seeds=seeds)

    # ------------------------------------------------------------- device graph -----

    def set_entry_pivots(self, count: Optional[int] = None):
        """Entry pivot set for the device search path. ``None`` (default): all
        level>=1 points — the upper HNSW hierarchy, scanned in one matmul
        instead of the greedy descent. An int widens the set with an evenly
        spaced corpus sample (IVF-style coarse index: closer starts, fewer beam
        iterations). ``0`` disables pivots (greedy descent entry)."""
        if count is not None and count < 0:
            raise ValueError(f"pivot count must be >= 0, got {count}")
        self._pivot_count = count
        self._device_cache = None
        self.drop_programs()

    def set_device_dtype(self, dtype):
        """Vector dtype of the device search path: float32 (default) or bfloat16
        (half the gather bytes; inner products keep f32 accumulation — costs a
        fraction of a recall point on near-ties)."""
        import torch
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
            str(dtype).replace("torch.", ""), dtype)
        if dt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported device dtype {dtype!r}")
        self._device_dtype = dt
        self._device_cache = None
        self.drop_programs()

    def device_graph(self):
        """The dense arrays as tensors on ``self.device`` (cached per version)."""
        from ..ops.graph_arrays import GraphArrays
        dt = getattr(self, "_device_dtype", None)
        if self._device_cache is None or self._device_cache.version != self._version:
            kw = {"device_dtype": dt} if dt is not None else {}
            self._device_cache = GraphArrays.from_host(self, **kw)
        return self._device_cache

    def set_traversal_codec(self, kind, width=None):
        """Beam-traversal vector codec: ``"i8"`` (blocked int8 store + exact f32
        rerank — the fast path), ``"bf16"``, ``None`` (exact f32 gather), or
        ``"auto"`` (default: i8 once the index reaches ``CODEC_MIN_POINTS`` and
        the blocks fit ``CODEC_MAX_BYTES``, ``ops/graph_arrays.py::codec_kind``).

        ``width`` caps the blocked neighborhood to the nearest ``width`` layer-0
        links per node (default: the full table width, 2*M)."""
        if kind not in ("i8", "bf16", "auto", None):
            raise ValueError(f"unknown codec kind {kind!r}")
        if width is not None and width < 1:
            raise ValueError(f"codec width must be >= 1, got {width}")
        self._codec_kind = kind
        self._codec_width = width
        self._codec_cache = None
        self.drop_programs()

    def device_codec(self):
        """The (cached) BeamCodec for the current graph version, or None."""
        from ..ops.graph_arrays import BeamCodec, codec_kind
        cw = getattr(self, "_codec_width", None)

        def est():
            g0 = self.device_graph()
            w = g0.layer_ids[0].shape[1]
            if cw is not None:
                w = min(int(cw), w)  # width-capped codec is smaller — size it as such
            return g0.cap1 * (w + 8) * (self._dim or 1)  # +8: codec id rows

        kind = codec_kind(getattr(self, "_codec_kind", "auto"), self.metric.name,
                          self._nb_point, est)
        if kind is None:
            return None
        cache = getattr(self, "_codec_cache", None)
        if cache is None or cache[0] != self._version:
            cache = (self._version, BeamCodec.build(self.device_graph(), kind=kind, width=cw))
            self._codec_cache = cache
        return cache[1]

    def device_program(self, batch: int, dtype, **static):
        """The captured search program (``ops/program.py``) for a batch of
        ``batch`` queries of ``dtype`` and ``search_program``'s static
        arguments, built at first use and cached beside the device graph and
        the codec: a version bump, a new codec or new pivots drop it."""
        from ..ops.program import ProgramCache, SearchProgram, program_key
        g, codec = self.device_graph(), self.device_codec()
        if self._programs is None:
            self._programs = ProgramCache()
        dev = g.vectors.device
        key = program_key(g, codec, batch, dtype, dev, **static)
        return self._programs.get(self._version, key, lambda: SearchProgram(
            g, codec, batch, dtype, dev, **static))

    def drop_programs(self):
        """Release the captured search programs and their memory pools."""
        if self._programs is not None:
            self._programs.clear()

    # --------------------------------------------------------------- persistence ----

    def file_dump(self, path, basename: str) -> str:
        """Reference-format dump (``src/api.rs:70-94``); returns the (possibly
        uniquified) basename."""
        from ..io.hnswio import file_dump as _fd
        return _fd(self, path, basename)

    def save_native(self, path: str):
        from ..io.hnswio import save_native as _sn
        _sn(self, path)

    # ------------------------------------------------------------------ equality ----

    def _pid_index(self) -> dict[tuple[int, int], int]:
        """PointId -> storage index; the JAX package's ``check_graph_equality``
        aligns an index of this package through it."""
        n = self._nb_point
        return {(int(self._level[i]), int(self._rank_in_layer[i])): i for i in range(n)}

    def check_graph_equality(self, other: "Hnsw") -> bool:
        """Structural equality — reference ``check_graph_equality``
        (``src/hnsw.rs:1686-1753``): entry point, per-layer membership, and per-point
        neighbor lists including distances. Points are aligned by their (layer, rank)
        coordinate, since internal storage order differs between a live build
        (insertion order) and a reload (layer order)."""
        if self._nb_point != other._nb_point:
            return False
        if (self._entry < 0) != (other._entry < 0):
            return False
        if self._entry >= 0 and self.get_point_id(self._entry) != other.get_point_id(other._entry):
            return False
        return _same_rows(self, other)
