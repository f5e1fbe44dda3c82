"""Graph-topology export — counterpart of ``hnsw_tpu/models/flatten.py``, the
analog of reference ``src/flatten.rs``.

``FlatNeighborhood`` is a topology-only snapshot keyed by external id: each point's
neighbors across ALL layers merged and sorted by distance (reference ``flatten_point``,
``src/flatten.rs:74-89``). In this engine the index already *is* flat arrays, so this
is mostly a re-keying plus layer merge; it exists for API parity and for graph-only
(``NoData``/``NoDist``) reloads at low memory (reference ``src/flatten.rs:94-126``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .hnsw import Hnsw, Neighbour


@dataclasses.dataclass
class FlatPoint:
    origin_id: int
    p_id: tuple[int, int]
    neighbours: list[Neighbour]


class FlatNeighborhood:
    def __init__(self, hnsw: Hnsw):
        self._map: dict[int, FlatPoint] = {}
        n = hnsw._nb_point
        for i in range(n):
            merged: list[Neighbour] = []
            for l in sorted(hnsw._layers):
                ids, dists = hnsw.neighbour_row(i, l)
                for j, d in zip(ids, dists):
                    merged.append(Neighbour(hnsw.get_origin_id(int(j)), float(d),
                                            hnsw.get_point_id(int(j))))
            merged.sort()
            oid = hnsw.get_origin_id(i)
            self._map[oid] = FlatPoint(oid, hnsw.get_point_id(i), merged)

    def get_neighbours(self, data_id: int) -> list[Neighbour] | None:
        fp = self._map.get(int(data_id))
        return fp.neighbours if fp is not None else None

    def get_point(self, data_id: int) -> FlatPoint | None:
        return self._map.get(int(data_id))

    def __len__(self):
        return len(self._map)

    def __eq__(self, other):
        if not isinstance(other, FlatNeighborhood) or len(self) != len(other):
            return False
        for k, fp in self._map.items():
            op = other._map.get(k)
            if op is None or fp.p_id != op.p_id or len(fp.neighbours) != len(op.neighbours):
                return False
            for a, b in zip(fp.neighbours, op.neighbours):
                if a.d_id != b.d_id or abs(a.distance - b.distance) > 1e-5:
                    return False
        return True
