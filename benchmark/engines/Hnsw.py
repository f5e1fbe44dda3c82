"""``Hnsw`` with the configuration's arguments, built through the device
build (``parallel_insert(mode="device")``)."""

from __future__ import annotations

import numpy as np


def empty(cfg: dict, device):
    """An empty ``Hnsw`` with the configuration's arguments."""
    from hnsw_tpu_torch import Hnsw

    ix = cfg["index"]
    h = Hnsw(max_nb_connection=ix["max_nb_connection"], max_elements=cfg["n"],
             ef_construction=ix["ef_construction"], dist=cfg["metric"], device=device)
    h.set_keeping_pruned(bool(ix["keep_pruned"]))
    h.modify_level_scale(float(ix["level_scale"]))
    return h


def insert(h, cfg: dict, X: np.ndarray, start: int = 0):
    """Rows ``X`` into ``h`` through the device build, their ids their
    places in the corpus from ``start`` on."""
    ix = cfg["index"]
    h.parallel_insert((X, np.arange(start, start + len(X), dtype=np.int64)), mode="device",
                      batch_size=ix["build_batch"], build_max_iters=ix["build_max_iters"])


def build(cfg: dict, X: np.ndarray, device):
    h = empty(cfg, device)
    insert(h, cfg, X)
    return h


def rows(h, ids: np.ndarray) -> np.ndarray:
    """The index's internal rows as the ids they were inserted under."""
    return np.where(ids >= 0, h._origin[np.clip(ids, 0, max(h._nb_point - 1, 0))], -1)
