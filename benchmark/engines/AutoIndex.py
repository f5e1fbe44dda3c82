"""``AutoIndex`` with the configuration's metric and recall target: the
engine it chooses for the corpus (``recall_target`` and the corpus' depth)."""

from __future__ import annotations

import numpy as np


def build(cfg: dict, X: np.ndarray, device):
    from hnsw_tpu_torch import AutoIndex

    a = AutoIndex(cfg["metric"], recall_target=cfg["index"]["recall_target"], device=device)
    a.parallel_insert(zip(X, range(len(X))))
    a.build()
    return a


def rows(a, ids: np.ndarray) -> np.ndarray:
    """Each row was inserted under its place in the corpus: the ids are rows."""
    return ids
