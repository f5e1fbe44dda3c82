"""``ShardedHnsw`` with the configuration's arguments on every shard, the
corpus dealt round-robin over ``index.shards`` shards and built through
``parallel_insert(mode="auto")``, which takes the mesh build."""

from __future__ import annotations

import numpy as np


def build(cfg: dict, X: np.ndarray, device):
    """``device`` is one device or a list of them (a cell's cards): shard s
    lives on ``devices[s % len(devices)]``, so four cards hold one shard
    each and a lone device (the CPU in the tests) holds them all."""
    from hnsw_tpu_torch import ShardedHnsw

    ix = cfg["index"]
    devices = list(device) if isinstance(device, (list, tuple)) else [device]
    shards = int(ix["shards"])
    sh = ShardedHnsw(devices=[devices[s % len(devices)] for s in range(shards)],
                     max_nb_connection=ix["max_nb_connection"],
                     max_elements=-(-cfg["n"] // shards),
                     ef_construction=ix["ef_construction"], dist=cfg["metric"])
    sh.set_keeping_pruned(bool(ix["keep_pruned"]))
    sh.modify_level_scale(float(ix["level_scale"]))
    sh.parallel_insert((X, np.arange(len(X), dtype=np.int64)), mode="auto",
                       batch_size=ix["build_batch"])
    return sh


def rows(sh, ids: np.ndarray) -> np.ndarray:
    """Each row was inserted under its place in the corpus: the ids are rows."""
    return ids
