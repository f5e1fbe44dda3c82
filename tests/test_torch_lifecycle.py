"""Lifecycle in the port, the twin of ``tests/test_lifecycle.py``: repeated
build/drop cycles release cleanly (host memory, and the index's tensors once
it is dropped), the native tier's handles too, and the ``AnnT`` facade
contract holds for the same classes as in the JAX package."""

import gc
import weakref

import numpy as np
import torch

torch.set_num_threads(2)

import hnsw_tpu as J
from hnsw_tpu_torch import AnnT, BruteForceIndex, Hnsw, NativeHnsw


def test_repeated_build_drop(rng):
    import tracemalloc
    X = rng.random((300, 8)).astype(np.float32)
    pairs = list(zip(X, range(300)))
    alive = []

    def cycle():
        h = Hnsw(max_nb_connection=8, max_elements=300, ef_construction=40, device="cpu")
        h.parallel_insert(pairs, mode="serial")
        h.search(X[0], 3, 16)
        h.search_batch(X[:4], 3, 16)  # the device snapshot and its program
        alive.append(weakref.ref(h.device_graph().vectors))
        del h

    cycle()
    gc.collect()
    tracemalloc.start()
    base = tracemalloc.take_snapshot()
    for _ in range(5):
        cycle()
    gc.collect()
    now = tracemalloc.take_snapshot()
    growth = sum(s.size_diff for s in now.compare_to(base, "filename")
                 if s.size_diff > 0)
    tracemalloc.stop()
    # five full build/drop cycles of a ~10KB index should not accumulate memory
    assert growth < 8 * 1024 * 1024, f"leaked {growth} bytes over 5 cycles"
    assert all(r() is None for r in alive), "a dropped index kept its tensors"


def test_native_drop_cycles(rng):
    X = rng.random((200, 8)).astype(np.float32)
    for _ in range(5):
        nh = NativeHnsw(max_nb_connection=8, max_elements=200, ef_construction=40)
        nh.parallel_insert(X, np.arange(200), n_threads=1)
        ids, _ = nh.search(X[0], 3, 16)
        assert len(ids) == 3 and ids[0] == 0
        del nh
    gc.collect()


def test_ann_facade_protocol():
    assert isinstance(Hnsw(max_nb_connection=8, device="cpu"), AnnT)
    assert isinstance(J.Hnsw(max_nb_connection=8), J.AnnT)
    bf = BruteForceIndex(device="cpu")
    assert hasattr(bf, "insert") and hasattr(bf, "parallel_insert")
    # the facade asks the same of an index in both packages
    members = {m for m in dir(AnnT) if not m.startswith("_")}
    assert members == {m for m in dir(J.AnnT) if not m.startswith("_")}
