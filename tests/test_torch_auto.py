"""``AutoIndex`` of the port (``hnsw_tpu_torch/models/auto.py``) on the CPU:
the engine it chooses equals the JAX package's for the same buffered corpus
under each rule, the forced-engine check, delegation of the search surface to
each engine, inserts after the build, and the AnnT facade."""

import tempfile

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import hnsw_tpu as J
import hnsw_tpu_torch as T


@pytest.fixture
def rng():
    return np.random.default_rng(41)


def _pairs(rng, n, d):
    X = rng.standard_normal((n, d)).astype(np.float32)
    return X, list(zip(X, range(n)))


def _clustered(rng, n, d=16, C=6, spread=0.05):
    cent = rng.standard_normal((C, d)).astype(np.float32)
    return (cent[rng.integers(0, C, n)]
            + spread * rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


# (dist, recall_target, overrides of the class thresholds, corpus, rows, d, want)
RULES = [
    ("small", "L2", 0.98, {}, "gauss", 300, 16, "scan"),
    ("large-low-d", "L2", 0.98, {"SCAN_MIN": 100}, "gauss", 200, 32, "hnsw"),
    ("high-recall", "L2", 0.995, {"SCAN_MIN": 100}, "gauss", 200, 32, "scan"),
    ("past-scan-budget", "L2", 0.995, {"SCAN_MIN": 100, "SCAN_BUDGET": 100}, "gauss",
     200, 32, "hnsw"),
    ("high-d", "L2", 0.98, {"SCAN_MIN": 100, "HIGH_D": 32}, "gauss", 200, 32, "scan"),
    ("large-cosine", "Cosine", 0.98, {"SCAN_MIN": 100}, "gauss", 200, 32, "hnsw"),
    ("large-hamming", "Hamming", 0.98, {"SCAN_MIN": 100}, "gauss", 200, 32, "hnsw"),
    ("clustered-l2", "L2", 0.98, {"SCAN_MIN": 512}, "clustered", 600, 16, "scan"),
    ("clustered-l2-past-budget", "L2", 0.98, {"SCAN_MIN": 512, "IVF_BUDGET": 100},
     "clustered", 600, 16, "ivf"),
    ("clustered-cosine", "Cosine", 0.98, {"SCAN_MIN": 512}, "clustered", 600, 16, "ivf"),
    ("clustered-dot", "Dot", 0.98, {"SCAN_MIN": 512}, "clustered", 600, 16, "ivf"),
]


@pytest.mark.parametrize("rule", RULES, ids=[r[0] for r in RULES])
def test_choose_engine_matches_reference(rng, rule):
    _, dist, target, over, corpus, n, d, want = rule
    if corpus == "gauss":
        X = rng.standard_normal((n, d)).astype(np.float32)
    else:
        X = _clustered(rng, n, d)
    pairs = list(zip(X, range(n)))
    got = []
    for a in (T.AutoIndex(dist=dist, recall_target=target, device="cpu"),
              J.AutoIndex(dist=dist, recall_target=target)):
        for k, v in over.items():
            setattr(a, k, v)
        a.parallel_insert(pairs)
        got.append(a.choose_engine())
    assert got == [want, want], got


def test_thresholds_match_reference():
    for k in ("SCAN_MIN", "HIGH_D", "SCAN_BUDGET", "IVF_BUDGET", "IVF_CLUSTEREDNESS"):
        assert getattr(T.AutoIndex, k) == getattr(J.AutoIndex, k), k


def test_forced_engine(rng):
    with pytest.raises(ValueError):
        T.AutoIndex(engine="bogus", device="cpu")
    X, pairs = _pairs(rng, 50, 8)
    g = T.AutoIndex(dist="L2", engine="hnsw", device="cpu")
    g.parallel_insert(pairs[:10])
    assert g.choose_engine() == "hnsw"  # forced overrides the size rule


def test_scan_engine_end_to_end(rng):
    X, pairs = _pairs(rng, 400, 24)
    a = T.AutoIndex(dist="L2", device="cpu")
    a.parallel_insert(pairs)
    assert a.engine_name == "scan" and isinstance(a.engine, T.BruteForceIndex)
    assert a.engine.device.type == "cpu"
    res = a.search(X[7], 3, 32)
    assert res[0].d_id == 7
    ids, d = a.search_batch(X[:16], 5, 32)
    assert (ids[:, 0] == np.arange(16)).all()
    fres = a.search(X[7], 3, 64, filter=lambda i: i % 2 == 1)
    assert fres and all(r.d_id % 2 == 1 for r in fres)


def test_hnsw_engine_end_to_end(rng):
    X, pairs = _pairs(rng, 500, 16)
    a = T.AutoIndex(dist="L2", engine="hnsw", max_nb_connection=12, ef_construction=100,
                    device="cpu")
    a.parallel_insert(pairs)
    assert a.engine_name == "hnsw" and isinstance(a.engine, T.Hnsw)
    assert a.engine.device.type == "cpu" and a.engine.max_nb_connection == 12
    assert a.search(X[3], 3, 48)[0].d_id == 3
    fres = a.search_filter(X[3], 3, 64, filter=sorted(range(0, 500, 5)))
    assert fres and all(r.d_id % 5 == 0 for r in fres)
    rows = a.parallel_search(X[:6], 2, 48, mode="device")
    assert [r[0].d_id for r in rows] == list(range(6))


def test_ivf_engine_end_to_end(rng):
    """A clustered corpus through the IVF engine: the facade delegates."""
    a = T.AutoIndex(engine="ivf", device="cpu")
    X = _clustered(rng, 900, d=32)
    a.parallel_insert([(X[i], i) for i in range(len(X))])
    assert a.engine_name == "ivf" and a.engine.device.type == "cpu"
    res = a.parallel_search(X[:4], 3)
    assert len(res) == 4 and res[0][0].d_id == 0
    ids, _ = a.search_batch(X[:8], 1)
    assert (ids[:, 0] == np.arange(8)).mean() >= 0.9  # near-duplicates may tie


def test_insert_after_build(rng):
    X, pairs = _pairs(rng, 100, 8)
    a = T.AutoIndex(dist="L2", device="cpu")
    a.parallel_insert(pairs)
    a.build()
    a.insert(X[0] + 100.0, 1000)  # post-build inserts go to the engine
    assert len(a) == 101
    assert a.search(X[0] + 100.0, 1, 16)[0].d_id == 1000


def test_annt_facade(rng):
    """parallel_search on both engines, file_dump on the graph engine (read
    back by either package), a clear error on the scan."""
    X, pairs = _pairs(rng, 200, 12)
    a = T.AutoIndex(dist="L2", device="cpu")  # small corpus -> scan
    a.parallel_insert(pairs)
    assert isinstance(a, T.AnnT)
    rows = a.parallel_search(X[:5], 3, 16)
    assert len(rows) == 5 and rows[0][0].d_id == 0
    with pytest.raises(ValueError, match="hnsw engine"):
        a.file_dump(tempfile.gettempdir(), "nope")
    g = T.AutoIndex(dist="L2", engine="hnsw", max_nb_connection=8, ef_construction=48,
                    device="cpu")
    g.parallel_insert(pairs)
    assert g.parallel_search(X[:5], 3, 32)[0][0].d_id == 0
    with tempfile.TemporaryDirectory() as td:
        base = g.file_dump(td, "autodump")
        assert T.HnswIo(td, base).load_hnsw(device="cpu").get_nb_point() == 200
        assert J.HnswIo(td, base).load_hnsw().get_nb_point() == 200
