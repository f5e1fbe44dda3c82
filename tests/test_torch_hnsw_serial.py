"""The port's serial core, the twin of ``tests/test_hnsw_serial.py``: the
recall harness, self-retrieval, the sparse-search regression, iteration and
point ids, the insert forms and checks, from the same seeds; where a graph is
searched, the JAX package searches the same graph (carried across with
``to_arrays``) and answers the same ids."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import hnsw_tpu as J
from hnsw_tpu_torch import Hnsw, PointIdWithOrder, get_metric, l2_normalize, to_arrays
from test_torch_build import jax_from_state


def brute_force_knn(metric, X, q, k):
    d = metric.brute_force(q, X)[0]
    order = np.argsort(d, kind="stable")[:k]
    return order, d[order]


def mean_recall(hnsw, X, queries, k, ef, metric):
    """Distance-based recall as in reference ``tests/serpar.rs:168-197``:
    fraction of returned distances <= the k-th true distance."""
    hits = total = 0
    for q in queries:
        truth_idx, truth_d = brute_force_knn(metric, X, q, k)
        res = hnsw.search(q, k, ef)
        kth = truth_d[min(k, len(truth_d)) - 1]
        hits += sum(1 for r in res if r.distance <= kth + 1e-6)
        total += k
    return hits / total


def _same_answers(h, queries, k, ef, search="search"):
    """The JAX package's index holding ``h``'s graph answers every query
    with the same ids, in the same order."""
    jh = jax_from_state(to_arrays(h), h)
    for q in queries:
        a = [r.d_id for r in getattr(h, search)(q, k, ef)]
        b = [r.d_id for r in getattr(jh, search)(q, k, ef)]
        assert a == b


def test_serial_recall_l1(rng):
    """Analog of reference test_serial (1k x 10d, DistL1, extend+keep_pruned on)."""
    n, d, k = 1000, 10, 10
    X = rng.random((n, d)).astype(np.float32)
    hnsw = Hnsw(max_nb_connection=24, max_elements=n, max_layer=16,
                ef_construction=400, dist="L1", device="cpu")
    hnsw.set_extend_candidates(True)
    hnsw.set_keeping_pruned(True)
    for i, v in enumerate(X):
        hnsw.insert(v, i)
    assert hnsw.get_nb_point() == n
    queries = rng.random((30, d)).astype(np.float32)
    rec = mean_recall(hnsw, X, queries, k, ef=48, metric=get_metric("L1"))
    assert rec >= 0.9, f"serial recall too low: {rec}"
    _same_answers(hnsw, queries, k, 48)


def test_serial_recall_dot_normalized(rng):
    """Analog of reference test_parallel data config (25d normalized, DistDot)."""
    n, d, k = 800, 25, 10
    X = l2_normalize(rng.standard_normal((n, d)).astype(np.float32))
    hnsw = Hnsw(max_nb_connection=24, max_elements=n, ef_construction=200, dist="Dot",
                device="cpu")
    for i, v in enumerate(X):
        hnsw.insert(v, i)
    queries = l2_normalize(rng.standard_normal((20, d)).astype(np.float32))
    rec = mean_recall(hnsw, X, queries, k, ef=64, metric=get_metric("Dot"))
    assert rec >= 0.9, f"dot recall too low: {rec}"
    _same_answers(hnsw, queries, k, 64)


def test_self_retrieval(rng):
    """Every inserted point finds itself (analog of reference tests/equality.rs),
    as in the JAX package on the same graph."""
    n, d = 500, 10
    X = rng.random((n, d)).astype(np.float32)
    hnsw = Hnsw(max_nb_connection=16, max_elements=n, ef_construction=200, dist="L2",
                device="cpu")
    hnsw.modify_level_scale(0.5)
    for i, v in enumerate(X):
        hnsw.insert(v, i)
    missed = 0
    for i in range(n):
        res = hnsw.search(X[i], 1, 16)
        if not res or res[0].d_id != i:
            missed += 1
    assert missed <= n * 0.01, f"{missed}/{n} self-retrievals missed"
    _same_answers(hnsw, X[::25], 1, 16)


def test_sparse_search_single_point(rng):
    """Regression: a 1-point index whose point lives in a layer >= 1 must
    still be found (reference test_sparse_search, lowest-non-empty-layer logic
    ``src/hnsw.rs:1534-1540``); the JAX package draws the same level."""
    for trial in range(50):
        hnsw = Hnsw(max_nb_connection=8, max_elements=4, ef_construction=16,
                    dist="L2", seed=trial, device="cpu")
        jh = J.Hnsw(max_nb_connection=8, max_elements=4, ef_construction=16,
                    dist="L2", seed=trial)
        v = rng.random(6).astype(np.float32)
        hnsw.insert(v, 42)
        jh.insert(v, 42)
        res = hnsw.search(v + 0.01, 1, 4)
        assert len(res) == 1 and res[0].d_id == 42
        assert hnsw.get_max_level_observed() == jh.get_max_level_observed()


def test_iteration_and_layers(rng):
    n = 200
    X = rng.random((n, 8)).astype(np.float32)
    hnsw = Hnsw(max_nb_connection=8, max_elements=n, ef_construction=50, dist="L2",
                device="cpu")
    for i, v in enumerate(X):
        hnsw.insert(v, i)
    seen = {oid for oid, _ in hnsw.iter_points()}
    assert seen == set(range(n))
    per_layer = sum(hnsw.get_layer_nb_point(l) for l in range(16))
    assert per_layer == n
    # iter_layer partitions points
    total = sum(len(list(hnsw.iter_layer(l))) for l in range(16))
    assert total == n
    assert hnsw.get_max_level_observed() == int(np.max(hnsw._level[:n]))
    jh = jax_from_state(to_arrays(hnsw), hnsw)
    for l in range(16):
        assert ([oid for oid, _ in hnsw.iter_layer(l)]
                == [oid for oid, _ in jh.iter_layer(l)]), l


def test_get_point_data_and_ordered_id(rng):
    """get_point_data resolves (layer, rank) PointIds back to vectors
    (reference src/hnsw.rs:587-598) and rejects incoherent ids;
    PointIdWithOrder orders by distance only (src/hnsw.rs:59-92)."""
    n = 64
    X = rng.random((n, 8)).astype(np.float32)
    hnsw = Hnsw(max_nb_connection=8, max_elements=n, ef_construction=40, dist="L2",
                device="cpu")
    for i, v in enumerate(X):
        hnsw.insert(v, i)
    jh = jax_from_state(to_arrays(hnsw), hnsw)
    for idx in (0, 3, n - 1):
        pid = hnsw.get_point_id(idx)
        assert tuple(pid) == tuple(jh.get_point_id(idx))
        np.testing.assert_array_equal(hnsw.get_point_data(pid), X[idx])
    assert hnsw.get_point_data((0, -1)) is None
    assert hnsw.get_point_data((hnsw.get_max_level_observed() + 1, 0)) is None
    assert hnsw.get_point_data((0, hnsw.get_layer_nb_point(0))) is None

    a = PointIdWithOrder((0, 1), 0.5)
    b = PointIdWithOrder((3, 7), 0.5)
    c = PointIdWithOrder((0, 0), 1.5)
    assert a == b and a < c and sorted([c, a])[0] is a


def test_insert_tuple_style(rng):
    hnsw = Hnsw(max_nb_connection=8, max_elements=8, ef_construction=20, device="cpu")
    hnsw.insert((np.ones(4, np.float32), 7))
    assert hnsw.get_nb_point() == 1
    res = hnsw.search(np.ones(4, np.float32), 1, 4)
    assert res[0].d_id == 7 and res[0].distance == pytest.approx(0.0, abs=1e-6)


def test_duplicate_and_dim_checks(rng):
    hnsw = Hnsw(max_nb_connection=8, max_elements=8, device="cpu")
    hnsw.insert(np.ones(4, np.float32), 0)
    with pytest.raises(ValueError):
        hnsw.insert(np.ones(5, np.float32), 1)
    with pytest.raises(ValueError):
        Hnsw(max_nb_connection=300, device="cpu")
    with pytest.raises(ValueError):
        Hnsw(max_layer=17, device="cpu")


def test_search_general_matches_production(rng):
    n, d = 300, 10
    X = rng.random((n, d)).astype(np.float32)
    h = Hnsw(max_nb_connection=12, max_elements=n, ef_construction=100, dist="L2",
             device="cpu")
    for i, v in enumerate(X):
        h.insert(v, i)
    Q = rng.random((5, d)).astype(np.float32)
    for q in Q:
        a = {r.d_id for r in h.search(q, 5, 48)}
        b = {r.d_id for r in h.search_general(q, 5, 48)}
        assert len(a & b) >= 4  # two legitimate search paths, near-identical results
    _same_answers(h, Q, 5, 48, search="search_general")
