"""Every metric of the port (``hnsw_tpu_torch/ops/distances.py``) and
``UserMetric`` against the JAX package on the same inputs, on the CPU: the
numpy oracles equal, the torch score forms within f32 summation order (rtol
1e-5; Hamming and Levenshtein exact), the generic branches of the gathered
scores, the pivot matmul and the exact engine, the diversity prune of the
device build for metrics without an inner-product form, user metrics through
the device build and search, and a Hamming index dumped byte for byte by both
packages."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp

import hnsw_tpu as J
import hnsw_tpu_torch as T
import hnsw_tpu.ops.distances as JD
import hnsw_tpu.ops.insert_rounds as JI
import hnsw_tpu_torch.ops.distances as TD
import hnsw_tpu_torch.ops.insert_rounds as TI
from hnsw_tpu.ops.beam_search import scores_gathered as j_gathered
from hnsw_tpu_torch.ops.beam_search import scores_gathered as t_gathered
from hnsw_tpu_torch.ops.beam_search import scores_matmul as t_matmul

NAMES = ["L1", "L2", "Cosine", "Dot", "Hamming", "Jaccard", "Hellinger", "Jeffreys",
         "JensenShannon", "Levenshtein", "NoDist"]
SCORED = NAMES[:-1]
EXACT = ("Hamming", "Levenshtein")


def _inputs(name, rng, B=5, K=9, d=24):
    """Integer symbols for the string and code metrics (with zero padding),
    nonnegative floats for the others (the probability metrics need them)."""
    if name in EXACT:
        q = rng.integers(0, 5, (B, d)).astype(np.float32)
        C = rng.integers(0, 5, (B, K, d)).astype(np.float32)
        q[0] = 0  # empty query after zero-stripping
        C[1, 3] = 0  # empty candidate
    else:
        q = np.abs(rng.standard_normal((B, d))).astype(np.float32)
        C = np.abs(rng.standard_normal((B, K, d))).astype(np.float32)
        q[0, :3] = 0.0  # zeros exercise the 0 log 0 and clamp branches
        C[1, 2, :5] = 0.0
    return q, C


@pytest.mark.parametrize("name", NAMES)
def test_np_batch_matches_reference(rng, name):
    q, C = _inputs(name, rng)
    X = C[0]
    np.testing.assert_array_equal(TD.get_metric(name).np_batch(q, X),
                                  JD.get_metric(name).np_batch(q, X))
    np.testing.assert_array_equal(TD.get_metric(name).np_batch(q[1], X),
                                  JD.get_metric(name).np_batch(q[1], X))


@pytest.mark.parametrize("name", ["L2", "Hamming", "Jeffreys", "Levenshtein", "user"])
def test_pairs_equal_the_batch_diagonal(rng, name):
    """``Metric.pairs`` (the repair's pair distances) gives the diagonal of
    the JAX package's oracle block, whether it loops over pairs or not."""
    q, C = _inputs("Hamming" if name == "user" else name, rng, d=16)
    A, B = q, C[:, 0]
    m = _metric() if name == "user" else TD.get_metric(name)
    ref = JD.UserMetric(_pair) if name == "user" else JD.get_metric(name)
    assert m.pair_loop == (name in ("Levenshtein", "user"))
    np.testing.assert_array_equal(m.pairs(A, B), np.diagonal(ref.np_batch(A, B)))


@pytest.mark.parametrize("name", SCORED)
def test_scores_match_reference(rng, name):
    q, C = _inputs(name, rng)
    got = TD.get_metric(name).scores(torch.from_numpy(q), torch.from_numpy(C)).numpy()
    want = np.asarray(JD.get_metric(name).jnp_scores(jnp.asarray(q), jnp.asarray(C)))
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # and the fp64 oracle, as the JAX package's own test holds jnp_scores
    for b in range(len(q)):
        np.testing.assert_allclose(got[b], TD.get_metric(name).brute_force(q[b], C[b])[0],
                                   rtol=2e-4, atol=2e-5)


def test_levenshtein_scores_match_host_dp(rng):
    """The batched Levenshtein equals the host dynamic program on padded u16
    strings, empty-after-stripping rows and unequal lengths included."""
    B, K, d = 6, 9, 14
    q = rng.integers(0, 5, (B, d)).astype(np.uint16)
    C = rng.integers(0, 5, (B, K, d)).astype(np.uint16)
    q[0] = 0
    C[1, 3] = 0
    q[2, 7:] = 0
    C[3, :, 4:] = 0
    got = TD.scores_levenshtein(torch.from_numpy(q.astype(np.float32)),
                                torch.from_numpy(C.astype(np.float32))).numpy()
    want = np.array([[JD.np_levenshtein_pair(q[b], C[b, k]) for k in range(K)]
                     for b in range(B)])
    np.testing.assert_array_equal(got, want)
    assert TD.get_metric("Levenshtein").pair(q[2], q[2]) == 0.0


@pytest.mark.parametrize("name", ["L2", "Dot", "Cosine", "L1", "Hamming", "Jaccard",
                                  "Levenshtein"])
def test_gathered_scores_match_reference(rng, name):
    q, C = _inputs(name, rng)
    got = t_gathered(name, torch.from_numpy(q), torch.from_numpy(C)).numpy()
    want = np.asarray(j_gathered(name, jnp.asarray(q), jnp.asarray(C)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gathered_scores_without_batched_form_raise(rng):
    q, C = _inputs("L2", rng)
    with pytest.raises(NotImplementedError, match="no batched form"):
        t_gathered("NoDist", torch.from_numpy(q), torch.from_numpy(C))


@pytest.mark.parametrize("dist,d", [("L1", 16), ("Hamming", 32), ("Levenshtein", 10)])
def test_select_neighbours_matches_reference(rng, dist, d):
    """The diversity prune of a device round for metrics without an
    inner-product form (the generic pairwise branch): the port and the JAX
    package keep the same links from the same candidate arrays."""
    n, B, Cn, nb = 400, 6, 40, 8
    if dist == "L1":
        V = rng.integers(0, 9, (n, d)).astype(np.float32)  # integer sums: exact
    else:
        V = rng.integers(0, 4 if dist == "Hamming" else 6, (n, d)).astype(np.float32)
    V[-1] = 0.0  # sink row
    sq = (V * V).sum(-1)
    m = TD.get_metric(dist)
    cand = np.stack([rng.choice(n - 1, Cn, replace=False) for _ in range(B)]).astype(np.int32)
    q = V[rng.choice(n - 1, B, replace=False)]
    cd = np.stack([m.np_batch(q[b], V[cand[b]]) for b in range(B)]).astype(np.float32)
    o = np.argsort(cd, axis=1, kind="stable")
    cand, cd = np.take_along_axis(cand, o, 1), np.take_along_axis(cd, o, 1)
    cand[0, -5:] = -1  # padded candidate slots
    cd[0, -5:] = np.inf
    for keep_pruned in (False, True):
        ti, td = TI.select_neighbours_batched(dist, torch.from_numpy(V), torch.from_numpy(sq),
                                              torch.from_numpy(cand), torch.from_numpy(cd),
                                              nb, keep_pruned)
        ji, jd = JI.select_neighbours_batched(dist, jnp.asarray(V), jnp.asarray(sq),
                                              jnp.asarray(cand), jnp.asarray(cd), nb,
                                              keep_pruned)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_pairwise_blocks_do_not_change_the_answer(rng, monkeypatch):
    """The generic pairwise form scores whole rows per block: any block size
    gives the same [B, K, K] distances."""
    V = torch.from_numpy(rng.integers(0, 4, (3, 7, 12)).astype(np.float32))
    sq = (V * V).sum(-1)
    full = TI._pairwise_dists("Hamming", V, sq)
    monkeypatch.setattr(TI, "_PAIRWISE_ELEMS", 5 * 7 * 12)  # 5 rows a block
    np.testing.assert_array_equal(TI._pairwise_dists("Hamming", V, sq).numpy(), full.numpy())
    want = np.stack([JD.np_hamming(V[b].numpy(), V[b].numpy()) for b in range(3)])
    np.testing.assert_allclose(full.numpy(), want, rtol=1e-7)


def _self_recall(h, X, k=5):
    ids, _ = h.search_batch(X[:64], k, 64)
    return float(np.mean(np.asarray(h._origin)[ids[:, 0]] == np.arange(64)))


def test_l1_device_build_matches_reference():
    """The repair: a device build under L1 (no inner-product form) prunes
    through the generic pairwise branch. The port builds 2000 x 16 and finds
    each point itself, as the JAX package's build of the same data does, and
    both answer the exact top-5 at the same recall."""
    rng = np.random.default_rng(3)
    n = 2000
    X = rng.integers(0, 16, (n, 16)).astype(np.float32)
    X += rng.random((n, 16)).astype(np.float32) * 0.01  # no exact ties
    Q = X[:64] + rng.random((64, 16)).astype(np.float32) * 0.5
    truth = JD.np_l1(Q, X)
    recalls = []
    for h in (T.Hnsw(max_nb_connection=12, max_elements=n, ef_construction=64,
                     dist="L1", device="cpu"),
              J.Hnsw(max_nb_connection=12, max_elements=n, ef_construction=64, dist="L1")):
        h.parallel_insert((X, np.arange(n)), mode="device", batch_size=512)
        assert h.get_nb_point() == n
        assert _self_recall(h, X) >= 0.98
        ids, _ = h.search_batch(Q, 5, 64)
        got = np.asarray(h._origin)[ids]
        recalls.append(np.mean([len(set(got[b]) & set(np.argsort(truth[b])[:5])) / 5
                                for b in range(len(Q))]))
    assert recalls[0] >= 0.95 and abs(recalls[0] - recalls[1]) <= 0.03, recalls


@pytest.mark.parametrize("dist", ["Hamming", "Jaccard"])
def test_exact_engine_gathered_fallback_matches_reference(rng, dist):
    """``BruteForceIndex`` on a metric without a matmul form scores the
    broadcast corpus (in query chunks here): same ids, tie order included,
    as the JAX package's."""
    X = rng.integers(0, 3, (300, 12)).astype(np.float32)
    if dist == "Jaccard":
        X += rng.random(X.shape).astype(np.float32)
    Q = X[:20] + (rng.random((20, 12)) < 0.2)
    bt, bj = T.BruteForceIndex(dist=dist, device="cpu"), J.BruteForceIndex(dist=dist)
    pairs = list(zip(X, range(len(X))))
    bt.parallel_insert(pairs)
    bj.parallel_insert(pairs)
    import hnsw_tpu_torch.models.brute as TB
    ti, td = bt.search_batch(Q, 7)
    ji, jd = bj.search_batch(Q, 7)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5)
    old = TB._BROADCAST_ELEMS
    try:
        TB._BROADCAST_ELEMS = 3 * 300 * 12  # three queries a chunk
        np.testing.assert_array_equal(bt.search_batch(Q, 7)[0], ti)
    finally:
        TB._BROADCAST_ELEMS = old


# ------------------------------------------------------------- user metrics ---

_D = 16
_W = (1.0 + np.arange(_D, dtype=np.float32) / _D)


def _pair(a, b):
    diff = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float((_W * diff * diff).sum())


def _scores(q, C):
    w = torch.as_tensor(_W, device=q.device)
    diff = q[:, None, :].float() - C.float()
    return (w * diff * diff).sum(-1)


def _matmul(q, X, x_sqnorms=None):
    w = torch.as_tensor(_W, device=q.device)
    qf, Xf = q.float(), X.float()
    g = qf @ (w * Xf).T
    return torch.clamp_min((w * qf * qf).sum(-1)[:, None] - 2.0 * g
                           + (w * Xf * Xf).sum(-1)[None, :], 0.0)


def _jnp_scores(q, C):
    w = jnp.asarray(_W)
    diff = q[:, None, :].astype(jnp.float32) - C.astype(jnp.float32)
    return (w * diff * diff).sum(-1)


def _metric():
    return T.UserMetric(_pair, name="WeightedL2TorchTest", scores=_scores,
                        matmul_scores=_matmul)


def test_user_metric_forms_match_reference(rng):
    m = _metric()
    jm = J.UserMetric(_pair, name="WeightedL2TorchTestJ", jnp_scores=_jnp_scores)
    q = rng.random((4, _D)).astype(np.float32)
    C = rng.random((4, 7, _D)).astype(np.float32)
    np.testing.assert_allclose(m.scores(torch.from_numpy(q), torch.from_numpy(C)).numpy(),
                               np.asarray(jm.jnp_scores(jnp.asarray(q), jnp.asarray(C))),
                               rtol=1e-5)
    np.testing.assert_array_equal(m.np_batch(q, C[0]), jm.np_batch(q, C[0]))
    # the pivot matmul resolves the registered name to the user's form
    np.testing.assert_allclose(
        t_matmul("WeightedL2TorchTest", torch.from_numpy(q), torch.from_numpy(C[0]), None).numpy(),
        m.np_batch(q, C[0]), rtol=1e-4, atol=1e-5)
    assert TD.get_metric("WeightedL2TorchTest") is m


def test_user_metric_device_build_and_search(rng):
    """Device build and search with a UserMetric carrying torch forms agree
    with an fp64 brute-force oracle of the same metric."""
    n = 3000
    X = rng.random((n, _D)).astype(np.float32)
    h = T.Hnsw(max_nb_connection=12, max_elements=n, ef_construction=64, dist=_metric(),
               device="cpu")
    h.parallel_insert((X, np.arange(n)), mode="device", batch_size=512)
    assert h.get_nb_point() == n
    Q = rng.random((16, _D)).astype(np.float32)
    ids, dists = h.search_batch(Q, knbn=5, ef=64)
    truth = np.array([[_pair(q, x) for x in X] for q in Q])
    hits = 0
    for b in range(len(Q)):
        kth = np.sort(truth[b])[4]
        for j in range(5):
            i = int(ids[b, j])
            assert i >= 0
            hits += _pair(Q[b], X[h.get_origin_id(i)]) <= kth * (1 + 1e-6) + 1e-12
    assert hits / (len(Q) * 5) >= 0.9
    i0 = int(ids[0, 0])  # device distances are the user metric's
    assert dists[0, 0] == pytest.approx(_pair(Q[0], X[h.get_origin_id(i0)]), rel=1e-4)


def test_user_metric_pivots_use_its_matmul(rng, monkeypatch):
    """A user metric's ``matmul_scores`` makes it a pivot-entry metric, as in
    the JAX package; the pivot set then serves the search."""
    import hnsw_tpu_torch.ops.graph_arrays as tga
    monkeypatch.setattr(tga, "PIVOT_MIN_POINTS", 1)
    n = 2500
    X = rng.random((n, _D)).astype(np.float32)
    h = T.Hnsw(max_nb_connection=8, max_elements=n, ef_construction=48, dist=_metric(),
               device="cpu")
    h.parallel_insert((X, np.arange(n)), mode="device", batch_size=512)
    assert h.device_graph().pivot_ids is not None
    assert _self_recall(h, X) >= 0.95
    bare = T.Hnsw(max_nb_connection=8, max_elements=n, dist=T.UserMetric(_pair, name="NoForms"),
                  device="cpu")
    assert tga.compute_pivots(bare, h._layers[0].ids[:n], n) is None


def test_user_metric_serial_matches_device(rng):
    n = 600
    X = rng.random((n, _D)).astype(np.float32)
    m = _metric()
    hd = T.Hnsw(max_nb_connection=8, max_elements=n, ef_construction=48, dist=m, device="cpu")
    hd.parallel_insert((X, np.arange(n)), mode="device", batch_size=256)
    hs = T.Hnsw(max_nb_connection=8, max_elements=n, ef_construction=48, dist=m, device="cpu")
    hs.parallel_insert([(X[i], i) for i in range(n)], mode="serial")
    Q = rng.random((8, _D)).astype(np.float32)
    res_d = hd.parallel_search(Q, 5, 64, mode="device")
    res_s = hs.parallel_search(Q, 5, 64, mode="serial")
    agree = sum(sorted(round(r.distance, 3) for r in rd) == sorted(round(r.distance, 3) for r in rs)
                for rd, rs in zip(res_d, res_s))
    assert agree >= 6, (agree, res_d[0], res_s[0])


def test_bare_callable_stays_serial(rng):
    """A bare pair function (no torch form) is a serial-path metric: "auto"
    keeps it on the host, an explicit "device" raises."""
    n = 300
    X = rng.random((n, _D)).astype(np.float32)
    h = T.Hnsw(max_nb_connection=8, max_elements=n, ef_construction=48, dist=_pair,
               device="cpu")
    assert h.metric.name == "DistPtr" and h.metric.scores is None
    with pytest.raises(ValueError, match="no batched form"):
        h.parallel_insert((X, np.arange(n)), mode="device")
    h.parallel_insert((X, np.arange(n)), mode="auto")
    res = h.parallel_search(X[:4], 1, 32)
    assert all(r[0].d_id == i for i, r in enumerate(res))


def test_user_metric_name_conflict_raises():
    _metric()  # re-registering the identical functions is fine
    _metric()
    with pytest.raises(ValueError, match="already registered"):
        T.UserMetric(_pair, name="WeightedL2TorchTest", scores=lambda q, C: _scores(q, C) * 2)
    with pytest.raises(ValueError, match="shadows a builtin"):
        T.UserMetric(_pair, name="L2", scores=_scores)
    assert "WeightedL2TorchTest" in TD._USER_METRICS


def test_user_metric_dump_reloads_with_dist(rng, tmp_path):
    """``load_hnsw_with_dist`` takes the UserMetric back: the dump names it
    (``anndists::dist::distances::Dist<name>``) and the reload serves it."""
    n = 200
    X = rng.random((n, _D)).astype(np.float32)
    m = _metric()
    h = T.Hnsw(max_nb_connection=8, max_elements=n, ef_construction=32, dist=m, device="cpu")
    for i, v in enumerate(X):
        h.insert(v, i)
    base = h.file_dump(tmp_path, "user")
    r = T.HnswIo(tmp_path, base).load_hnsw_with_dist(m, device="cpu")
    assert r.metric is m and h.check_graph_equality(r)
    assert T.load_description(tmp_path / (base + ".hnsw.graph")).distname.endswith(
        "DistWeightedL2TorchTest")
    with pytest.raises(ValueError, match="mismatch"):
        T.HnswIo(tmp_path, base).load_hnsw_with_dist("L2", device="cpu")


def test_hamming_uint8_dump_crosses_packages(tmp_path, monkeypatch):
    """A Hamming index of uint8 codes: both packages' serial builds dump the
    same bytes, and each package reloads the other's dump to the same graph."""
    monkeypatch.setenv("HNSW_TPU_NATIVE_IO", "0")
    rng = np.random.default_rng(11)
    X = rng.integers(0, 2, (250, 32)).astype(np.uint8)
    kw = dict(max_nb_connection=8, max_elements=250, ef_construction=48, dist="Hamming",
              dtype=np.uint8)
    ht, hj = T.Hnsw(device="cpu", **kw), J.Hnsw(**kw)
    for i, v in enumerate(X):
        ht.insert(v, i)
        hj.insert(v, i)
    bt = ht.file_dump(tmp_path, "port")
    bj = J.file_dump(hj, tmp_path, "ref")
    for ext in (".hnsw.graph", ".hnsw.data"):
        assert (tmp_path / (bt + ext)).read_bytes() == (tmp_path / (bj + ext)).read_bytes()
    rt = T.HnswIo(tmp_path, bj).load_hnsw(device="cpu")
    rj = J.HnswIo(tmp_path, bt).load_hnsw()
    assert rt.get_distance_name() == "Hamming" and rt._data.dtype == np.uint8
    assert rt.check_graph_equality(ht)
    assert rj.check_graph_equality(hj)
    ids, _ = rt.search_batch(X[:16], 1, 32)
    assert (rt._origin[ids[:, 0]] == np.arange(16)).mean() >= 0.9
