"""Batched search of the PyTorch port against the JAX package on one graph
(~3000 x 32): the port builds it, and both packages search the same tables
(the state crosses as numpy arrays)."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from hnsw_tpu.models.hnsw import Hnsw as JHnsw, _LayerTable as JLayerTable
from hnsw_tpu.ops.beam_search import device_search_batch as j_search
from hnsw_tpu_torch import Hnsw, get_metric, to_arrays
from hnsw_tpu_torch.ops.beam_search import device_search_batch as t_search

N, D, K = 3000, 32, 10


def jax_from_state(state, h):
    """A JAX-package Hnsw holding the same graph as the port's ``h``."""
    n = int(state["_nb_point"])
    j = JHnsw(max_nb_connection=h.max_nb_connection, max_elements=n,
              ef_construction=h.ef_construction, dist=h.metric.name,
              level_scale=h.get_level_scale())
    j._set_dim(state["_data"].shape[1])
    for k in ("_data", "_origin", "_level", "_rank_in_layer"):
        getattr(j, k)[:n] = state[k]
    j._layer_npoints[:] = state["_layer_npoints"]
    for l in sorted(int(k[5:-4]) for k in state if k.endswith("_ids")):
        ids = state[f"layer{l}_ids"]
        t = JLayerTable(j._cap, ids.shape[1])
        t.ids[:n], t.dists[:n] = ids, state[f"layer{l}_dists"]
        t.counts[:n] = state[f"layer{l}_counts"]
        j._layers[l] = t
    j._entry, j._nb_point = int(state["_entry"]), n
    j.level_sampler._rng.bit_generator.state = json.loads(str(state["sampler_state"]))
    j._version += 1
    return j


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0x5EA6C)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Q = rng.standard_normal((48, D)).astype(np.float32)
    ht = Hnsw(max_nb_connection=8, max_elements=N, ef_construction=48, dist="L2",
              device="cpu")
    ht.parallel_insert(X, mode="device", batch_size=256)
    hj = jax_from_state(to_arrays(ht), ht)
    assert hj.check_graph_equality(ht)
    return ht, hj, X, Q


def _assert_set_equal(ids_t, d_t, ids_j, d_j):
    for b in range(len(ids_t)):
        assert set(ids_t[b].tolist()) == set(ids_j[b].tolist()), b
    # both rerank/score the same ids in f32; summation order only
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"filter": list(range(0, N, 3))},
                                {"pool": 64, "knbn": 20, "ef": 24}],
                         ids=["plain", "filtered", "pool"])
def test_exact_traversal_set_equal(pair, kw):
    """Without a codec the two searches return the same id sets (tie order of
    lax.sort and torch.sort may differ) and the same distances."""
    ht, hj, X, Q = pair
    ht.set_traversal_codec(None)
    hj.set_traversal_codec(None)
    kw = dict(kw)
    knbn, ef = kw.pop("knbn", K), kw.pop("ef", 48)
    ids_t, d_t = t_search(ht, Q, knbn, ef, **kw)
    ids_j, d_j = j_search(hj, Q, knbn, ef, **kw)
    _assert_set_equal(ids_t, d_t, np.array(ids_j), np.array(d_j))
    if "filter" in kw:
        assert (ht._origin[ids_t[ids_t >= 0]] % 3 == 0).all()


def _recall(h, ids, X, Q):
    truth = get_metric("L2").brute_force(Q, X)
    hits = 0
    for b in range(len(Q)):
        kth = np.sort(truth[b])[K - 1]
        got = h._origin[ids[b][ids[b] >= 0]]
        hits += int((truth[b][got] <= kth + 1e-6).sum())
    return hits / (len(Q) * K)


def test_int8_codec_recall_close(pair):
    """With the i8 codec the port scores an f32 query against dequantized
    blocks (the kernel's arithmetic) where the JAX CPU path takes an
    int8 x int8 dot: traversal may differ, recall may not by more than 0.01."""
    ht, hj, X, Q = pair
    ht.set_traversal_codec("i8")
    hj.set_traversal_codec("i8")
    try:
        r_t = _recall(ht, t_search(ht, Q, K, 48)[0], X, Q)
        r_j = _recall(hj, np.array(j_search(hj, Q, K, 48)[0]), X, Q)
    finally:
        ht.set_traversal_codec(None)
        hj.set_traversal_codec(None)
    assert abs(r_t - r_j) <= 0.01, (r_t, r_j)
    assert r_t >= 0.8, r_t


def test_allow_fused_false_recall_close(pair):
    """``allow_fused=False`` (torch gather + the gathered-blocks scores, with
    ``blocks_sq`` as stored) against ``allow_fused=True`` (fused gather +
    score, |c|^2 recomputed): the scores differ in low bits only, so recall
    stays within 0.01 of the fused route's and of the JAX search's. The
    unfused route launches no fused scoring and takes its ids from the table."""
    from hnsw_tpu_torch.ops import beam_search as tbs
    ht, hj, X, Q = pair
    ht.set_traversal_codec("i8")
    hj.set_traversal_codec("i8")
    calls = {"fused": 0, "gathered": 0}
    fused, gathered = tbs.codec_scores, tbs.codec_scores_gathered

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    tbs.codec_scores = count("fused", fused)
    tbs.codec_scores_gathered = count("gathered", gathered)
    try:
        ids_f, d_f = t_search(ht, Q, K, 48, allow_fused=True)
        assert calls["fused"] > 0 and calls["gathered"] == 0
        calls["fused"] = 0
        ids_u, d_u = t_search(ht, Q, K, 48, allow_fused=False)
        assert calls["gathered"] > 0 and calls["fused"] == 0
        r_j = _recall(hj, np.array(j_search(hj, Q, K, 48)[0]), X, Q)
    finally:
        tbs.codec_scores, tbs.codec_scores_gathered = fused, gathered
        ht.set_traversal_codec(None)
        hj.set_traversal_codec(None)
    r_f, r_u = _recall(ht, ids_f, X, Q), _recall(ht, ids_u, X, Q)
    assert abs(r_u - r_f) <= 0.01 and abs(r_u - r_j) <= 0.01, (r_u, r_f, r_j)
    assert r_u >= 0.8, r_u
    # both routes end in the same exact f32 rerank: shared ids carry equal distances
    for b in range(len(Q)):
        both = np.intersect1d(ids_f[b], ids_u[b])
        assert len(both) >= K - 2
        np.testing.assert_array_equal(d_f[b][np.isin(ids_f[b], both)],
                                      d_u[b][np.isin(ids_u[b], both)])


@pytest.mark.parametrize("call", ["parallel_insert", "parallel_search"])
def test_device_mode_without_batched_metric_raises(call):
    """A metric with no batched form (NoDist) serves ``mode="auto"`` and
    ``"serial"`` from the host; an explicit ``mode="device"`` raises instead
    of giving the caller the host path unasked."""
    rng = np.random.default_rng(5)
    V = rng.random((6, 4)).astype(np.float32)
    h = Hnsw(max_nb_connection=4, max_elements=16, ef_construction=8, dist="NoDist",
             device="cpu")
    h.parallel_insert(V, mode="auto")
    assert h.get_nb_point() == 6
    with pytest.raises(ValueError, match="no batched form"):
        if call == "parallel_insert":
            h.parallel_insert(V, mode="device")
        else:
            h.parallel_search(V, 2, 8, mode="device")
    assert h.get_nb_point() == 6
    assert len(h.parallel_search(V, 2, 8, mode="auto")) == 6
