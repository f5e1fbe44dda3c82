"""The exact scan's refine against the JAX package's: the number of finalists
the port re-scores in f32 is the reference's (``k + overfetch`` rounded up to
a multiple of 32, at least 32), with and without a filter, and on a clustered
corpus the port's bf16 scan keeps the recall of the JAX package's interpreted
Pallas scan. Below the scan, the filtered exact search answers the exact
filtered top-k (the port fetches ``kf`` candidates before the filter on that
route too; the JAX package fetches ``k`` there)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp

from hnsw_tpu_torch.bench import f32_dataset, recall_fp64
from hnsw_tpu.ops.pallas_topk import _round_up, pad_corpus as j_pad, pallas_l2_topk, pick_tn
from hnsw_tpu_torch import BruteForceIndex, get_metric
from hnsw_tpu_torch.ops import scan_topk as st


def _reference_width(k, overfetch, n_cand):
    """``hnsw_tpu/ops/pallas_topk.py:246,308``."""
    return min(max(32, _round_up(k + overfetch, 32)), n_cand)


def _reference_kf(k, n, filtered):
    """``hnsw_tpu/models/brute.py``: the scan fetches kf candidates under a filter."""
    return k if not filtered else min(n, ((4 * k + 63) // 32) * 32)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_refine_width_is_the_references(k, filtered, monkeypatch):
    """The finalists ``BruteForceIndex``'s scan re-scores, seen at the
    ``torch.topk`` over the scan's candidates, against the reference's formula."""
    X, Q = f32_dataset("gauss", np.random.default_rng(3), 5000, 8, 16, 8)
    bf = BruteForceIndex(device="cpu")
    bf.SCAN_MIN_POINTS = 1
    bf.parallel_insert(X)
    Np = bf._scan_device()[0].shape[0]
    n_cand = -(-(Np // st.SCAN_TN) // st.scan_acc(Np)) * 2 * (st.SCAN_TN // st.SCAN_GROUP)
    widths, topk = [], torch.topk

    def spy(x, kk, *a, **kw):
        if x.shape[1] == n_cand:  # the scan's candidate buffer
            widths.append(kk)
        return topk(x, kk, *a, **kw)
    monkeypatch.setattr(torch, "topk", spy)
    ids, _ = bf.search_batch(Q, k, filter=(lambda i: i % 2 == 0) if filtered else None)
    kf = _reference_kf(k, len(X), filtered)
    assert widths == [_reference_width(kf, bf.SCAN_OVERFETCH, n_cand)], (widths, kf)
    for k_, of in ((1, 0), (10, 8), (24, 8), (25, 8), (100, 8), (100, 54)):
        assert st.refine_width(k_, of, n_cand) == _reference_width(k_, of, n_cand)
    assert st.refine_width(100, 8, 64) == 64


def test_clustered_recall_matches_reference():
    """bench.py's clustered corpus cut to 60k x 128 (seed 1234): the port's
    exact engine (its plain bf16 scan here) and the JAX package's Pallas scan,
    interpreted, at its own geometry, reach recall@10 within 0.002 of each
    other (at 18 finalists the port read 0.0039 below)."""
    nq, k = 256, 10
    X, Q = f32_dataset("clustered", np.random.default_rng(1234), 60_000, nq, 128, 16)
    X64, Q64 = X.astype(np.float64), Q.astype(np.float64)
    d2 = (X64 * X64).sum(1)[None, :] - 2.0 * Q64 @ X64.T + (Q64 * Q64).sum(1)[:, None]
    kth = np.sqrt(np.maximum(np.partition(d2, k - 1, axis=1)[:, k - 1], 0.0))
    bf = BruteForceIndex(device="cpu")
    bf.parallel_insert(X)
    assert bf._use_scan()
    r_port = recall_fp64(X, Q, kth, bf.search_batch(Q, k)[0], k)
    tn = pick_tn(128)
    Xp, xsq, perm = j_pad(X, tn=tn)
    acc = max(1, -(-(Xp.shape[0] // tn) // 8))
    Xd = jnp.asarray(Xp)
    _, ids = pallas_l2_topk(jnp.asarray(Q), Xd, jnp.asarray(xsq), k, tn=tn,
                            group=tn // 128, Xscan=Xd.astype(jnp.bfloat16),
                            overfetch=8, acc=acc, interpret=True)
    r_ref = recall_fp64(X, Q, kth, perm[np.clip(np.array(ids), 0, len(perm) - 1)], k)
    assert abs(r_port - r_ref) <= 0.002, (r_port, r_ref)
    assert r_port >= 0.99, r_port


@pytest.mark.parametrize("dist", ["L2", "L1", "Cosine"])
def test_filtered_exact_below_scan_is_exact(dist, rng):
    """Below ``SCAN_MIN_POINTS`` (and for metrics without the scan) a filtered
    search gives the exact filtered top-k in f32, full rows where the filter
    leaves enough points; the JAX package's matmul route fetches k and
    leaves rows short."""
    from hnsw_tpu import BruteForceIndex as JBruteForceIndex
    n, k = 3000, 10
    X = rng.standard_normal((n, 24)).astype(np.float32)
    Q = rng.standard_normal((16, 24)).astype(np.float32)
    bf = BruteForceIndex(dist=dist, device="cpu")
    bf.parallel_insert(X)
    assert not bf._use_scan()
    keep = np.arange(0, n, 3)
    ids, d = bf.search_batch(Q, k, filter=keep.tolist())
    truth = get_metric(dist).brute_force(Q, X[keep])
    for b in range(len(Q)):
        order = np.argsort(truth[b], kind="stable")[:k]
        assert set(ids[b].tolist()) == set(keep[order].tolist()), b
        np.testing.assert_allclose(d[b], truth[b][order], rtol=1e-5, atol=1e-5)
    jb = JBruteForceIndex(dist=dist)
    jb.parallel_insert(list(zip(X, range(n))))
    j_ids, _ = jb.search_batch(Q, k, filter=keep.tolist())
    assert (j_ids >= 0).sum() < (ids >= 0).sum() == len(Q) * k
