"""IVF-Flat engine of the port (``hnsw_tpu_torch/models/ivf.py``) on the CPU,
against the exact oracle and the JAX package (``hnsw_tpu/models/ivf.py``):
the nprobe = C exactness identity, packing invariants, array ingest, filters,
``.npz`` snapshots read by either package, the f16 stream against the batch
path, Dot padding, the clusteredness statistic, and search parity on the
lists of a JAX-built index carried across with ``ivf_from_arrays``."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import hnsw_tpu as J
import hnsw_tpu_torch as T
from hnsw_tpu.models.ivf import clusteredness as j_clusteredness
from hnsw_tpu_torch.models.ivf import clusteredness


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0FFEE)


def _clustered(rng, n, d=32, C=12, spread=0.05):
    cent = rng.standard_normal((C, d)).astype(np.float32)
    a = rng.integers(0, C, n)
    X = cent[a] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return X.astype(np.float32)


def _recall(got, want):
    hits = sum(len(set(g) & set(w)) for g, w in zip(got, want))
    return hits / want.size


def _ivf(**kw):
    return T.IvfFlatIndex(device="cpu", **kw)


def test_ivf_exact_when_nprobe_is_C(rng):
    """Probing every list equals brute force: the packed layout and the
    refine lose nothing."""
    X = _clustered(rng, 600)
    Q = _clustered(rng, 16)
    ix = _ivf(n_clusters=8)
    ix.parallel_insert([(X[i], i) for i in range(len(X))])
    bf = T.BruteForceIndex(device="cpu")
    bf.parallel_insert([(X[i], i) for i in range(len(X))])
    gi, gd = ix.search_batch(Q, 5, nprobe=ix.n_lists)
    wi, wd = bf.search_batch(Q, 5)
    assert _recall(gi, wi) == 1.0
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)


def test_ivf_recall_on_clustered(rng):
    X = _clustered(rng, 4000, C=16)
    Q = _clustered(rng, 64, C=16)
    ix = _ivf(n_clusters=32, nprobe=4)
    ix.parallel_insert([(X[i], i) for i in range(len(X))])
    bf = T.BruteForceIndex(device="cpu")
    bf.parallel_insert([(X[i], i) for i in range(len(X))])
    gi, _ = ix.search_batch(Q, 10)
    wi, _ = bf.search_batch(Q, 10)
    assert _recall(gi, wi) >= 0.95


def test_ivf_packing_invariants(rng):
    """Every point lands in exactly one list; no list exceeds the cap; a huge
    cluster is split instead of exploding one slab."""
    X = np.concatenate([_clustered(rng, 1900, C=1), _clustered(rng, 100, C=6)])
    ix = _ivf(n_clusters=16)
    ix.parallel_insert([(X[i], i) for i in range(len(X))])
    ix.build()
    row2idx, cap = ix._built[5], ix._built[6]
    live = row2idx[row2idx >= 0]
    assert len(live) == len(X)
    assert len(np.unique(live)) == len(X)  # exactly once
    sizes = (row2idx.reshape(ix.n_lists, cap) >= 0).sum(1)
    assert sizes.max() <= cap
    xsq = ix._built[4].reshape(-1).numpy()
    assert np.isinf(xsq[row2idx < 0]).all() and np.isfinite(xsq[row2idx >= 0]).all()
    assert ix._built[2].dtype == torch.bfloat16 and ix._built[3].dtype == torch.float32


def test_ivf_array_ingest_and_ids(rng):
    X = _clustered(rng, 500)
    ids = np.arange(500, dtype=np.int64) + (1 << 40)
    ix = _ivf(n_clusters=8)
    ix.parallel_insert((X, ids))
    gi, _ = ix.search_batch(X[:8], 1, nprobe=8)
    assert (gi[:, 0] == ids[:8]).mean() >= 0.9  # near-duplicates may tie
    ix.insert(X[0] + 100.0, 7)  # a single insert invalidates the build
    assert ix._built is None and len(ix) == 501
    assert ix.search(X[0] + 100.0, 1)[0].d_id == 7


def test_ivf_filter(rng):
    X = _clustered(rng, 800)
    ix = _ivf(n_clusters=8, nprobe=8)
    ix.parallel_insert([(X[i], i) for i in range(len(X))])
    allow = set(range(0, 800, 3))
    ids, d = ix.search_batch(X[:16], 5, filter=sorted(allow))
    for b in range(16):
        got = [i for i in ids[b] if i >= 0]
        assert got and all(i in allow for i in got)
        fin = d[b][np.isfinite(d[b])]
        assert (np.diff(fin) >= -1e-6).all()
    rows = ix.parallel_search(X[:4], 3, filter=lambda i: i % 2 == 0)
    assert all(r.d_id % 2 == 0 for row in rows for r in row)


def test_ivf_snapshot_crosses_packages(rng, tmp_path):
    """``save_native`` writes the JAX package's ``kind="ivf-flat"`` ``.npz``:
    each package loads the other's and answers as the writer."""
    X = _clustered(rng, 700)
    t, j = _ivf(n_clusters=8, nprobe=3), J.IvfFlatIndex(n_clusters=8, nprobe=3)
    for ix in (t, j):
        ix.parallel_insert([(X[i], i) for i in range(len(X))])
    t.save_native(str(tmp_path / "port.npz"))
    j.save_native(str(tmp_path / "ref.npz"))
    t2 = T.IvfFlatIndex.load_native(str(tmp_path / "ref.npz"), device="cpu")
    j2 = J.IvfFlatIndex.load_native(str(tmp_path / "port.npz"))
    assert (t2.nprobe, t2.seed, t2.n_clusters) == (3, j.seed, 8)
    gi, gd = t.search_batch(X[:12], 5)
    np.testing.assert_array_equal(t2.search_batch(X[:12], 5)[0], gi)  # seeded k-means
    ji, jd = j.search_batch(X[:12], 5)
    np.testing.assert_array_equal(j2.search_batch(X[:12], 5)[0], ji)
    np.testing.assert_array_equal(gi, ji)
    # the queries are corpus rows: at distance 0 the norm-trick L2
    # (|q|^2 - 2 q.x + |x|^2, then sqrt) keeps sqrt(f32 cancellation), about
    # 1e-3 here, in another summation order on each side
    np.testing.assert_allclose(gd, jd, rtol=1e-5, atol=3e-3)
    bad = tmp_path / "bad.npz"
    np.savez(bad, kind="hnsw")
    with pytest.raises(ValueError, match="not an ivf-flat"):
        T.IvfFlatIndex.load_native(str(bad), device="cpu")


def test_ivf_search_stream_matches_batch(rng):
    """The pipelined stream returns the batch path's neighbours: exactly with
    f32 ingest, by recall with f16 ingest (rounded queries may flip ties)."""
    X = _clustered(rng, 1200, C=10)
    Q = _clustered(rng, 70, C=10)
    ix = _ivf(n_clusters=12, nprobe=4)
    ix.parallel_insert((X, np.arange(1200, dtype=np.int64)))
    si, sd = ix.search_batch(Q, 5)
    ti, _ = ix.search_stream(Q, 5, batch=32)  # ragged tail batch on purpose
    assert _recall(ti, si) >= 0.95
    f32i, f32d = ix.search_stream(Q, 5, batch=64, query_dtype=None)
    np.testing.assert_array_equal(f32i, si)
    np.testing.assert_array_equal(f32d, sd)
    q16 = Q.astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(ti, ix.search_batch(q16, 5)[0])


def test_ivf_dot_padding_never_outranks(rng):
    """Slab padding rows are zero vectors, which under Dot would score a
    finite 1.0 and out-rank negative-similarity candidates: they are masked
    for every metric."""
    d = 8
    q = np.zeros((4, d), np.float32)
    q[:, 0] = 1.0
    X = rng.standard_normal((20, d)).astype(np.float32)
    X[:, 0] = -np.abs(X[:, 0]) - 0.5
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    ix = _ivf(dist="Dot", n_clusters=3)
    ix.parallel_insert((X, np.arange(20)))
    gi, gd = ix.search_batch(q, 5, nprobe=ix.n_lists)
    assert (gi >= 0).all(), f"padding rows leaked into results: {gi}"
    assert np.isfinite(gd).all()
    bf = T.BruteForceIndex(dist="Dot", device="cpu")
    bf.parallel_insert([(X[i], i) for i in range(20)])
    wi, _ = bf.search_batch(q, 5)
    assert _recall(gi, wi) == 1.0


def test_ivf_rejects_other_metrics():
    with pytest.raises(ValueError, match="supports"):
        _ivf(dist="L1")


@pytest.mark.parametrize("kind", ["gauss", "clustered"])
def test_clusteredness_matches_reference(rng, kind):
    """The AutoIndex routing statistic equals the JAX package's within 1e-6,
    low on a gaussian, high on a mixture."""
    d = 64
    if kind == "gauss":
        A = rng.standard_normal((16, d)).astype(np.float32) / 4.0
        X = rng.standard_normal((4000, 16)).astype(np.float32) @ A
    else:
        X = _clustered(rng, 4000, d=d, C=12)
    got = clusteredness(X, sample=2000, device="cpu")
    assert abs(got - j_clusteredness(X, sample=2000)) <= 1e-6
    assert (got < T.AutoIndex.IVF_CLUSTEREDNESS) == (kind == "gauss"), got


@pytest.mark.parametrize("dist", ["L2", "Cosine", "Dot"])
def test_search_parity_on_carried_lists(rng, dist):
    """A JAX-built index's lists, carried across with ``ivf_to_arrays`` /
    ``ivf_from_arrays``, answer in the port as in the JAX package: ids equal
    on at least 99.9% of rows (the f32 sums of the two may order a near-tie
    differently), distances within 1e-5."""
    X = _clustered(rng, 3000, C=20, spread=0.2)
    Q = _clustered(rng, 1000, C=20, spread=0.2)
    j = J.IvfFlatIndex(dist=dist, n_clusters=24, nprobe=5)
    j.parallel_insert((X, np.arange(3000, dtype=np.int64) + 5))
    state = T.ivf_to_arrays(j)
    t = T.ivf_from_arrays(state, dist=dist, nprobe=5, device="cpu")
    ji, jd = j.search_batch(Q, 10)
    ti, td = t.search_batch(Q, 10)
    assert (ti == ji).all(1).mean() >= 0.999
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    # the port's own state round-trips through the same arrays
    back = T.ivf_to_arrays(t)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])
