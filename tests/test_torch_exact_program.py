"""The exact engine and the IVF search as captured programs
(``hnsw_tpu_torch/ops/program.py``: ``ScanProgram``, ``TopkProgram``,
``IvfProgram`` and the sharded exact scan's per-shard ``CallProgram``) on the
CPU, where their pieces run without capture: each answers bit for bit what
the direct call answers, and what the JAX package's jitted counterpart
answers on the same seeded inputs (``pallas_l2_topk`` interpreted,
``_bf_topk``, ``_ivf_route`` -> ``_ivf_probe`` -> ``_exact_refine``). Then,
with the stub graph of ``tests/test_torch_program.py`` forced under every
program, the capture count per key, the launches counted per replay, the
caches dropped when the data change, and the ragged tails."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp

import hnsw_tpu as J
import hnsw_tpu_torch as T
from hnsw_tpu.models.brute import _bf_topk as j_bf_topk
from hnsw_tpu.models.ivf import _exact_refine as j_refine
from hnsw_tpu.models.ivf import _ivf_probe as j_probe
from hnsw_tpu.models.ivf import _ivf_route as j_route
from hnsw_tpu.ops import pallas_topk as jtopk
from hnsw_tpu_torch.models.brute import _bf_topk
from hnsw_tpu_torch.models.ivf import ivf_search
from hnsw_tpu_torch.ops import kernel_lib, program
from hnsw_tpu_torch.ops import scan_topk as st
from hnsw_tpu_torch.parallel.sharded import (_merge_shard_topk, _sharded_scan_fn,
                                             _sharded_scan_pallas_fn)
from test_torch_program import StubGraph, stub_capture

N, D, B = 1700, 32, 16
TN, GROUP, ACC = 256, 8, 3  # 7 tiles of 256 rows: spans of 3 + 3 + 1


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0xE9)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Q = rng.standard_normal((B, D)).astype(np.float32)
    return X, Q


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def _sets_equal(ids_a, ids_b):
    for a, b in zip(ids_a, ids_b):
        assert set(a.tolist()) == set(b.tolist())


@pytest.mark.parametrize("refine", [True, False], ids=["refine", "raw"])
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_scan_program_equals_direct_and_jax(data, packed, k, refine):
    """``ScanProgram`` answers as ``l2_topk`` bit for bit (twice: the second
    run reuses the static input), and as ``pallas_l2_topk`` interpreted (id
    sets, distances within 1e-5; the packed scan's unrefined distances keep
    all but their low LB mantissa bits, so there within one such quantum,
    2^(LB-23) of d^2, the decode contract)."""
    X, Q = data
    Xp, xsq, _ = jtopk.pad_corpus(X, tn=TN)
    Xt, xt, qt = torch.from_numpy(Xp), torch.from_numpy(xsq), torch.from_numpy(Q)
    kw = dict(k=k, tn=TN, group=GROUP, acc=ACC, overfetch=8, refine=refine, packed=packed)
    prog = program.ScanProgram(Xt, xt, B, torch.float32, "cpu", **kw)
    direct = st.l2_topk(qt, Xt, xt, **kw)
    _equal(prog.run(qt), direct)
    _equal(prog.run(qt), direct)
    dj, ij = jtopk.pallas_l2_topk(jnp.asarray(Q), jnp.asarray(Xp), jnp.asarray(xsq), k,
                                  tn=TN, group=GROUP, acc=ACC, overfetch=8, refine=refine,
                                  packed=packed, interpret=True)
    _sets_equal(direct[1].numpy(), np.array(ij))
    LB = st._geometry(Xp.shape[0], TN, GROUP, ACC)[4]
    rtol = 2.0 ** (LB - 23) if packed and not refine else 0
    np.testing.assert_allclose(direct[0].numpy(), np.array(dj), rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("metric", ["L2", "Cosine", "L1", "Hellinger"])
def test_topk_program_equals_jax(data, metric):
    """``TopkProgram`` answers as the direct ``_bf_topk`` bit for bit and as
    the JAX package's jitted ``_bf_topk`` (ids equal, scores within 1e-5);
    Hellinger takes the gathered route's chunk loop (three chunks here)."""
    X, Q = data
    if metric == "Hellinger":  # distributions
        X, Q = np.abs(X) / np.abs(X).sum(1, keepdims=True), np.abs(Q) / np.abs(Q).sum(
            1, keepdims=True)
    Xt, qt = torch.from_numpy(X), torch.from_numpy(Q)
    xsq = (Xt * Xt).sum(-1)
    k = 10
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("hnsw_tpu_torch.models.brute._BROADCAST_ELEMS", 6 * N * D)
        prog = program.TopkProgram(Xt, xsq, B, "cpu", k=k, metric=metric)
        got = prog.run(qt)
        _equal(got, _bf_topk(qt, Xt, xsq, k, metric))
    jv, ji = j_bf_topk(jnp.asarray(Q), jnp.asarray(X), jnp.asarray((X * X).sum(-1)), k,
                       metric)
    np.testing.assert_array_equal(got[1].numpy(), np.array(ji))
    np.testing.assert_allclose(got[0].numpy(), np.array(jv), rtol=0, atol=1e-5)


def _clustered(rng, n, d=32, C=16, spread=0.2):
    cent = rng.standard_normal((C, d)).astype(np.float32)
    return (cent[rng.integers(0, C, n)]
            + spread * rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


@pytest.fixture(scope="module")
def ivf_pair():
    """A JAX-built IVF index and its lists carried into the port."""
    rng = np.random.default_rng(0x1F)
    X, Q = _clustered(rng, 3000), _clustered(rng, 600)
    out = {}
    for dist in ("L2", "Cosine"):
        j = J.IvfFlatIndex(dist=dist, n_clusters=24, nprobe=5)
        j.parallel_insert((X, np.arange(len(X), dtype=np.int64)))
        j.build()
        out[dist] = (j, T.ivf_from_arrays(T.ivf_to_arrays(j), dist=dist, nprobe=5,
                                          device="cpu"))
    return out, X, Q


@pytest.mark.parametrize("nprobe", [1, 5])
@pytest.mark.parametrize("dist", ["L2", "Cosine"])
def test_ivf_program_equals_eager_and_jax(ivf_pair, dist, nprobe):
    """``IvfProgram`` answers as the direct ``ivf_search`` (route, probe,
    refine) bit for bit, and as the JAX chain ``_ivf_route`` ->
    ``_ivf_probe`` -> ``_exact_refine`` on the same lists (row sets, dists
    within 1e-5)."""
    pairs, _, Q = ivf_pair
    j, t = pairs[dist]
    q = t._queries(Q[:64])
    kf = 32
    lists = t._built[:5]
    prog = program.IvfProgram(lists, len(q), torch.float32, "cpu", nprobe=nprobe, kf=kf,
                              metric=dist)
    qt = torch.from_numpy(q)
    got = prog.run(qt)
    _equal(got, ivf_search(qt, *lists, nprobe=nprobe, kf=kf, metric=dist))
    cent, csq, Xs, Xf, xsq, _, _ = j._built
    qj = jnp.asarray(q)
    pcT = j_route(qj, cent, csq, nprobe, dist)
    rows, _ = j_probe(qj, cent, csq, Xs, xsq, pcT, kf, dist)
    jr, jd = j_refine(qj, Xf, xsq, rows, dist)
    _sets_equal(got[0].numpy(), np.array(jr))
    np.testing.assert_allclose(got[1].numpy(), np.array(jd), rtol=0, atol=1e-5)


@pytest.fixture
def stubs(monkeypatch):
    """Every serving program built on stub graphs (a replay counts and runs
    nothing); returns the graphs made, in order. The IVF build's k-means step
    (``KmeansProgram``) runs its piece as on the CPU: a stub replay would hand
    back what its capture computed."""
    graphs = []

    def factory():
        graphs.append(StubGraph())
        return graphs[-1]

    pieces = program.Program._pieces
    monkeypatch.setattr(program.Program, "_pieces",
                        lambda self, fns, graph_factory=None, capture=None:
                        pieces(self, fns, graph_factory, capture)
                        if isinstance(self, program.KmeansProgram)
                        else pieces(self, fns, factory, stub_capture))
    return graphs


@pytest.fixture
def counted_scan(monkeypatch):
    """B2's wrapper counting a launch as on the card, then its plain version."""
    def scan(qs, Xs, xsq, tn, group, acc):
        kernel_lib.launch("scan_topk", "wgmma", lambda: 0)
        return st.scan_packed_plain(qs, Xs, xsq, tn, group, acc)
    monkeypatch.setattr(st, "scan_packed", scan)


def _bf(X, scan=True):
    bf = T.BruteForceIndex(device="cpu")
    if scan:
        bf.SCAN_MIN_POINTS = 1
    bf.parallel_insert(X)
    return bf


def test_scan_launches_counted_per_replay(data, stubs, counted_scan):
    """A capture counts no launch; each replay adds the one B2 launch it
    recorded, through the entry it took."""
    X, Q = data
    Xp, xsq, _ = st.pad_corpus(X, tn=TN)
    before = dict(kernel_lib.LAUNCHES)
    prog = program.ScanProgram(torch.from_numpy(Xp), torch.from_numpy(xsq), B,
                               torch.float32, "cpu", k=10, tn=TN, group=GROUP, acc=ACC,
                               overfetch=8)
    assert kernel_lib.LAUNCHES == before and len(stubs) == 1
    assert prog._piece.launches == {"scan_topk": 1, "scan_topk.wgmma": 1}
    for n in (1, 2, 3):
        prog.run(torch.from_numpy(Q))
        assert kernel_lib.LAUNCHES["scan_topk.wgmma"] == before["scan_topk.wgmma"] + n
        assert stubs[0].replays == n


def test_exact_stream_one_capture_per_key(data, stubs, counted_scan):
    """``BruteForceIndex.search_batch`` streams through one program per key:
    600 queries in batches of 600 and then 256 (its ragged tail padded), one
    capture each, each batch one replay; a second call captures nothing; an
    insert drops the programs."""
    X, Q = data
    bf = _bf(X)
    q = np.tile(Q, (40, 1))[:600]
    bf.search_batch(q, 10)
    assert len(stubs) == 1 and len(bf._programs) == 1 and stubs[0].replays == 1
    Xd, xsq, Xscan, _, acc, programs = bf._scan_device()
    before = kernel_lib.LAUNCHES["scan_topk"]
    st.l2_topk_stream(q, Xd, xsq, 10, Xscan=Xscan, acc=acc, batch=256, programs=programs)
    assert len(stubs) == 2 and stubs[1].replays == 3  # 256 + 256 + 88 padded to 256
    assert kernel_lib.LAUNCHES["scan_topk"] - before == 3
    assert {key[1] for key in programs._progs} == {600, 256}
    bf.search_batch(q, 10)
    assert len(stubs) == 2 and stubs[0].replays == 2
    bf.insert(X[0], N)
    assert len(bf._programs) == 0
    bf.search_batch(q, 10)
    assert len(stubs) == 3


def test_exact_stream_without_cache_builds_for_the_call(data):
    """Without a cache the stream builds one program for the call (the pieces
    on the CPU) and answers as ``l2_topk`` batch by batch."""
    X, Q = data
    Xp, xsq, _ = st.pad_corpus(X, tn=st.SCAN_TN)
    Xt, xt = torch.from_numpy(Xp), torch.from_numpy(xsq)
    q = np.tile(Q, (3, 1))[:40]
    d, i = st.l2_topk_stream(q, Xt, xt, 10, batch=16, acc=1)
    for s in range(0, 40, 16):
        qb = torch.from_numpy(q[s:s + 16])
        dd, ii = st.l2_topk(qb, Xt, xt, 10, acc=1)
        np.testing.assert_array_equal(d[s:s + 16], dd.numpy())
        np.testing.assert_array_equal(i[s:s + 16], ii.numpy())


def test_topk_route_one_capture_per_key(data, stubs):
    """Below the scan, ``_bf_topk`` replays one program per batch shape."""
    X, Q = data
    bf = _bf(X, scan=False)
    assert not bf._use_scan()
    bf.search_batch(Q, 5)
    bf.search_batch(Q, 5)
    bf.search_batch(Q[:3], 5)
    assert len(stubs) == 2 and [g.replays for g in stubs] == [2, 1]
    (prog, _) = bf._programs._progs.values()
    assert isinstance(prog, program.TopkProgram)


def test_ivf_programs_ragged_tails_and_rebuild(ivf_pair, stubs):
    """``IvfFlatIndex``: ``search_batch``'s ragged last chunk is a second key
    and the stream's ragged tail batch a third (f16 ingest), each built
    once; an insert and a rebuild of the lists drop them."""
    pairs, X, Q = ivf_pair
    ix = T.IvfFlatIndex(n_clusters=24, nprobe=5, device="cpu")
    ix.parallel_insert((X, np.arange(len(X))))
    ix.search_batch(Q, 10)  # chunks of 512 and 88
    ix.search_batch(Q, 10)
    assert len(stubs) == 2 and [g.replays for g in stubs] == [2, 2]
    ix.search_stream(Q, 10, batch=256)  # 256, 256, 88 in f16
    assert len(stubs) == 4 and [g.replays for g in stubs[2:]] == [2, 1]
    assert {(key[1], key[2]) for key in ix._programs._progs} == {
        (512, "torch.float32"), (88, "torch.float32"), (256, "torch.float16"),
        (88, "torch.float16")}
    assert all(isinstance(p, program.IvfProgram) for p in ix._programs._progs.values())
    ix.insert(X[0], len(X))
    assert len(ix._programs) == 0
    ix.search_batch(Q[:8], 10)
    assert len(ix._programs) == 1 and len(stubs) == 5
    s = T.ivf_to_arrays(ix)
    ix._set_built(s["centroids"], s["packed"], s["xsq"], s["row2idx"], int(s["cap"]))
    assert len(ix._programs) == 0


@pytest.mark.parametrize("engine", ["brute", "ivf"])
def test_filtered_search_through_programs(ivf_pair, engine):
    """A filtered search replays the same program the unfiltered one would at
    its wider ``kf`` and post-masks on the host: it equals the direct call's
    candidates post-masked, and every id passes the filter."""
    _, X, Q = ivf_pair
    keep = list(range(0, len(X), 2))
    if engine == "brute":
        ix = _bf(X)
        ids, d = ix.search_batch(Q, 10, filter=keep)
        Xd, xsq, Xscan, perm, acc, programs = ix._scan_device()
        (prog,) = programs._progs.values()
        qb = np.concatenate([Q, np.repeat(Q[-1:], prog.inputs[0].shape[0] - len(Q), 0)])
        dd, ii = st.l2_topk(torch.from_numpy(qb), Xd, xsq, Xscan=Xscan, **prog.kw)
        want = ix._finish(dd.numpy()[:len(Q)], perm[ii.numpy()[:len(Q)]], 10, keep)
    else:
        ix = T.IvfFlatIndex(n_clusters=24, nprobe=5, device="cpu")
        ix.parallel_insert((X, np.arange(len(X))))
        ids, d = ix.search_batch(Q, 10, filter=keep)
        nprobe, kf = ix._probe_plan(10, 0, None, keep)
        rows, dd = zip(*(ivf_search(torch.from_numpy(Q[s:s + 512]), *ix._built[:5],
                                    nprobe=nprobe, kf=kf, metric="L2")
                         for s in range(0, len(Q), 512)))
        want = ix._finish(torch.cat(rows).numpy(), torch.cat(dd).numpy(), 10, keep)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(d, want[1])
    assert (ids >= 0).all() and (ids % 2 == 0).all()


@pytest.fixture(scope="module")
def sharded():
    rng = np.random.default_rng(0x5C)
    X = rng.random((800, 16)).astype(np.float32)
    sh = T.ShardedHnsw(n_shards=8, device="cpu", max_elements=800 // 8 + 8,
                       max_nb_connection=8, ef_construction=32, dist="L2")
    sh.parallel_insert((X, np.arange(len(X))), mode="device")
    return sh, rng.random((24, 16)).astype(np.float32)


@pytest.mark.parametrize("mode,filtered", [("pallas", False), ("tiled", False),
                                           ("tiled", True)])
def test_sharded_exact_programs_equal_eager(sharded, mode, filtered):
    """``ShardedHnsw.exact_search_batch`` through eight per-shard programs
    equals each shard's scan called directly and merged the same way; a
    second call reuses the programs."""
    sh, Q = sharded
    flt = list(range(0, 800, 3)) if filtered else None
    ids, dists = sh.exact_search_batch(Q, 10, filter=flt, mode=mode, tile=64)
    st_ = sh._build_state()  # one GraphArrays a shard
    qt = torch.from_numpy(Q)
    if mode == "pallas":
        Xp, xsqp, Np = sh._scan_arrays(st.SCAN_TN)
        scan = _sharded_scan_pallas_fn(10, st.SCAN_TN, Np, st_.cap1)
        out = [scan(g.vectors, g.n, x, s, qt) for g, x, s in zip(st_.graphs, Xp, xsqp)]
    else:
        scan = _sharded_scan_fn("L2", 10, 64)
        masks = sh._masks(flt, st_) if filtered else [None] * 8
        out = [scan(g.vectors, g.sqnorms, g.n, qt, m) for g, m in zip(st_.graphs, masks)]
    want = sh._to_external(st_, *_merge_shard_topk([o[0] for o in out],
                                                   [o[1] for o in out], 10, "cpu"))
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(dists, want[1])
    progs = [next(p for k, p in c._progs.items() if k[:2] == ("exact", mode))
             for c in sh._programs]
    assert all(isinstance(p, program.CallProgram) for p in progs)
    sh.exact_search_batch(Q, 10, filter=flt, mode=mode, tile=64)
    assert [next(p for k, p in c._progs.items() if k[:2] == ("exact", mode))
            for c in sh._programs] == progs
    if filtered:
        assert (ids[ids >= 0] % 3 == 0).all()


@pytest.mark.parametrize("engine,kind", [("scan", program.ScanProgram),
                                         ("ivf", program.IvfProgram)])
def test_auto_index_engines_replay(ivf_pair, monkeypatch, engine, kind):
    """``AutoIndex`` reaches the programs through the engine it builds: its
    scan and IVF engines' searches are replays of their programs (and the
    IVF build's k-means steps replays of its ``KmeansProgram``)."""
    _, X, Q = ivf_pair
    runs = []
    run = program.CallProgram.run
    monkeypatch.setattr(program.CallProgram, "run",
                        lambda self, *a: runs.append(self) or run(self, *a))
    monkeypatch.setattr(T.BruteForceIndex, "SCAN_MIN_POINTS", 1)
    a = T.AutoIndex("L2", engine=engine, device="cpu")
    a.parallel_insert(zip(X, range(len(X))))
    ids, _ = a.search_batch(Q[:100], 10)
    progs = list(a.engine._programs._progs.values())
    kmeans = [r for r in runs if isinstance(r, program.KmeansProgram)]
    assert len(progs) == 1 and isinstance(progs[0], kind)
    assert [r for r in runs if r not in kmeans] == progs
    assert bool(kmeans) == (engine == "ivf")
    assert (ids >= 0).all()


@pytest.mark.parametrize("engine", ["matmul", "scan", "ivf"])
def test_empty_batch_builds_no_program(data, engine):
    """An empty batch answers empty rows and builds no program."""
    X, _ = data
    if engine == "ivf":
        ix = T.IvfFlatIndex(n_clusters=8, device="cpu")
        ix.parallel_insert((X, np.arange(N)))
    else:
        ix = _bf(X, scan=engine == "scan")
    ids, d = ix.search_batch(np.zeros((0, D), np.float32), 5)
    assert ids.shape == d.shape == (0, 5) and len(ix._programs) == 0
