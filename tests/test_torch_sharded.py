"""The port's sharded tier (``hnsw_tpu_torch/parallel/sharded.py``) on eight
shards of one CPU device: the ``ShardedHnsw`` cases of
``tests/test_sharded.py`` at small size, and parity with the JAX package's
``ShardedHnsw`` on its 8-device CPU mesh — one mesh round from the same
states, a whole mesh build, the search and the exact search of the same
graphs, and each package reloading the other's manifest dump."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax

import hnsw_tpu.ops.insert_rounds as jir
import hnsw_tpu_torch.ops.insert_rounds as tir
from hnsw_tpu.parallel.sharded import (ShardedHnsw as JShardedHnsw, default_mesh,
                                       sharded_insert_round_fn as j_round_fn)
from hnsw_tpu_torch import Hnsw, ShardedHnsw, get_metric, to_arrays
from hnsw_tpu_torch.ops import program
from hnsw_tpu_torch.ops.graph_arrays import GraphArrays
from hnsw_tpu_torch.ops.insert_rounds import BuildTensors
from hnsw_tpu_torch.parallel import sharded
from hnsw_tpu_torch.parallel.sharded import (default_devices, sharded_insert_round_fn,
                                             sharded_program_round)
from hnsw_tpu_torch.utils.profiling import PROFILER, enable_profiling
from test_torch_build import jax_from_state
from test_torch_build_program import DeferredPiece, _peaks_by_kind, _programs, rounds_through

D = 8
KW = dict(max_nb_connection=12, ef_construction=64, dist="L2")


def _sharded(n, **kw):
    return ShardedHnsw(n_shards=D, device="cpu", max_elements=n // D + 8, **{**KW, **kw})


def _recall(ids, dists, X, Q, k, tol=1e-6, metric="L2"):
    truth = get_metric(metric).brute_force(Q, X)
    hits = sum(int((dists[b][np.isfinite(dists[b])] <= np.sort(truth[b])[k - 1] + tol).sum())
               for b in range(len(Q)))
    return hits / (len(Q) * k)


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest provides 8 virtual CPU devices"
    return default_mesh(8)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0x5A)
    return rng.random((2000, 16)).astype(np.float32), rng.random((24, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def meshed(data):
    """The port's mesh build of 2000 points (batch 128)."""
    X, _ = data
    sh = _sharded(len(X))
    sh.parallel_insert((X, np.arange(len(X))), mode="mesh", batch_size=128)
    return sh


@pytest.fixture(scope="module")
def serial(data):
    """The port's serial build of the same points (the host oracle per shard)."""
    X, _ = data
    sh = _sharded(len(X), ef_construction=48)
    sh.parallel_insert(list(zip(X, range(len(X)))), mode="serial")
    return sh


def _carried(sh, mesh8):
    """The JAX package's ShardedHnsw holding the port's shards' graphs."""
    j = JShardedHnsw(mesh=mesh8, max_elements=sh.shards[0]._cap,
                     **{**KW, "ef_construction": sh.shards[0].ef_construction})
    j.shards = [jax_from_state(to_arrays(s), s) for s in sh.shards]
    return j


# ------------------------------------------------ the cases of test_sharded.py -----

def test_sharded_recall_beats_single_graph_floor(serial, data):
    X, Q = data
    ids, dists = serial.search_batch(Q, 10, 48)
    assert ids.shape == (len(Q), 10) and len(serial) == len(X)
    assert _recall(ids, dists, X, Q, 10) >= 0.9
    truth = get_metric("L2").brute_force(Q, X)
    for b in range(4):
        for j in range(10):
            assert dists[b, j] == pytest.approx(truth[b, ids[b, j]], rel=1e-4, abs=1e-4)


def test_sharded_self_retrieval(serial, data):
    X, _ = data
    ids, _ = serial.search_batch(X[:64], 1, 24)
    assert sum(1 for i in range(64) if int(ids[i, 0]) == i) >= 62


def test_sharded_more_shards_than_points(rng):
    """Empty shards never put id -1 with a finite distance into the merge."""
    n, k = 5, 5
    X = rng.random((n, 8)).astype(np.float32)
    sh = ShardedHnsw(n_shards=D, device="cpu", max_nb_connection=8, max_elements=16,
                     ef_construction=32, dist="L2")
    sh.parallel_insert(list(zip(X, range(n))), mode="serial")
    ids, dists = sh.search_batch(X[:3], k, 16)
    for b in range(3):
        finite = np.isfinite(dists[b])
        assert (ids[b][finite] >= 0).all() and set(ids[b][finite]) == set(range(n))
        assert int(ids[b, 0]) == b


def test_mesh_build_product_path(meshed, data):
    """One round per step advances all eight shards, and the result serves."""
    X, Q = data
    assert len(meshed) == len(X)
    for s in meshed.shards:
        assert s._nb_point == len(X) // D
        assert (s._layers[0].counts[1: s._nb_point] > 0).mean() > 0.95
    ids, dists = meshed.search_batch(Q, 10, 48)
    assert _recall(ids, dists, X, Q, 10) >= 0.9
    ids2, _ = meshed.search_batch(X[:32], 1, 24)
    assert sum(1 for i in range(32) if int(ids2[i, 0]) == i) >= 31


def test_mesh_build_uneven_shards(rng):
    n, d, k = 1601, 12, 5
    X = rng.random((n, d)).astype(np.float32)
    sh = ShardedHnsw(n_shards=D, device="cpu", max_nb_connection=10,
                     max_elements=n // D + 9, ef_construction=48, dist="L2")
    sh.parallel_insert(list(zip(X, range(n))), mode="mesh", batch_size=128)
    sizes = sorted(s._nb_point for s in sh.shards)
    assert sizes[-1] - sizes[0] <= 1 and sum(sizes) == n
    ids, _ = sh.search_batch(X[n - 1: n], 1, 24)
    assert int(ids[0, 0]) == n - 1
    Q = rng.random((16, d)).astype(np.float32)
    ids, dists = sh.search_batch(Q, k, 32)
    assert _recall(ids, dists, X, Q, k) >= 0.85


def _four_shard_build(X, keep_pruned=None, scale=None):
    """A mesh build of ``X`` over four CPU shards, after the sharded setters."""
    sh = ShardedHnsw(n_shards=4, device="cpu", max_elements=len(X) // 4 + 8, **KW)
    if keep_pruned is not None:
        sh.set_keeping_pruned(keep_pruned)
    if scale is not None:
        sh.modify_level_scale(scale)
    sh.parallel_insert((X, np.arange(len(X))), mode="mesh", batch_size=128)
    return sh


def _mean_degree0(h) -> float:
    return float(h._layers[0].counts[: h._nb_point].mean())


@pytest.fixture(scope="module")
def four_builds():
    """The same 2400 points meshed over four shards: at level scale 0.5 with
    and without pruned links kept, and at the default scale; each build's
    round configurations."""
    X = np.random.default_rng(0x5B).random((2400, 16)).astype(np.float32)
    out = {}
    orig = sharded.sharded_insert_round_fn
    for name, kw in (("half", dict(keep_pruned=False, scale=0.5)),
                     ("half_kept", dict(keep_pruned=True, scale=0.5)),
                     ("default", {})):
        cfgs = []

        def spy(devices, cfg):
            cfgs.append(cfg)
            return orig(devices, cfg)

        sharded.sharded_insert_round_fn = spy
        try:
            out[name] = (_four_shard_build(X, **kw), cfgs)
        finally:
            sharded.sharded_insert_round_fn = orig
    return X, out


def test_mesh_build_takes_the_sharded_level_scale(four_builds):
    """``modify_level_scale`` reaches every shard's level generator: the share
    of each shard's rows above layer 0 follows the scale, exp(-1/scale)."""
    _, builds = four_builds
    for name, factor in (("half", 0.5), ("default", 1.0)):
        sh = builds[name][0]
        scale = factor / np.log(KW["max_nb_connection"])
        for h in sh.shards:
            assert h.get_level_scale() == pytest.approx(scale)
            n = h._nb_point
            share, p = float((h._level[:n] > 0).mean()), float(np.exp(-1.0 / scale))
            assert abs(share - p) <= 4 * np.sqrt(p * (1 - p) / n) + 1 / n, (name, share, p)
    assert all((a._level[: a._nb_point] > 0).sum() < (b._level[: b._nb_point] > 0).sum()
               for a, b in zip(builds["half"][0].shards, builds["default"][0].shards))


def test_mesh_build_keeps_pruned_links_when_set(four_builds):
    """``set_keeping_pruned`` reaches every shard and the mesh build's rounds:
    the same levels, fuller layer-0 rows, as a lone ``Hnsw``'s build."""
    X, builds = four_builds
    (plain, plain_cfgs), (kept, kept_cfgs) = builds["half"], builds["half_kept"]
    assert all(h.keep_pruned for h in kept.shards) and not any(h.keep_pruned for h in plain.shards)
    assert {c.keep_pruned for c in kept_cfgs} == {True}
    assert {c.keep_pruned for c in plain_cfgs} == {False}
    for a, b in zip(plain.shards, kept.shards):
        np.testing.assert_array_equal(a._level[: a._nb_point], b._level[: b._nb_point])
        assert _mean_degree0(b) > _mean_degree0(a)
    lone = []
    for keep in (False, True):
        h = Hnsw(max_nb_connection=KW["max_nb_connection"], max_elements=len(X) // 4 + 8,
                 ef_construction=KW["ef_construction"], dist="L2", device="cpu")
        h.set_keeping_pruned(keep)
        h.modify_level_scale(0.5)
        h.parallel_insert((X[::4], np.arange(0, len(X), 4)), mode="device", batch_size=128)
        lone.append(_mean_degree0(h))
    assert lone[1] > lone[0]


def test_sharded_codec_fast_path_matches_exact(meshed, data):
    """The per-shard int8 codec (no id rows: kernel B3's layout) with the
    exact rerank returns the neighbours of the exact traversal."""
    _, Q = data
    meshed.set_traversal_codec(None)
    ids_e, d_e = meshed.search_batch(Q, 10, 48)
    meshed.set_traversal_codec("i8")
    try:
        blocks, bsq, scale, M0, dim = meshed.device_codec_arrays()
        assert len(blocks) == D and blocks[0].dtype == torch.int8
        assert blocks[0].shape == (meshed.searcher().cap1, M0, dim) == bsq[0].shape + (dim,)
        ids_c, d_c = meshed.search_batch(Q, 10, 48)
    finally:
        meshed.set_traversal_codec("auto")
    assert (ids_e == ids_c).mean() >= 0.95
    same = ids_e == ids_c
    np.testing.assert_allclose(d_e[same], d_c[same], rtol=1e-5, atol=1e-6)


def test_sharded_filtered_search(meshed, data):
    X, Q = data
    allowed = np.arange(0, len(X), 3)
    meshed.set_traversal_codec("i8")
    try:
        ids, dists = meshed.search_batch(Q, 5, 48, filter=allowed)
    finally:
        meshed.set_traversal_codec("auto")
    got = ids[ids >= 0]
    assert len(got) and (got % 3 == 0).all(), "the filter let an id through"
    assert _recall(ids, dists, X[allowed], Q, 5) >= 0.85


def test_sharded_64bit_external_ids(rng):
    """Ids past 2^32 survive the sharded tier (int64 on the host); ``shard_of``
    reports the recorded placement."""
    n = 1200
    X = rng.random((n, 8)).astype(np.float32)
    ids64 = np.int64(2**32 + 7) + 3 * np.arange(n, dtype=np.int64)
    sh = ShardedHnsw(n_shards=D, device="cpu", max_nb_connection=10,
                     max_elements=n // D + 8, ef_construction=48, dist="L2")
    sh.parallel_insert((X, ids64), mode="mesh", batch_size=128)
    out, _ = sh.search_batch(X[:32], 1, 24)
    assert out.dtype == np.int64
    assert sum(1 for i in range(32) if int(out[i, 0]) == int(ids64[i])) >= 31
    for i in (0, 1, 7, n - 1):
        s = sh.shard_of(int(ids64[i]))
        assert int(ids64[i]) in sh.shards[s]._origin[: sh.shards[s]._nb_point]
    with pytest.raises(KeyError):
        sh.shard_of(12345)


def test_mesh_build_dot_metric(rng):
    from hnsw_tpu_torch import l2_normalize
    n, d, k = 1024, 12, 5
    X = l2_normalize(rng.standard_normal((n, d)).astype(np.float32))
    sh = ShardedHnsw(n_shards=D, device="cpu", max_nb_connection=10,
                     max_elements=n // D + 8, ef_construction=48, dist="Dot")
    sh.parallel_insert(list(zip(X, range(n))), mode="mesh", batch_size=128)
    Q = l2_normalize(rng.standard_normal((12, d)).astype(np.float32))
    ids, dists = sh.search_batch(Q, k, 32)
    assert _recall(ids, dists, X, Q, k, tol=1e-5, metric="Dot") >= 0.8


def test_sharded_exact_scan(rng):
    """Exact answers, 64-bit external ids, filters in the scan."""
    n, d, k = 1600, 16, 10
    X = rng.random((n, d)).astype(np.float32)
    ext = np.arange(n, dtype=np.int64) * 7 + np.int64(2) ** 33
    sh = ShardedHnsw(n_shards=D, device="cpu", max_nb_connection=8,
                     max_elements=n // D + 8, ef_construction=32, dist="L2")
    sh.parallel_insert((X, ext), mode="device", batch_size=128)
    Q = rng.random((16, d)).astype(np.float32)
    ids, dists = sh.exact_search_batch(Q, k)
    truth = get_metric("L2").brute_force(Q, X)
    for b in range(16):
        assert set(ids[b].tolist()) == set(ext[np.argsort(truth[b], kind="stable")[:k]].tolist())
        np.testing.assert_allclose(dists[b], np.sort(truth[b])[:k], rtol=1e-4, atol=1e-4)
    fids, fd = sh.exact_search_batch(Q, k, filter=sorted(int(e) for e in ext if e % 3 == 0))
    assert (fids % 3 == 0).all()
    truth_r = get_metric("L2").brute_force(Q, X[ext % 3 == 0])
    for b in range(16):
        np.testing.assert_allclose(fd[b], np.sort(truth_r[b])[:k], rtol=1e-4, atol=1e-4)


def test_sharded_exact_scan_rejects_non_matmul_metric(rng):
    sh = ShardedHnsw(n_shards=D, device="cpu", max_nb_connection=8, max_elements=64,
                     ef_construction=40, dist="Hamming", dtype=np.int32)
    sh.parallel_insert(list(zip(rng.integers(0, 2, (32, 8)).astype(np.int32), range(32))),
                       mode="serial")
    with pytest.raises(ValueError):
        sh.exact_search_batch(rng.integers(0, 2, (4, 8)).astype(np.int32), 5)


def test_sharded_dump_reload(serial, data, tmp_path):
    """``file_dump``/``load`` round-trips: per-shard graphs equal, answers equal."""
    X, Q = data
    base = serial.file_dump(tmp_path, "meshidx")
    r = ShardedHnsw.load(tmp_path, base, devices=serial.devices,
                         max_elements=len(X) // D + 8, **KW)
    assert len(r) == len(X) and r.devices == serial.devices
    for s in range(D):
        assert serial.shards[s].check_graph_equality(r.shards[s])
    i1, d1 = serial.search_batch(Q, 5, 32)
    i2, d2 = r.search_batch(Q, 5, 32)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)


def test_sharded_exact_scan_modes_agree(serial, data):
    """The tiled scan (many slices, a clamped last one) and the packed scan
    (its plain version here) both give the exact answer."""
    X, Q = data
    truth = get_metric("L2").brute_force(Q, X)
    ids_t, d_t = serial.exact_search_batch(Q, 10, mode="tiled", tile=64)
    ids_p, d_p = serial.exact_search_batch(Q, 10, mode="pallas")
    for b in range(len(Q)):
        want = set(np.argsort(truth[b], kind="stable")[:10].tolist())
        assert set(ids_t[b].tolist()) == want == set(ids_p[b].tolist()), b
        np.testing.assert_allclose(d_t[b], np.sort(truth[b])[:10], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(d_p[b], np.sort(truth[b])[:10], rtol=1e-4, atol=1e-4)


def test_sharded_search_stream(serial, data):
    """The pipelined stream answers as ``search_batch``, in input order, over
    several batches and a short tail, with a filter and with f16 ingest."""
    X, _ = data
    Q = np.random.default_rng(9).random((100, 16)).astype(np.float32)
    ids_b, d_b = serial.search_batch(Q, 10, ef=64)
    ids_s, d_s = serial.search_stream(Q, 10, ef=64, batch=40)
    np.testing.assert_array_equal(ids_s, ids_b)
    np.testing.assert_allclose(d_s, d_b, rtol=1e-6)
    fil = sorted(range(0, len(X), 3))
    fids_b, _ = serial.search_batch(Q, 10, ef=64, filter=fil)
    fids_s, _ = serial.search_stream(Q, 10, ef=64, filter=fil, batch=40)
    np.testing.assert_array_equal(fids_s, fids_b)
    ids_h, _ = serial.search_stream(Q, 10, ef=64, batch=40, query_dtype="f16")
    assert ids_h.shape == ids_b.shape
    assert (np.sort(ids_h[:, :1], 0) == np.sort(ids_b[:, :1], 0)).mean() > 0.9


# ------------------------------------------------------- the port's own --------------

def test_default_devices_raise_without_cuda():
    """Entry points run on the card unless the CPU is asked for; a device may
    repeat."""
    assert default_devices(3, "cpu") == [torch.device("cpu")] * 3
    if torch.cuda.is_available():
        assert ShardedHnsw(n_shards=2).devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ShardedHnsw(n_shards=2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            default_devices(2)


# --------------------------------------------------- parity with the JAX package -----

@pytest.fixture(scope="module")
def jmeshed(data, mesh8):
    """The JAX package's mesh build of the same points."""
    X, _ = data
    j = JShardedHnsw(mesh=mesh8, max_elements=len(X) // D + 8, **KW)
    j.parallel_insert((X, np.arange(len(X))), mode="mesh", batch_size=128)
    return j


def test_round_identical_to_reference(meshed, mesh8):
    """One sharded round from the same conformed states (the built shards
    carried across, 64 new points a shard) writes the same tables and
    in-degrees on every real row of every shard."""
    _one_round_against_reference(meshed, mesh8, None)


def test_round_through_programs_identical_to_reference(meshed, mesh8, monkeypatch):
    """The same round through every shard's round programs, interleaved part
    by part and chunk by chunk (``sharded_program_round``), writes what the
    JAX package's round writes. (A key's first run is uncaptured; the
    captured replays of a whole mesh build are held against the eager build
    in ``test_mesh_build_through_programs``.)"""
    monkeypatch.setattr(program, "Piece", DeferredPiece)
    progs = [_programs([]) for _ in range(D)]
    _one_round_against_reference(meshed, mesh8, progs)
    assert all(p.stats["rounds"] == 1 and p.stats["first_runs"] == p.stats["keys"] > 0
               for p in progs)


@pytest.mark.parametrize("form", ["eager", "programs"])
def test_round_keeping_pruned_identical_to_reference(meshed, mesh8, monkeypatch, form):
    """The same round with pruned links kept (the sharded cell's setting),
    eager and through every shard's round programs, writes what the JAX
    package's round writes."""
    progs = None
    if form == "programs":
        monkeypatch.setattr(program, "Piece", DeferredPiece)
        progs = [_programs([]) for _ in range(D)]
    _one_round_against_reference(meshed, mesh8, progs, keep_pruned=True)


def _one_round_against_reference(meshed, mesh8, progs, keep_pruned=False):
    """One round from the states of ``test_round_identical_to_reference``,
    eager (``progs`` None) or through ``progs`` (one ``BuildPrograms`` a
    shard), held against the JAX package's."""
    rng = np.random.default_rng(3)
    X2 = rng.random((D * 64, 16)).astype(np.float32)
    ids2 = 10_000 + np.arange(len(X2))
    from hnsw_tpu_torch import from_arrays
    from hnsw_tpu_torch.convert import params_of
    outs = []
    for pkg in ("torch", "jax"):
        mod = tir if pkg == "torch" else jir
        shards = [from_arrays(to_arrays(s), params_of(s), device="cpu") if pkg == "torch"
                  else jax_from_state(to_arrays(s), s) for s in meshed.shards]
        states = [mod.HostBuildState(shards[s], (X2[s::D], ids2[s::D])) for s in range(D)]
        L = max(st.L for st in states)
        widths = tuple(max([shards[0]._layer_width(l)]
                           + [st.widths[l] for st in states if l < st.L]) for l in range(L))
        cap1 = max(st.cap1 for st in states)
        for st in states:
            st.conform(L, widths, cap1)
        Br = min(st.ramp(64) for st in states)
        max_obs = max(st.entry_level for st in states)
        nonempty = tuple(bool(any(st.counts[l] > 0 for st in states)) for l in range(L))
        entry = [int(st.entry) for st in states]
        bidx = np.empty((D, Br), np.int32)
        n_hi = 0
        for s, st in enumerate(states):
            bidx[s], nh = st.round_batch(Br)
            n_hi = max(n_hi, nh)
        B1 = 0 if n_hi == 0 else int(min(Br, mod._next_pow2(max(8, n_hi))))
        cfg = mod.RoundConfig(B=Br, cap1=cap1, num_layers=L, widths=widths, efc=64, M=12,
                              metric="L2", expand=8, max_obs=max_obs, nonempty=nonempty,
                              keep_pruned=keep_pruned, B1=B1)
        vec = [st.vec_np() for st in states]
        tabs = [st.tables_np() for st in states]
        ind = [st.indeg0_np() for st in states]
        if pkg == "torch":
            vt = [torch.from_numpy(v) for v in vec]
            args = (vt, [(v * v).sum(-1) for v in vt],
                    [torch.from_numpy(st.levels_np()) for st in states],
                    [[(torch.from_numpy(i), torch.from_numpy(d)) for i, d in t] for t in tabs],
                    bidx, entry, [torch.from_numpy(i) for i in ind])
            devs = [torch.device("cpu")] * D
            if progs is None:
                tables, indeg = sharded_insert_round_fn(devs, cfg)(*args)
            else:
                bts = [BuildTensors(*(x[s] for x in args[:4]), None, args[6][s])
                       for s in range(D)]
                sharded_program_round(devs, progs, bts, cfg, bidx, entry)
                tables, indeg = [list(bt.tables()) for bt in bts], args[6]
            tables = [[(i.numpy(), d.numpy()) for i, d in t] for t in tables]
            indeg = [i.numpy() for i in indeg]
        else:
            shd = jax.NamedSharding(mesh8, jax.sharding.PartitionSpec("shard"))
            put = lambda a: jax.device_put(a, shd)
            v = np.stack(vec)
            tj = tuple((put(np.stack([tabs[s][l][0] for s in range(D)])),
                        put(np.stack([tabs[s][l][1] for s in range(D)]))) for l in range(L))
            out, indj = j_round_fn(mesh8, "shard", cfg)(
                put(v), put((v ** 2).sum(-1)),
                put(np.stack([st.levels_np() for st in states])), tj, put(bidx),
                put(np.array(entry, np.int32)), put(np.stack(ind)))
            tables = [[(np.array(out[l][0][s]), np.array(out[l][1][s])) for l in range(L)]
                      for s in range(D)]
            indeg = list(np.array(indj))
        outs.append((tables, indeg, [st.n_total for st in states]))
    (tt, it, ns), (tj, ij, _) = outs
    for s in range(D):
        n = ns[s]
        for (a_i, a_d), (b_i, b_d) in zip(tt[s], tj[s]):
            np.testing.assert_array_equal(a_i[:n], b_i[:n])
            np.testing.assert_allclose(a_d[:n], b_d[:n], rtol=1e-5)
        np.testing.assert_array_equal(it[s][:n], ij[s][:n])


def test_mesh_build_close_to_reference(meshed, data, jmeshed):
    """The JAX package's mesh build of the same points: equal levels, >= 99.5%
    of layer-0 rows identical (f32 summation order can flip a near-tie in the
    prune), recall@10 within 0.005."""
    X, Q = data
    j = jmeshed
    same = []
    for a, b in zip(meshed.shards, j.shards):
        ta, tb = to_arrays(a), to_arrays(b)
        np.testing.assert_array_equal(ta["_level"], tb["_level"])
        same.append((ta["layer0_ids"] == tb["layer0_ids"]).all(1))
    assert np.concatenate(same).mean() >= 0.995
    r_t = _recall(*meshed.search_batch(Q, 10, 48), X, Q, 10)
    r_j = _recall(*j.search_batch(Q, 10, 48), X, Q, 10)
    assert abs(r_t - r_j) <= 0.005, (r_t, r_j)


def test_mesh_build_keeping_pruned_close_to_reference(four_builds):
    """The sharded cell's build settings (pruned links kept, level scale 0.5)
    set on every shard of the JAX package's ``ShardedHnsw`` over four
    devices: its mesh build of the same points and the port's are as close as
    at the default settings (``test_mesh_build_close_to_reference``)."""
    X, builds = four_builds
    sh = builds["half_kept"][0]
    j = JShardedHnsw(mesh=default_mesh(4), max_elements=len(X) // 4 + 8, **KW)
    for h in j.shards:
        h.set_keeping_pruned(True)
        h.modify_level_scale(0.5)
    j.parallel_insert((X, np.arange(len(X))), mode="mesh", batch_size=128)
    same = []
    for a, b in zip(sh.shards, j.shards):
        ta, tb = to_arrays(a), to_arrays(b)
        np.testing.assert_array_equal(ta["_level"], tb["_level"])
        same.append((ta["layer0_ids"] == tb["layer0_ids"]).all(1))
    assert np.concatenate(same).mean() >= 0.995
    Q = np.random.default_rng(0x5C).random((24, 16)).astype(np.float32)
    r_t = _recall(*sh.search_batch(Q, 10, 48), X, Q, 10)
    r_j = _recall(*j.search_batch(Q, 10, 48), X, Q, 10)
    assert abs(r_t - r_j) <= 0.005, (r_t, r_j)


def test_mesh_build_through_programs(meshed, jmeshed, data, monkeypatch):
    """The mesh build through every shard's round programs (stub graphs that
    run nothing at capture and the piece at each replay) writes the eager
    mesh build's graphs bit for bit, and so is as close to the JAX package's
    mesh build: equal levels, >= 99.5% of layer-0 rows identical."""
    monkeypatch.setattr(program, "Piece", DeferredPiece)
    X, _ = data
    graphs, made = [], []
    sh = _sharded(len(X))
    with rounds_through(graphs, made):
        sh.parallel_insert((X, np.arange(len(X))), mode="mesh", batch_size=128)
    assert len(made) == D and graphs
    assert all(s["rounds_replayed"] > 0 and s["first_runs"] == s["keys"]
               for s in sh._round_stats)
    same = []
    for a, b, j in zip(sh.shards, meshed.shards, jmeshed.shards):
        ta, tb, tj = to_arrays(a), to_arrays(b), to_arrays(j)
        for k in ta:
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
        np.testing.assert_array_equal(ta["_level"], tj["_level"])
        same.append((ta["layer0_ids"] == tj["layer0_ids"]).all(1))
    assert np.concatenate(same).mean() >= 0.995


@pytest.mark.parametrize("budget", ["between_keys", "below_every_key"])
def test_mesh_build_uncaptured_within_shard_share(meshed, data, monkeypatch, budget):
    """The mesh build with each shard's share too small for some keys (the
    constructions' measured peak above the budget, the other parts' below)
    or for all: the refused keys run uncaptured on every shard, interleaved
    chunk by chunk with the shards' graphs, nothing raises, and every shard
    writes the eager mesh build's graph bit for bit."""
    monkeypatch.setattr(program, "Piece", DeferredPiece)
    _peaks_by_kind(monkeypatch, {"build": 1000})
    monkeypatch.setattr(program.BuildPrograms, "_budget",
                        lambda self: 500.0 if budget == "between_keys" else -1.0)
    X, _ = data
    graphs, made = [], []
    sh = _sharded(len(X))
    with rounds_through(graphs, made):
        sh.parallel_insert((X, np.arange(len(X))), mode="mesh", batch_size=128)
    assert len(made) == D
    for s in sh._round_stats:
        assert s["uncaptured_keys"] > 0 and s["first_runs"] == s["keys"]
        if budget == "between_keys":
            assert 0 < s["uncaptured_keys"] < s["keys"] and s["captures"] > 0
            assert set(s["uncaptured"]) == {"build"}
        else:
            assert s["captures"] == 0 and s["rounds_replayed"] == 0
    assert bool(graphs) == (budget == "between_keys")
    for a, b in zip(sh.shards, meshed.shards):
        ta, tb = to_arrays(a), to_arrays(b)
        for k in ta:
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def test_search_and_exact_on_same_graphs(meshed, data, mesh8):
    """The port's shards carried into the JAX package's ``ShardedHnsw``: the
    codec search reaches recall within 0.01 of the JAX search (the codec's
    traversal scores differ, a recorded departure), and the exact search
    answers the same id sets in the packed-scan mode (the JAX kernel
    interpreted, the port's plain scan) and in the tiled mode."""
    X, Q = data
    j = _carried(meshed, mesh8)
    meshed.set_traversal_codec("i8")
    j.set_traversal_codec("i8")
    try:
        r_t = _recall(*meshed.search_batch(Q, 10, 48), X, Q, 10)
        r_j = _recall(*j.search_batch(Q, 10, 48), X, Q, 10)
    finally:
        meshed.set_traversal_codec("auto")
    assert abs(r_t - r_j) <= 0.01, (r_t, r_j)
    for mode in ("pallas", "tiled"):
        it, dt = meshed.exact_search_batch(Q, 10, mode=mode)
        ij, dj = j.exact_search_batch(Q, 10, mode=mode)
        for b in range(len(Q)):
            assert set(it[b].tolist()) == set(ij[b].tolist()), (mode, b)
        np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["serial", "meshed"])
def test_shard_snapshots_match_the_reference_state(request, mesh8, which):
    """Each shard's snapshot, a ``GraphArrays`` (``GraphArrays.shards`` from
    the host shards, or seeded by the mesh build from its own device tables),
    holds what the JAX package's stacked state holds for that shard: its
    vectors and squared norms, every layer's ids and its entry, on the one
    geometry of all shards (``cap1``, the layer count, the union of the
    non-empty layers, the highest entry level), with no pivot set."""
    sh = request.getfixturevalue(which)
    st, ref = sh.searcher(), _carried(sh, mesh8)._build_state()
    assert st.cap1 == ref.cap1 and len(st.graphs) == D
    for s, g in enumerate(st.graphs):
        assert isinstance(g, GraphArrays) and g.pivot_ids is None and g.layer_dists == ()
        assert (g.cap1, g.num_layers, g.layer_nonempty, g.entry_level) == (
            ref.cap1, ref.num_layers, tuple(ref.layer_nonempty), ref.entry_level)
        assert g.n == sh.shards[s]._nb_point and g.entry == int(np.asarray(ref.entry)[s])
        assert g.vectors.dtype == torch.float32
        np.testing.assert_array_equal(g.vectors.numpy(), np.asarray(ref.vectors)[s])
        np.testing.assert_allclose(g.sqnorms.numpy(), np.asarray(ref.sqnorms)[s], rtol=1e-6)
        for a, b in zip(g.layer_ids, ref.layer_ids, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b)[s])


def test_sharded_codec_is_the_one_card_codec_without_id_rows(meshed, mesh8):
    """Each shard's codec is ``BeamCodec.build`` on its snapshot with no id
    rows (kernel B3's layout), and its bytes are the JAX package's sharded
    codec's: at a table width of 24, a multiple of 8 (the JAX codec pads
    nothing), equal blocks on every shard, and scales and squared norms
    within an ulp (XLA rounds the division by 127 and the product with the
    squared scale its own way)."""
    j = _carried(meshed, mesh8)
    meshed.set_traversal_codec("i8")
    j.set_traversal_codec("i8")
    try:
        blocks, bsq, scale, M0, dim = meshed.device_codec_arrays()
        codecs = meshed._codecs()
        jb, jq, js, jM0, jdim = j.device_codec_arrays()
    finally:
        meshed.set_traversal_codec("auto")
    assert (M0, dim) == (jM0, jdim) == (24, 16)
    jb, jq, js = np.asarray(jb), np.asarray(jq), np.asarray(js)
    for s, c in enumerate(codecs):
        assert c.id_rows == 0 and c.blocks is blocks[s] and c.M0 == M0
        assert c.blocks.shape == (meshed.searcher().cap1, M0, dim)
        np.testing.assert_array_equal(blocks[s].numpy(), jb[s])
        np.testing.assert_allclose(bsq[s].numpy(), jq[s], rtol=3e-7, atol=0)
        np.testing.assert_allclose(scale[s].numpy(), js[s].reshape(()), rtol=3e-7, atol=0)


def test_mesh_build_records_no_shard_spans(data, monkeypatch):
    """The mesh build's rounds run through the search's lockstep loop
    (``_lockstep``, on round programs of stub graphs) and record none of
    its spans or counters, which the search alone records: ``shard.steps``
    and ``shard.idle_steps`` (``straggler_pct.cards``) and ``shard.poll``
    (``lockstep_ms.cards``)."""
    monkeypatch.setattr(program, "Piece", DeferredPiece)
    real, traced = sharded._lockstep, []

    def watched(*args, **kw):
        traced.append(kw.get("traced", False))
        return real(*args, **kw)

    monkeypatch.setattr(sharded, "_lockstep", watched)
    X, Q = data
    sh = ShardedHnsw(n_shards=4, device="cpu", max_elements=208, **KW)
    PROFILER.reset()
    enable_profiling()
    try:
        with rounds_through([]):
            sh.parallel_insert((X[:800], np.arange(800)), mode="mesh", batch_size=128)
        built = ({e.name for e in PROFILER.events()}, PROFILER.report().get("counters", {}))
        n_build = len(traced)
        sh.search_batch(Q, 10, 48)
        searched = ({e.name for e in PROFILER.events()}, PROFILER.report()["counters"])
    finally:
        enable_profiling(False)
        PROFILER.reset()
    assert n_build > 0 and not any(traced[:n_build]) and traced[n_build:] == [True]
    assert not any(n.startswith("shard.") for n in built[0])
    assert not any(n.startswith("shard.") for n in built[1])
    assert {"shard.start", "shard.step", "shard.poll", "shard.merge"} <= searched[0]
    assert searched[1]["shard.steps"] > 0


def test_manifests_cross_reload(serial, data, mesh8, tmp_path):
    """Each package reloads the other's sharded dump (``hnsw_tpu.sharded.v1``)
    to the graphs that were dumped, and answers as the dumping index."""
    X, Q = data
    j = _carried(serial, mesh8)
    serial.file_dump(tmp_path, "port")
    j.file_dump(tmp_path, "ref")
    jr = JShardedHnsw.load(tmp_path, "port", mesh=mesh8, max_elements=len(X) // D + 8, **KW)
    tr = ShardedHnsw.load(tmp_path, "ref", device="cpu", max_elements=len(X) // D + 8, **KW)
    assert tr.n_shards == jr.n_shards == D
    for s in range(D):
        assert serial.shards[s].check_graph_equality(jr.shards[s])
        assert j.shards[s].check_graph_equality(tr.shards[s])
    np.testing.assert_array_equal(tr.search_batch(Q, 5, 32)[0], serial.search_batch(Q, 5, 32)[0])
    np.testing.assert_array_equal(jr.search_batch(Q, 5, 32)[0], j.search_batch(Q, 5, 32)[0])
