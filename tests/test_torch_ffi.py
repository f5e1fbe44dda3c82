"""The port's native C++ tier (``hnsw_tpu_torch/ffi``): the cases of
``tests/test_ffi.py`` against the port's ``Hnsw``, and what the port adds —
its sources are byte-equal copies of the JAX package's, its library is its
own under ``build/hnsw_tpu_torch/``, its native dump is byte-equal to the JAX
package's and each package reloads the other's, the native and the Python
reload routes give the same tables (widths included), and the routing raises
instead of falling back where g++ exists. Threads are capped at 2: the tier-1
run has six workers on one host."""

import filecmp
import pathlib
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

ROOT = pathlib.Path(__file__).resolve().parents[1]
NT = 2  # native threads per call


@pytest.fixture(scope="module")
def native():
    from hnsw_tpu_torch.ffi import NativeHnsw, native_lib
    native_lib()
    return NativeHnsw


def _data(rng, n=2000, d=24):
    # low intrinsic dimension so recall is meaningful
    A = rng.standard_normal((8, d)).astype(np.float32)
    return rng.standard_normal((n, 8)).astype(np.float32) @ A


def test_native_build_and_recall(native, rng):
    from hnsw_tpu_torch import get_metric
    X = _data(rng)
    nh = native(max_nb_connection=16, max_elements=len(X), ef_construction=200)
    nh.parallel_insert(X, np.arange(len(X)), n_threads=NT)
    assert len(nh) == len(X)
    Q = _data(rng, n=40)
    ids, dists = nh.parallel_search(Q, 10, 64, n_threads=NT)
    truth = get_metric("L2").brute_force(Q, X)
    hits = sum(int((dists[b][np.isfinite(dists[b])] <= np.sort(truth[b])[9] + 1e-6).sum())
               for b in range(40))
    assert hits / 400 >= 0.9, hits / 400


def test_native_serial_insert_and_search(native, rng):
    X = _data(rng, n=300)
    nh = native(max_nb_connection=12, max_elements=300, ef_construction=100)
    for i, v in enumerate(X):
        nh.insert(v, i)
    ids, dists = nh.search(X[7], 3, 32)
    assert ids[0] == 7 and dists[0] == pytest.approx(0.0, abs=1e-5)


def test_native_filter(native, rng):
    X = _data(rng, n=400)
    nh = native(max_nb_connection=12, max_elements=400, ef_construction=100)
    nh.parallel_insert(X, np.arange(400), n_threads=NT)
    ids, _ = nh.search(X[10], 5, 200, filter_fn=lambda i: i % 3 == 0)
    assert len(ids) >= 1 and all(i % 3 == 0 for i in ids)
    ids, _ = nh.search(X[10], 5, 64, filter_fn=lambda i: False)
    assert len(ids) == 0


def test_native_custom_distance(native, rng):
    X = np.abs(_data(rng, n=200)).astype(np.float32)
    nh = native(max_nb_connection=8, max_elements=200, ef_construction=50,
                dist_fn=lambda a, b: float(np.abs(a - b).sum()))
    for i, v in enumerate(X):
        nh.insert(v, i)
    ids, dists = nh.search(X[3], 2, 16)
    assert ids[0] == 3
    assert dists[0] == pytest.approx(0.0, abs=1e-4)


def test_native_to_hnsw_handoff(native, rng, tmp_path):
    """A natively built graph serves the port: host search, batched search on
    the device (the CPU here), dump and reload."""
    from hnsw_tpu_torch import HnswIo
    X = _data(rng, n=1500)
    nh = native(max_nb_connection=16, max_elements=1500, ef_construction=150)
    nh.parallel_insert(X, np.arange(1500), n_threads=NT)
    h = nh.to_hnsw(device="cpu")
    assert h.get_nb_point() == 1500 and h.device.type == "cpu"
    res = h.search(X[42], 1, 32)
    assert res and res[0].d_id == 42
    ids, dists = h.search_batch(X[:32], 1, 32)
    hits = sum(1 for i in range(32) if h.get_origin_id(int(ids[i, 0])) == i)
    assert hits >= 30
    base = h.file_dump(tmp_path, "native")
    r = HnswIo(tmp_path, base).load_hnsw(device="cpu")
    assert h.check_graph_equality(r)


def test_native_distance_values_match(native, rng):
    from hnsw_tpu_torch import get_metric
    X = np.abs(_data(rng, n=64)).astype(np.float32)
    X = X / X.sum(-1, keepdims=True)
    for name in ["L1", "L2", "Cosine", "Hamming", "Jaccard", "Hellinger",
                 "Jeffreys", "JensenShannon"]:
        nh = native(max_nb_connection=8, max_elements=64, ef_construction=32, dist=name)
        for i, v in enumerate(X):
            nh.insert(v, i)
        ids, dists = nh.search(X[5], 3, 16)
        m = get_metric(name)
        for j, i in enumerate(ids):
            want = m.pair(X[5], X[int(i)])
            assert dists[j] == pytest.approx(want, rel=2e-3, abs=2e-3), name


def test_native_typed_elements(native, rng):
    """Element-type parity with the reference's per-type FFI (u8/u16/u32/i32/f64)."""
    for dt, dist in [(np.uint8, "L1"), (np.uint16, "Levenshtein"), (np.uint32, "Jaccard"),
                     (np.int32, "L2"), (np.float64, "L2")]:
        n = 80
        if dt == np.uint16 and dist == "Levenshtein":
            X = rng.integers(97, 123, (n, 8)).astype(dt)
        elif np.issubdtype(dt, np.integer):
            X = rng.integers(0, 100, (n, 12)).astype(dt)
        else:
            X = rng.random((n, 12)).astype(dt)
        nh = native(max_nb_connection=8, max_elements=n, ef_construction=40,
                    dist=dist, dtype=dt)
        for i, v in enumerate(X):
            nh.insert(v, i)
        ids, dists = nh.search(X[5], 3, 16)
        assert ids[0] == 5, (dt, dist, ids)
        assert dists[0] == pytest.approx(0.0, abs=1e-5)
        h = nh.to_hnsw(device="cpu")
        assert h.dtype == np.dtype(dt)
        assert h.search(X[5], 1, 16)[0].d_id == 5


def test_native_dump_load_roundtrip(native, rng, tmp_path):
    """A native dump reloads natively and through the port's Python reader
    (one file format across the tiers), and the other way round."""
    from hnsw_tpu_torch import HnswIo
    X = _data(rng, n=400)
    nh = native(max_nb_connection=12, max_elements=400, ef_construction=100)
    nh.parallel_insert(X, np.arange(400), n_threads=NT)
    nh.file_dump(tmp_path, "nativedump")
    r = native.load(tmp_path, "nativedump")
    assert len(r) == 400
    ids, dists = r.search(X[7], 3, 32)
    assert ids[0] == 7
    hp = HnswIo(tmp_path, "nativedump").load_hnsw(device="cpu")
    assert hp.get_nb_point() == 400
    assert hp.search(X[7], 1, 32)[0].d_id == 7
    assert nh.to_hnsw(device="cpu").check_graph_equality(hp)
    hp.file_dump(tmp_path, "pydump")
    r2 = native.load(tmp_path, "pydump")
    assert len(r2) == 400
    assert r2.search(X[7], 1, 32)[0][0] == 7


def test_native_load_recovers_header_metadata(native, rng, tmp_path):
    """A loaded handle carries the dump's M, efC and metric, so ``to_hnsw()``
    is faithful."""
    X = rng.random((120, 10)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    nh = native(max_nb_connection=10, max_elements=120, ef_construction=48, dist="Cosine")
    for i, v in enumerate(X):
        nh.insert(v, i)
    nh.file_dump(tmp_path, "metaload")
    r = native.load(tmp_path, "metaload")
    assert r.M == 10 and r.ef_construction == 48 and r.dist_name == "Cosine"
    h = r.to_hnsw(device="cpu")
    assert h.metric.name == "Cosine" and h.max_nb_connection == 10
    assert h.search(X[3], 1, 24)[0].d_id == 3


def test_native_parallel_insert_multi_batch_stress(native, rng):
    """Repeated threaded batches keep all storage consistent."""
    d = 16
    nh = native(max_nb_connection=12, max_elements=64, ef_construction=64)
    X = rng.random((900, d)).astype(np.float32)
    for lo in range(0, 900, 300):
        nh.parallel_insert(X[lo:lo + 300], np.arange(lo, lo + 300), n_threads=NT)
        assert len(nh) == lo + 300
    ids, dists = nh.parallel_search(X[::90], 1, 32, n_threads=NT)
    assert [int(i) for i in ids[:, 0]] == list(range(0, 900, 90))
    assert nh.to_hnsw(device="cpu").get_nb_point() == 900


def test_native_description_and_graph_only_load(native, rng, tmp_path):
    """Header introspection through the C ABI, and the NoData reload."""
    from hnsw_tpu_torch.ffi import load_hnsw_description
    X = rng.random((150, 12)).astype(np.float32)
    nh = native(max_nb_connection=9, max_elements=150, ef_construction=40, dist="L1")
    for i, v in enumerate(X):
        nh.insert(v, i)
    nh.file_dump(tmp_path, "descffi")
    d = load_hnsw_description(tmp_path, "descffi")
    assert d.format_version == 4 and d.dumpmode == 1
    assert d.max_nb_connection == 9 and d.ef_construction == 40
    assert d.nb_point == 150 and d.dimension == 12
    assert d.t_name == b"f32" and b"DistL1" in d.distname
    with pytest.raises(IOError):
        load_hnsw_description(tmp_path, "no-such-dump")
    g = native.load_graph_only(tmp_path, "descffi")
    assert len(g) == 150 and g.dist_name == "L1" and g.M == 9
    ids, dd = g.search(X[0], 3, 16)
    assert len(ids) == 0  # no data: a search answers nothing
    full = native.load(tmp_path, "descffi").to_hnsw(device="cpu")
    assert g.to_hnsw(device="cpu").check_graph_equality(full)


def test_native_ptrdist_dump_reload(native, rng, tmp_path):
    """A DistPtr dump does not load without its function (never a quiet L2),
    and reloads with it."""
    X = np.abs(_data(rng, n=150)).astype(np.float32)

    def manhattan(a, b):
        return float(np.abs(a - b).sum())

    nh = native(max_nb_connection=10, max_elements=len(X), ef_construction=64,
                dist_fn=manhattan)
    nh.parallel_insert(X, np.arange(len(X)), n_threads=NT)
    nh.file_dump(tmp_path, "ptrd")
    with pytest.raises(IOError):
        native.load(tmp_path, "ptrd")
    r = native.load_ptrdist(tmp_path, "ptrd", manhattan)
    assert len(r) == len(X)
    ids, dists = r.search(X[13], 3, 48)
    assert ids[0] == 13 and dists[0] == pytest.approx(0.0, abs=1e-5)
    assert dists[1] == pytest.approx(manhattan(X[13], X[int(ids[1])]), rel=1e-4)


def test_native_reload_keeps_metric(native, rng, tmp_path):
    from hnsw_tpu_torch import l2_normalize
    X = l2_normalize(_data(rng, n=200))
    nh = native(max_nb_connection=10, max_elements=len(X), ef_construction=64, dist="Dot")
    nh.parallel_insert(X, np.arange(len(X)), n_threads=NT)
    nh.file_dump(tmp_path, "dotd")
    r = native.load(tmp_path, "dotd")
    assert r.dist_name == "Dot"
    ids, dists = r.search(X[3], 3, 48)
    assert dists[1] == pytest.approx(1.0 - float(X[int(ids[1])] @ X[3]), rel=1e-4, abs=1e-5)


def test_native_from_hnsw_round_trip(native, rng):
    """The flat-array import is the inverse of ``to_hnsw``."""
    from hnsw_tpu_torch import Hnsw
    X = _data(rng, n=250)
    h = Hnsw(max_nb_connection=10, max_elements=len(X), ef_construction=80, device="cpu")
    for i, v in enumerate(X):
        h.insert(v, i)
    nh = native.from_hnsw(h)
    assert len(nh) == len(X)
    ids, dists = nh.search(X[42], 3, 48)
    assert ids[0] == 42 and dists[0] == pytest.approx(0.0, abs=1e-5)
    assert h.check_graph_equality(nh.to_hnsw(device="cpu"))


def test_native_log_init(native, capfd):
    from hnsw_tpu_torch import init_native_log
    init_native_log(2)
    try:
        nh = native(max_nb_connection=8, max_elements=64, ef_construction=32)
        nh.parallel_insert(np.random.default_rng(0).random((64, 8)).astype(np.float32),
                           np.arange(64), n_threads=1)
        assert "[hnsw_core]" in capfd.readouterr().err
    finally:
        init_native_log(0)


# ------------------------------------------------------------ the port's own --------

@pytest.mark.parametrize("name", ["hnsw_core.cpp", "hnsw_tpu.h"])
def test_sources_are_copies_of_reference(name):
    assert filecmp.cmp(ROOT / "hnsw_tpu_torch" / "ffi" / name,
                       ROOT / "hnsw_tpu" / "ffi" / name, shallow=False)


def test_library_is_the_ports_own(native):
    from hnsw_tpu_torch.ffi import lib_path, native_lib
    from hnsw_tpu_torch.ops.kernel_lib import BUILD_DIR
    path = pathlib.Path(native_lib()._name).resolve()
    assert path.parent == BUILD_DIR.resolve() == ROOT / "build" / "hnsw_tpu_torch"
    assert path == lib_path().resolve() and path.name.startswith("libhnsw_core-")


@pytest.fixture(scope="module")
def built():
    """A device build of 5200 points in the port (above
    ``NATIVE_IO_MIN_POINTS``, so dumps and reloads take the native route)."""
    from hnsw_tpu_torch import Hnsw
    X = _data(np.random.default_rng(5), n=5200, d=16)
    h = Hnsw(max_nb_connection=6, max_elements=len(X), ef_construction=32, device="cpu")
    h._auto_repair = False
    h.parallel_insert(X, mode="device", batch_size=1024)
    return h


def _widened(h, rng):
    """A copy of ``h`` whose layer 0 carries reserve columns as the
    navigability repair grows them (to a multiple of 8 past 2*M: 24), with
    rows of up to 17 links."""
    from hnsw_tpu_torch import from_arrays, to_arrays
    from hnsw_tpu_torch.convert import params_of
    w = from_arrays(to_arrays(h), params_of(h), device="cpu")
    n, t = w._nb_point, w._layers[0]
    t.grow_width(24)
    for k, r in enumerate(np.flatnonzero(t.counts[:n] == 12)[:40]):
        cand = [int(e) for e in rng.permutation(n)[:32] if e != r and e not in t.ids[r, :12]]
        extra = np.array(cand[:3 + k % 3])
        ids = np.concatenate([t.ids[r, :12], extra]).astype(np.int32)
        dd = np.concatenate([t.dists[r, :12],
                             w._pair_dists(np.full(len(extra), r), extra)]).astype(np.float32)
        o = np.argsort(dd, kind="stable")
        t.set_row(r, ids[o], dd[o])
    w._version += 1
    return w


def _tables(h):
    n = h._nb_point
    out = {k: np.array(getattr(h, k)[:n]) for k in ("_origin", "_level", "_rank_in_layer")}
    out["_data"] = np.array(h._data[:n])
    out["entry"] = h._entry
    for l, t in h._layers.items():
        if t.counts[:n].any():
            out[l] = (t.width, t.ids[:n].copy(), t.dists[:n].copy(), t.counts[:n].copy())
    return out


def test_native_dump_equals_reference_and_cross_reload(built, tmp_path, monkeypatch):
    """The port's native dump of a graph is byte-equal to the JAX package's
    dump of the same graph carried across, and each package reloads the
    other's dump to the graph it dumped (the port on its native route). The
    JAX side runs with ``HNSW_TPU_NATIVE_IO=0`` (its Python writer and reader,
    which its own tests hold byte-equal to its native tier): its library
    builds in place, and ``tests/test_ffi.py`` building it in another worker
    at the same moment would race."""
    import hnsw_tpu as J
    from test_torch_build import jax_from_state
    from hnsw_tpu_torch import HnswIo, to_arrays
    from hnsw_tpu_torch.io import hnswio
    hj = jax_from_state(to_arrays(built), built)
    before = dict(hnswio.ROUTES)
    bt = built.file_dump(tmp_path, "port")
    assert hnswio.ROUTES["file_dump.native"] == before["file_dump.native"] + 1
    monkeypatch.setenv("HNSW_TPU_NATIVE_IO", "0")
    bj = hj.file_dump(tmp_path, "ref")
    rj = J.HnswIo(tmp_path, bt).load_hnsw()
    monkeypatch.delenv("HNSW_TPU_NATIVE_IO")
    for ext in (".hnsw.graph", ".hnsw.data"):
        assert filecmp.cmp(tmp_path / (bt + ext), tmp_path / (bj + ext), shallow=False), ext
    rt = HnswIo(tmp_path, bj).load_hnsw(device="cpu")
    assert hnswio.ROUTES["load_hnsw.native"] == before["load_hnsw.native"] + 1
    assert built.check_graph_equality(rt) and hj.check_graph_equality(rj)
    assert rt.check_graph_equality(rj)


def test_native_and_python_reload_routes_equal(built, rng, tmp_path, monkeypatch):
    """A repaired (widened) graph of 5200 points: the native and the Python
    reload of its dump hold equal tables, widths included (the built width,
    the next multiple of 8 past its widest row), and the two routes dump the
    same bytes."""
    from hnsw_tpu_torch import HnswIo
    from hnsw_tpu_torch.io import hnswio
    h = _widened(built, rng)
    assert h._layers[0].width == 24 and h._layers[0].counts.max() > 16
    base = h.file_dump(tmp_path, "native")
    r_native = HnswIo(tmp_path, base).load_hnsw(device="cpu")
    monkeypatch.setenv("HNSW_TPU_NATIVE_IO", "0")
    before = dict(hnswio.ROUTES)
    base_py = h.file_dump(tmp_path, "python")
    r_python = HnswIo(tmp_path, base).load_hnsw(device="cpu")
    assert hnswio.ROUTES["file_dump.python"] == before["file_dump.python"] + 1
    assert hnswio.ROUTES["load_hnsw.python"] == before["load_hnsw.python"] + 1
    for ext in (".hnsw.graph", ".hnsw.data"):
        assert filecmp.cmp(tmp_path / (base + ext), tmp_path / (base_py + ext),
                           shallow=False), ext
    a, b = _tables(r_native), _tables(r_python)
    assert a.keys() == b.keys()
    for k in a:
        for x, y in zip(a[k] if isinstance(a[k], tuple) else (a[k],),
                        b[k] if isinstance(b[k], tuple) else (b[k],)):
            np.testing.assert_array_equal(x, y, err_msg=str(k))
    assert r_native._layers[0].width == 24
    assert h.check_graph_equality(r_native)
    assert (r_native.extend_candidates, r_native.keep_pruned) == (True, False)


def test_native_route_raises_instead_of_falling_back(built, tmp_path, monkeypatch):
    """With g++ present a failing native reload raises; below the threshold
    the Python route runs."""
    from hnsw_tpu_torch import HnswIo
    from hnsw_tpu_torch.ffi import NativeHnsw
    from hnsw_tpu_torch.io import hnswio
    base = built.file_dump(tmp_path, "big")

    def broken(*a, **k):
        raise IOError("native load failed")
    monkeypatch.setattr(NativeHnsw, "load", classmethod(broken))
    with pytest.raises(IOError, match="native load failed"):
        HnswIo(tmp_path, base).load_hnsw(device="cpu")
    monkeypatch.setattr(hnswio, "NATIVE_IO_MIN_POINTS", len(built) + 1)
    before = hnswio.ROUTES["load_hnsw.python"]
    assert built.check_graph_equality(HnswIo(tmp_path, base).load_hnsw(device="cpu"))
    assert hnswio.ROUTES["load_hnsw.python"] == before + 1
