"""Persistence of the PyTorch port (``hnsw_tpu_torch/io``) against the JAX
package's: the same graph dumps to the same bytes (Full and Light), each
package reloads the other's dump and the other's ``.npz``, the hand-assembled
golden fixtures parse and re-emit byte for byte, and the dump-format cases of
``tests/test_io.py`` hold for the port. Comparisons are exact (bytes, integer
tables, float32 distances carried bit for bit) unless a test states otherwise.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import hnsw_tpu as J
import hnsw_tpu_torch as T
from hnsw_tpu_torch.io.datamap import LazyMmapData
from hnsw_tpu_torch.io.hnswio import file_dump as t_file_dump

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
EXTS = (".hnsw.graph", ".hnsw.data")


def _build_pair(rng, n=300, d=8, dist="L2", dtype=np.float32, M=12):
    """The same points inserted serially into both packages' host oracles."""
    if np.dtype(dtype) == np.uint8:
        X = rng.integers(0, 255, (n, d)).astype(np.uint8)
    else:
        X = rng.random((n, d)).astype(dtype)
    kw = dict(max_nb_connection=M, max_elements=n, ef_construction=100, dist=dist,
              dtype=dtype)
    ht, hj = T.Hnsw(device="cpu", **kw), J.Hnsw(**kw)
    for i, v in enumerate(X):
        ht.insert(v, i)
        hj.insert(v, i)
    return ht, hj, X


def _build(rng, n=300, d=8, dist="L2"):
    X = rng.random((n, d)).astype(np.float32)
    h = T.Hnsw(max_nb_connection=12, max_elements=n, ef_construction=100, dist=dist,
               device="cpu")
    for i, v in enumerate(X):
        h.insert(v, i)
    return h, X


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _tables_equal(a, b):
    """Internal arrays equal index for index (two reloads of one dump)."""
    n = a.get_nb_point()
    assert n == b.get_nb_point() and a._entry == b._entry
    for k in ("_origin", "_level", "_rank_in_layer"):
        np.testing.assert_array_equal(getattr(a, k)[:n], getattr(b, k)[:n])
    np.testing.assert_array_equal(np.asarray(a._data[:n]), np.asarray(b._data[:n]))
    assert sorted(a._layers) == sorted(b._layers)
    for l in a._layers:
        ta, tb = a._layers[l], b._layers[l]
        assert ta.width == tb.width
        np.testing.assert_array_equal(ta.ids[:n], tb.ids[:n])
        np.testing.assert_array_equal(ta.dists[:n], tb.dists[:n])
        np.testing.assert_array_equal(ta.counts[:n], tb.counts[:n])


@pytest.mark.parametrize("mode", ["Full", "Light"])
def test_dump_bytes_equal_and_cross_reload(rng, tmp_path, monkeypatch, mode):
    """Port dump == JAX-package dump (its Python writer), byte for byte; each
    package reloads the other's files to the tables the other reloads."""
    monkeypatch.setenv("HNSW_TPU_NATIVE_IO", "0")
    ht, hj, X = _build_pair(rng)
    bt = t_file_dump(ht, tmp_path, "port", mode)
    bj = J.file_dump(hj, tmp_path, "ref", mode)
    for ext in EXTS:
        assert _bytes(tmp_path / (bt + ext)) == _bytes(tmp_path / (bj + ext)), ext
    t_from_j = T.HnswIo(tmp_path, bj).load_hnsw(device="cpu")
    j_from_t = J.HnswIo(tmp_path, bt).load_hnsw()
    j_from_j = J.HnswIo(tmp_path, bj).load_hnsw()
    _tables_equal(t_from_j, j_from_t)
    _tables_equal(t_from_j, j_from_j)
    assert ht.check_graph_equality(t_from_j) and hj.check_graph_equality(j_from_t)
    assert t_from_j.extend_candidates and not t_from_j.keep_pruned
    assert t_from_j.get_level_scale() == pytest.approx(ht.get_level_scale())
    q = rng.random(8).astype(np.float32)
    assert ([r.d_id for r in ht.search(q, 5, 32)]
            == [r.d_id for r in t_from_j.search(q, 5, 32)]
            == [r.d_id for r in j_from_t.search(q, 5, 32)])


def test_native_snapshot_crosses_packages(rng, tmp_path):
    """An ``.npz`` of either package loads in the other to equal tables, and
    ``convert.to_arrays`` keeps working on the reloaded index."""
    ht, hj, X = _build_pair(rng, n=180, dist="Cosine")
    pt, pj = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    ht.save_native(pt)
    J.save_native(hj, pj)
    t_from_j = T.load_native(pj, device="cpu")
    j_from_t = J.load_native(pt)
    t_from_t = T.load_native(pt, device="cpu")
    _tables_equal(t_from_j, j_from_t)
    _tables_equal(t_from_t, ht)
    assert ht.check_graph_equality(t_from_j)
    assert t_from_j.get_distance_name() == "Cosine"
    q = rng.random(8).astype(np.float32)
    assert ([x.d_id for x in ht.search(q, 5, 32)]
            == [x.d_id for x in t_from_j.search(q, 5, 32)])
    from hnsw_tpu_torch.convert import params_of
    back = T.from_arrays(T.to_arrays(t_from_t), params_of(t_from_t), device="cpu")
    assert back.check_graph_equality(ht)


def test_golden_v4_parses_and_reemits(tmp_path):
    h = T.HnswIo(FIX, "golden_v4").load_hnsw(device="cpu")
    assert h.get_nb_point() == 3
    assert h.get_distance_name() == "L2"
    assert h.max_nb_connection == 4
    assert sorted(h._origin[:3].tolist()) == [10, 20, 30]
    assert h.get_origin_id(h._entry) == 30
    assert h.get_point_id(h._entry) == (1, 0)
    iA = int(np.flatnonzero(h._origin[:3] == 10)[0])
    ids, dd = h.neighbour_row(iA, 0)
    assert [h.get_origin_id(int(j)) for j in ids] == [20, 30]
    np.testing.assert_allclose(dd, [1.0, 2.0], rtol=1e-6)
    res = h.search(np.array([0.9, 0.1], np.float32), 1, 8)
    assert res[0].d_id == 20
    h.file_dump(tmp_path, "golden_v4")
    for ext in EXTS:
        assert _bytes(tmp_path / ("golden_v4" + ext)) == _bytes(
            os.path.join(FIX, "golden_v4" + ext))


def test_golden_v2_bincode_reload():
    """Legacy format v2 (bincode data records, no level scale in the header)
    equals the v4 graph."""
    h2 = T.HnswIo(FIX, "golden_v2").load_hnsw(device="cpu")
    h4 = T.HnswIo(FIX, "golden_v4").load_hnsw(device="cpu")
    assert T.load_description(os.path.join(FIX, "golden_v2.hnsw.graph")).format_version == 2
    assert h2.check_graph_equality(h4)
    np.testing.assert_allclose(h2._data[:3], h4._data[:3])
    res = h2.search(np.array([0.9, 0.1], np.float32), 1, 8)
    assert res[0].d_id == 20
    with pytest.raises(ValueError, match="datamap"):
        T.HnswIo(FIX, "golden_v2", T.ReloadOptions(datamap=True)).load_hnsw(device="cpu")


def test_dump_reload_equality(rng, tmp_path):
    h, X = _build(rng)
    basename = h.file_dump(tmp_path, "dumpreloadtest")
    reloaded = T.HnswIo(tmp_path, basename).load_hnsw(device="cpu")
    assert h.check_graph_equality(reloaded)
    assert reloaded.get_distance_name() == "L2"
    for i in range(h.get_nb_point()):  # reload stores points in layer order
        np.testing.assert_array_equal(reloaded._data[i], X[reloaded.get_origin_id(i)])
    assert isinstance(reloaded, T.AnnT)


def test_check_graph_equality_bulk_and_rounded(rng, tmp_path):
    """``check_graph_equality`` compares distances to 5 decimals: equal graphs
    pass, a distance moved within its rounding passes, and a moved distance, a
    swapped link, a count or an origin id fail."""
    h, X = _build(rng)
    r = T.HnswIo(tmp_path, h.file_dump(tmp_path, "bulk")).load_hnsw(device="cpu")
    assert h.check_graph_equality(r) and r.check_graph_equality(h)
    t = r._layers[0]
    i = int(np.flatnonzero(t.counts[:r._nb_point] > 1)[0])
    d0 = t.dists[i, 0]
    t.dists[i, 0] = np.nextafter(d0, np.float32(np.inf))
    assert h.check_graph_equality(r)
    t.dists[i, 0] = d0 + np.float32(1e-3)
    assert not h.check_graph_equality(r)
    t.dists[i, 0] = d0
    a, b = t.ids[i, 0], t.ids[i, 1]
    t.ids[i, 0] = t.ids[i, 1] = a
    assert not h.check_graph_equality(r)
    t.ids[i, 1] = b
    t.counts[i] -= 1
    assert not h.check_graph_equality(r)
    t.counts[i] += 1
    r._origin[i], r._origin[i + 1] = r._origin[i + 1], r._origin[i]
    assert not h.check_graph_equality(r)
    r._origin[i], r._origin[i + 1] = r._origin[i + 1], r._origin[i]
    assert h.check_graph_equality(r)


def test_description(rng, tmp_path):
    h, _ = _build(rng, n=50)
    basename = h.file_dump(tmp_path, "descrtest")
    d = T.load_description(tmp_path / (basename + ".hnsw.graph"))
    assert (d.nb_point, d.max_nb_connection, d.dimension) == (50, 12, 8)
    assert d.distname.endswith("DistL2") and d.t_name == "f32"
    assert d.format_version == 4 and d.dumpmode == 1
    assert d.level_scale == pytest.approx(h.get_level_scale())
    assert T.HnswIo(tmp_path, basename).load_description() == d
    assert d.get_typename() == "f32" and d.get_dimension() == 8


def test_graph_only_reload_flatten(rng, tmp_path):
    """FlatNeighborhood before the dump == after a graph-only reload, and ==
    the JAX package's over the same graph (distances within 1e-5, its own
    equality rule)."""
    ht, hj, _ = _build_pair(rng, n=150)
    before = T.FlatNeighborhood(ht)
    basename = ht.file_dump(tmp_path, "graphonly")
    reloaded = T.HnswIo(tmp_path, basename).load_hnsw(graph_only=True, device="cpu")
    after = T.FlatNeighborhood(reloaded)
    assert before == after and len(after) == 150
    assert reloaded.get_distance_name() == "NoDist"
    assert not np.asarray(reloaded._data[:150]).any()  # topology only: no vectors read
    ref = J.FlatNeighborhood(hj)
    for oid in (0, 17, 149):
        got, want = after.get_neighbours(oid), ref.get_neighbours(oid)
        assert [n.d_id for n in got] == [n.d_id for n in want]
        assert after.get_point(oid).p_id == ref.get_point(oid).p_id
    assert after.get_neighbours(99999) is None


def test_reload_then_insert_more(rng, tmp_path):
    h, X = _build(rng, n=200)
    basename = h.file_dump(tmp_path, "grow")
    io = T.HnswIo(tmp_path, basename, T.ReloadOptions(datamap=True, mmap_threshold=100))
    r = io.load_hnsw(device="cpu")
    Y = rng.random((50, 8)).astype(np.float32)
    for j, v in enumerate(Y):
        r.insert(v, 200 + j)
    assert r.get_nb_point() == 250
    old = r.search(X[17], 1, 32)
    assert old and old[0].d_id == 17
    new = r.search(Y[3], 1, 32)
    assert new and new[0].d_id == 203
    b2 = r.file_dump(tmp_path, "grow")
    assert b2 != "grow"  # uniquified, not clobbering the mapped file
    again = T.HnswIo(tmp_path, b2).load_hnsw(device="cpu")
    assert again.get_nb_point() == 250 and r.check_graph_equality(again)


def test_datamap(rng, tmp_path):
    h, X = _build(rng, n=120)
    basename = h.file_dump(tmp_path, "mmaptest")
    dm = T.DataMap(tmp_path, basename, dtype=np.float32)
    assert dm.get_nb_data() == 120 and dm.get_dimension() == 8
    assert dm.check_data_type("f32") and not dm.check_data_type("u16")
    for i in [0, 7, 63, 119]:
        np.testing.assert_array_equal(dm.get_data(i), X[i])
    assert dm.get_data(99999) is None
    ids = list(dm.get_dataid_iter())
    assert sorted(ids) == list(range(120))
    sv = dm.strided_view()
    assert sv.shape == (120, 8)
    np.testing.assert_array_equal(sv[ids.index(17)], X[17])


def test_mmap_threshold_partial_residency(rng, tmp_path):
    h, X = _build(rng, n=300)
    basename = h.file_dump(tmp_path, "residency")
    io = T.HnswIo(tmp_path, basename, T.ReloadOptions(datamap=True, mmap_threshold=32))
    r = io.load_hnsw(device="cpu")
    assert isinstance(r._data, LazyMmapData)
    assert r._data.resident_rows <= 32 and r.datamap_opt
    for i in (3, 77, 250):
        res = r.search(X[i], 1, 64)
        assert res[0].d_id == i and abs(res[0].distance) < 1e-6
    q = rng.random(8).astype(np.float32)
    full = T.HnswIo(tmp_path, basename).load_hnsw(device="cpu")
    assert ([(n.d_id, round(n.distance, 5)) for n in r.search(q, 5, 64)]
            == [(n.d_id, round(n.distance, 5)) for n in full.search(q, 5, 64)])
    before = r._data.resident_rows
    v = rng.random(8).astype(np.float32)
    r.insert(v, 999)
    assert r._data.resident_rows == before + 1
    assert r.search(v, 1, 64)[0].d_id == 999
    # capacity growth through the lazy map, and N-D fancy reads
    for j in range(300):
        r.insert(rng.random(8).astype(np.float32), 2000 + j)
    assert r.get_nb_point() == 601
    assert r._data[np.array([[0, 1], [2, 3]])].shape == (2, 2, 8)
    # the batched search reads the lazy store into its device snapshot
    ids, _ = r.search_batch(X[:8], 1, 64)
    assert [r.get_origin_id(int(i)) for i in ids[:, 0]] == list(range(8))


def test_empty_dump_fails(tmp_path):
    h = T.Hnsw(max_nb_connection=8, max_elements=8, device="cpu")
    with pytest.raises(ValueError):
        h.file_dump(tmp_path, "empty")


def test_distance_mismatch_rejected(rng, tmp_path):
    h, _ = _build(rng, n=60, dist="L2")
    basename = h.file_dump(tmp_path, "mismatch")
    with pytest.raises(ValueError, match="distance mismatch"):
        T.HnswIo(tmp_path, basename).load_hnsw(dist="Cosine", device="cpu")
    r = T.HnswIo(tmp_path, basename).load_hnsw_with_dist(T.get_metric("L2"), device="cpu")
    assert h.check_graph_equality(r)


def test_uint8_roundtrip(rng, tmp_path):
    """uint8 vectors under L1, as the JAX package's test; both dumps equal."""
    ht, hj, X = _build_pair(rng, n=80, d=16, dist="L1", dtype=np.uint8, M=8)
    basename = ht.file_dump(tmp_path, "u8")
    J.file_dump(hj, tmp_path, "u8ref")
    for ext in EXTS:
        assert _bytes(tmp_path / ("u8" + ext)) == _bytes(tmp_path / ("u8ref" + ext))
    r = T.HnswIo(tmp_path, basename).load_hnsw(device="cpu")
    assert r.dtype == np.uint8
    assert T.load_description(tmp_path / "u8.hnsw.graph").t_name == "u8"
    for i in range(80):
        np.testing.assert_array_equal(r._data[i], X[r.get_origin_id(i)])
    assert ht.check_graph_equality(r)


def test_bad_magic_and_truncation(rng, tmp_path):
    h, _ = _build(rng, n=40)
    base = t_file_dump(h, tmp_path, "light", mode="Light")
    p = tmp_path / "bad.hnsw.graph"
    p.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="magic"):
        T.load_description(p)
    graph = _bytes(tmp_path / (base + ".hnsw.graph"))
    data = _bytes(tmp_path / (base + ".hnsw.data"))
    (tmp_path / "trunc.hnsw.graph").write_bytes(graph[:20])
    with pytest.raises((ValueError, EOFError)):
        T.load_description(tmp_path / "trunc.hnsw.graph")
    # cut inside the records: the reader stops instead of reading past the end
    (tmp_path / "cut.hnsw.graph").write_bytes(graph[:len(graph) // 2])
    (tmp_path / "cut.hnsw.data").write_bytes(data)
    with pytest.raises(EOFError):
        T.HnswIo(tmp_path, "cut").load_hnsw(device="cpu")
    (tmp_path / "cutd.hnsw.graph").write_bytes(graph)
    (tmp_path / "cutd.hnsw.data").write_bytes(data[:len(data) // 2])
    with pytest.raises(EOFError):
        T.HnswIo(tmp_path, "cutd").load_hnsw(device="cpu")
    # a flipped point magic
    desc_len = len(graph) - len(graph[graph.index((0x000A676F).to_bytes(4, "little")):])
    broken = bytearray(graph)
    broken[desc_len + 12] ^= 0xFF  # first point record follows the layer header
    (tmp_path / "flip.hnsw.graph").write_bytes(bytes(broken))
    (tmp_path / "flip.hnsw.data").write_bytes(data)
    with pytest.raises(ValueError, match="point magic"):
        T.HnswIo(tmp_path, "flip").load_hnsw(device="cpu")


def test_dump_rejects_m_over_255(tmp_path, rng):
    h = T.Hnsw(max_nb_connection=256, max_elements=8, ef_construction=8, dist="L2",
               device="cpu")
    h.insert(rng.random(4).astype(np.float32), 0)
    with pytest.raises(ValueError, match="max_nb_connection"):
        h.file_dump(tmp_path, "m256")


def test_widened_rows_round_trip(tmp_path):
    """A fabricated 20k-point graph with a layer-0 table wider than 2*M
    (a repaired index) dumps and reloads, both ways, to the same tables in
    layer order; the JAX package's Python reader agrees on a sample."""
    n, d, M, W = 20_000, 16, 12, 32
    rng = np.random.default_rng(0)
    h = T.Hnsw(max_nb_connection=M, max_elements=n, ef_construction=64, device="cpu")
    h._set_dim(d)
    h._ensure_cap(n)
    h._data[:n] = rng.random((n, d), dtype=np.float32)
    h._origin[:n] = rng.permutation(n) + 7
    levels = np.minimum(rng.geometric(0.9, n) - 1, 3).astype(np.int32)
    levels[5] = 3
    h._level[:n] = levels
    for lv in range(4):
        m = np.flatnonzero(levels == lv)
        h._rank_in_layer[m] = rng.permutation(len(m))
        h._layer_npoints[lv] = len(m)
    h._nb_point, h._entry = n, 5
    for l, width in ((0, W), (1, M)):
        t = h._layer_table(l)
        t.grow_width(width)
        cnt = rng.integers(0, width + 1, n).astype(np.int32)
        if l:
            cnt[levels < l] = 0
        sel = np.arange(width)[None, :] < cnt[:, None]
        t.ids[:n] = np.where(sel, rng.integers(0, n, (n, width)), -1)
        t.dists[:n] = np.where(sel, np.sort(rng.random((n, width), dtype=np.float32), 1),
                               np.inf)
        t.counts[:n] = cnt
    h._version += 1
    base = h.file_dump(tmp_path, "wide")
    r = T.HnswIo(tmp_path, base).load_hnsw(device="cpu")
    p = str(tmp_path / "wide.npz")
    h.save_native(p)
    _tables_equal(T.load_native(p, device="cpu"), h)
    order = h._iteration_order()
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    assert r._entry == inv[5] and r._layers[0].width == W
    np.testing.assert_array_equal(r._origin[:n], h._origin[order])
    np.testing.assert_array_equal(r._data[:n], h._data[order])
    for l in (0, 1):
        a, b = h._layers[l], r._layers[l]
        np.testing.assert_array_equal(b.counts[:n], a.counts[order])
        np.testing.assert_array_equal(b.dists[:n], a.dists[order])
        ai = a.ids[order]
        np.testing.assert_array_equal(b.ids[:n], np.where(ai >= 0, inv[np.clip(ai, 0, n - 1)], -1))
    assert sorted(r._layers) == [0, 1]
