"""Graph snapshot, int8 codec and entry pivots of the PyTorch port against the
JAX package, on one graph built by the JAX package and carried across with
``hnsw_tpu_torch.from_arrays``."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp
import jax.lax as lax

import hnsw_tpu.ops.graph_arrays as jga
import hnsw_tpu_torch.ops.graph_arrays as tga
from hnsw_tpu import Hnsw as JHnsw
from hnsw_tpu_torch import from_arrays, to_arrays
from hnsw_tpu_torch.convert import params_of


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(0xC0DEC)
    X = rng.standard_normal((300, 128)).astype(np.float32)
    hj = JHnsw(max_nb_connection=8, max_elements=300, ef_construction=48, dist="L2")
    hj.parallel_insert(X, mode="serial")
    ht = from_arrays(to_arrays(hj), params_of(hj), device="cpu")
    return hj, ht


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.array(x)


def test_state_round_trip(graphs):
    hj, ht = graphs
    a, b = to_arrays(hj), to_arrays(ht)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
    assert hj.check_graph_equality(ht) and ht.check_graph_equality(hj)


def test_graph_arrays_equal(graphs):
    hj, ht = graphs
    gj, gt = hj.device_graph(), ht.device_graph()
    assert gj.cap1 == gt.cap1 and gj.layer_nonempty == gt.layer_nonempty
    np.testing.assert_array_equal(_np(gt.vectors), _np(gj.vectors))
    # |v|^2 reductions may sum in different orders: f32 rounding only
    np.testing.assert_allclose(_np(gt.sqnorms), _np(gj.sqnorms), rtol=1e-6)
    np.testing.assert_array_equal(_np(gt.levels), _np(gj.levels))
    assert len(gt.layer_ids) == len(gj.layer_ids)
    for a, b in zip(gt.layer_ids, gj.layer_ids):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert int(gt.entry) == int(gj.entry)


@pytest.mark.parametrize("metric", ["L2", "Cosine"])
def test_beam_codec_byte_equal(graphs, metric):
    hj, ht = graphs
    gj, gt = hj.device_graph(), ht.device_graph()
    if metric != "L2":
        gj = jga.GraphArrays(**{**gj.__dict__, "metric_name": metric})
        gt = tga.GraphArrays(**{**gt.__dict__, "metric_name": metric})
    cj = jga.BeamCodec.build(gj, kind="i8")
    ct = tga.BeamCodec.build(gt, kind="i8")
    assert (ct.M0, ct.id_rows, ct.dim) == (cj.M0, cj.id_rows, cj.dim)
    assert ct.id_rows > 0 and ct.blocks.shape == tuple(cj.blocks.shape)
    assert _np(ct.blocks).tobytes() == _np(cj.blocks).tobytes()
    assert _np(ct.blocks_sq).tobytes() == _np(cj.blocks_sq).tobytes()
    assert np.float32(_np(ct.scale)).tobytes() == np.float32(_np(cj.scale)).tobytes()
    # the trailing id rows decode back to the layer table
    idcap = ct.id_rows * ct.dim // 4
    raw = ct.blocks[:, ct.M0:, :].reshape(ct.blocks.shape[0], idcap * 4)
    ids = raw.contiguous().view(torch.int32)[:, :ct.M0]
    np.testing.assert_array_equal(ids.numpy(), _np(gt.layer_ids[0])[:, :ct.M0])


def test_codec_without_id_rows_is_the_codec_less_its_id_rows(graphs):
    """``with_ids=False`` (the sharded tier's codec, kernel B3's layout)
    builds the one-card codec's vector rows, squared norms and scale, and no
    id rows."""
    _, ht = graphs
    g = ht.device_graph()
    full = tga.BeamCodec.build(g, kind="i8")
    bare = tga.BeamCodec.build(g, kind="i8", with_ids=False)
    assert full.id_rows > 0 and bare.id_rows == 0 and (bare.M0, bare.dim) == (full.M0, full.dim)
    assert bare.blocks.shape == (g.cap1, full.M0, full.dim)
    assert torch.equal(bare.blocks, full.blocks[:, :full.M0])
    assert torch.equal(bare.blocks_sq, full.blocks_sq) and torch.equal(bare.scale, full.scale)


def test_codec_kind_rules():
    """``codec_kind``, which the one-card and the sharded codec both ask: no
    codec without a kind or for a metric the codec does not serve; under
    "auto" int8 from CODEC_MIN_POINTS points up while the caller's estimate
    fits CODEC_MAX_BYTES (asked only past the point count), so at the
    benchmark's shapes, sift1m on one card and sift4m over four shards, both
    decline; any other kind as given."""
    asked = []

    def est(nbytes):
        return lambda: asked.append(nbytes) or nbytes

    assert tga.codec_kind(None, "L2", 10**6, est(0)) is None
    assert tga.codec_kind("i8", "Hamming", 10**6, est(0)) is None
    assert tga.codec_kind("bf16", "L2", 10, est(0)) == "bf16"
    assert tga.codec_kind("auto", "L2", tga.CODEC_MIN_POINTS - 1, est(0)) is None
    assert asked == []
    assert tga.codec_kind("auto", "Cosine", tga.CODEC_MIN_POINTS,
                          est(tga.CODEC_MAX_BYTES)) == "i8"
    assert tga.codec_kind("auto", "L2", tga.CODEC_MIN_POINTS,
                          est(tga.CODEC_MAX_BYTES + 1)) is None
    cap1 = 1_000_009
    assert tga.codec_kind("auto", "L2", 10**6, est(cap1 * (96 + 8) * 128)) is None
    assert tga.codec_kind("auto", "L2", 4 * 10**6, est(4 * cap1 * 96 * 128)) is None


def test_snapshot_uploads_distances_only_with_dists(graphs):
    _, ht = graphs
    g = tga.GraphArrays.from_host(ht)
    assert g.layer_dists == ()
    gd = tga.GraphArrays.from_host(ht, with_dists=True)
    assert len(gd.layer_dists) == len(gd.layer_ids) == len(g.layer_ids)
    n = ht._nb_point
    for l, (ids, dd) in enumerate(zip(gd.layer_ids, gd.layer_dists)):
        t = ht._layers[l]
        assert torch.equal(ids, g.layer_ids[l]) and dd.shape == ids.shape
        np.testing.assert_array_equal(dd[:n, :t.width].numpy(), t.dists[:n])
        assert torch.isinf(dd[n:]).all()


def test_compute_pivots_equal(graphs, monkeypatch):
    """With PIVOT_MIN_POINTS lowered in both packages, both pick the same
    entry-pivot set (the pivot entry production uses)."""
    hj, ht = graphs
    monkeypatch.setattr(jga, "PIVOT_MIN_POINTS", 1)
    monkeypatch.setattr(tga, "PIVOT_MIN_POINTS", 1)
    n = hj._nb_point
    pj = jga.compute_pivots(hj, jnp.asarray(hj._layers[0].ids), n)
    pt = tga.compute_pivots(ht, ht._layers[0].ids, n)
    assert pj is not None and pt is not None
    np.testing.assert_array_equal(np.asarray(pt), np.asarray(pj))
    hj._device_cache = ht._device_cache = None
    np.testing.assert_array_equal(_np(ht.device_graph().pivot_ids),
                                  _np(hj.device_graph().pivot_ids))
    hj._device_cache = ht._device_cache = None
