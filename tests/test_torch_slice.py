"""The port's two main paths at small size through its public entry points
on the CPU, against the JAX package on the same data: (1) device build, int8
codec with id rows, pivot entry, streamed search, exact scan; (2) dump and
reload both ways, then recall-critical serving from the reloaded index (k
through the pool reservoir, ``allow_fused=False``, ``packed=False``). And the
rules that the port imports neither ``jax`` nor ``hnsw_tpu`` and that its
kernel sources call no finished kernel."""

import ast
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import hnsw_tpu.ops.graph_arrays as jga
import hnsw_tpu_torch.ops.graph_arrays as tga
from hnsw_tpu import Hnsw as JHnsw
from hnsw_tpu.ops.beam_search import device_search_stream as j_stream
from hnsw_tpu_torch import (AutoIndex, BruteForceIndex, Hnsw, HnswIo, IvfFlatIndex,
                            get_metric, load_native)
from hnsw_tpu_torch.ops import scan_topk as st
from hnsw_tpu_torch.ops.beam_search import device_search_stream as t_stream
from hnsw_tpu_torch.bench import f32_dataset

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, D, K = 4096, 128, 10


def _recall(h, ids, X, Q):
    truth = get_metric("L2").brute_force(Q, X)
    hits = 0
    for b in range(len(Q)):
        got = np.asarray(h._origin)[ids[b][ids[b] >= 0]]
        hits += int((truth[b][got] <= np.sort(truth[b])[K - 1] * (1 + 1e-6)).sum())
    return hits / (len(Q) * K)


def test_main_path_small(monkeypatch):
    monkeypatch.setattr(jga, "PIVOT_MIN_POINTS", 1)
    monkeypatch.setattr(tga, "PIVOT_MIN_POINTS", 1)
    X, Q = f32_dataset("gauss", np.random.default_rng(7), N, 64, D, 16)
    recalls = []
    for cls, stream, kw in ((Hnsw, t_stream, {"device": "cpu"}), (JHnsw, j_stream, {})):
        h = cls(max_nb_connection=8, max_elements=N, ef_construction=64, dist="L2", **kw)
        h.set_keeping_pruned(True)
        h.modify_level_scale(0.5)
        h.parallel_insert(X, mode="device", batch_size=512, build_max_iters=48)
        h.set_traversal_codec("i8")
        assert h.device_graph().pivot_ids is not None
        codec = h.device_codec()
        assert codec is not None and codec.id_rows > 0  # kernel B1's layout
        ids, _ = stream(h, Q, K, 64, batch=32, expand=4)
        recalls.append(_recall(h, ids, X, Q))
        if cls is Hnsw:
            ids_b, _ = h.search_batch(Q, K, 64)
            np.testing.assert_array_equal(ids_b, ids)
    r_t, r_j = recalls
    assert r_t >= 0.95, recalls
    assert abs(r_t - r_j) <= 0.01, recalls


def _table_state(h):
    n = h._nb_point
    out = {"origin": h._origin[:n], "level": h._level[:n], "entry": h._entry}
    for l, t in h._layers.items():
        out[l] = (t.width, t.ids[:n], t.dists[:n], t.counts[:n])
    return out


def test_second_path_small(monkeypatch, tmp_path):
    """Build once, dump and reload both ways, serve from the reloads. The
    ``.npz`` reload keeps insertion order, so its tables and answers equal the
    built index's exactly; the reference-format reload stores points in layer
    order, so its answers are compared as external ids."""
    monkeypatch.setattr(jga, "PIVOT_MIN_POINTS", 1)
    monkeypatch.setattr(tga, "PIVOT_MIN_POINTS", 1)
    X, Q = f32_dataset("gauss", np.random.default_rng(7), N, 64, D, 16)
    h = Hnsw(max_nb_connection=8, max_elements=N, ef_construction=64, dist="L2",
             device="cpu")
    h.set_keeping_pruned(True)
    h.modify_level_scale(0.5)
    h.parallel_insert(X, mode="device", batch_size=512, build_max_iters=48)
    h.set_traversal_codec("i8")
    h.save_native(str(tmp_path / "snap.npz"))
    h2 = load_native(str(tmp_path / "snap.npz"), device="cpu")
    h3 = HnswIo(tmp_path, h.file_dump(tmp_path, "slice")).load_hnsw(device="cpu")
    a, b = _table_state(h), _table_state(h2)
    assert a.keys() == b.keys()
    for k in a:
        for x, y in zip(a[k] if isinstance(a[k], tuple) else (a[k],),
                        b[k] if isinstance(b[k], tuple) else (b[k],)):
            np.testing.assert_array_equal(x, y)
    assert h.check_graph_equality(h3)
    assert h3._layers[0].width == h._layers[0].width
    for r in (h2, h3):
        r.set_traversal_codec("i8")
        assert r.device_codec().id_rows > 0
    # (a) k=32 through the pool reservoir: the reload answers as the built index
    kw = dict(batch=32, expand=8, pool=64)
    ids, dd = t_stream(h, Q, 32, 48, **kw)
    ids2, dd2 = t_stream(h2, Q, 32, 48, **kw)
    np.testing.assert_array_equal(ids2, ids)
    np.testing.assert_array_equal(dd2, dd)
    ids3, _ = t_stream(h3, Q, 32, 48, **kw)
    same = [set(h._origin[ids[b]]) == set(h3._origin[ids3[b]]) for b in range(len(Q))]
    assert np.mean(same) >= 0.9, np.mean(same)  # tie order in equal-distance rows may differ
    # (b) ef past the JAX package's unroll cap, unfused against fused
    r_f = _recall(h2, t_stream(h2, Q, K, 200, batch=32, expand=4)[0], X, Q)
    r_u = _recall(h2, t_stream(h2, Q, K, 200, batch=32, expand=4,
                               allow_fused=False)[0], X, Q)
    hj = JHnsw(max_nb_connection=8, max_elements=N, ef_construction=64, dist="L2")
    hj.set_keeping_pruned(True)
    hj.modify_level_scale(0.5)
    hj.parallel_insert(X, mode="device", batch_size=512, build_max_iters=48)
    hj.set_traversal_codec("i8")
    r_j = _recall(hj, j_stream(hj, Q, K, 200, batch=32, expand=4)[0], X, Q)
    assert r_u >= 0.97 and abs(r_u - r_f) <= 0.01 and abs(r_u - r_j) <= 0.01, (r_u, r_f, r_j)
    # (c) the exact scan, unpacked against packed, over the reloaded vectors
    Xp, xsq, perm = st.pad_corpus(np.asarray(h2._data[:N], np.float32), tn=256)
    perm = h2._origin[perm]  # scan row -> external id (the build reorders points)
    args = (Q, torch.from_numpy(Xp), torch.from_numpy(xsq), 32)
    skw = dict(tn=256, group=2, acc=st.scan_acc(len(Xp), tn=256), batch=32,
               Xscan=torch.from_numpy(Xp).to(torch.bfloat16))
    du, iu = st.l2_topk_stream(*args, packed=False, **skw)
    dp, ip_ = st.l2_topk_stream(*args, packed=True, **skw)
    truth = get_metric("L2").brute_force(Q, X)
    for b in range(len(Q)):
        want = set(np.argsort(truth[b])[:32].tolist())
        assert set(perm[iu[b]].tolist()) == want == set(perm[ip_[b]].tolist())
    np.testing.assert_allclose(du, dp, rtol=1e-5)


def test_exact_engine_small():
    """BruteForceIndex over the scan (threshold lowered to this size)."""
    X, Q = f32_dataset("gauss", np.random.default_rng(8), 5000, 32, 64, 16)
    bf = BruteForceIndex(device="cpu")
    bf.SCAN_MIN_POINTS = 1
    bf.parallel_insert(X)
    assert bf._use_scan()
    ids, d = bf.search_batch(Q, K)
    truth = get_metric("L2").brute_force(Q, X)
    for b in range(len(Q)):
        assert set(ids[b].tolist()) == set(np.argsort(truth[b])[:K].tolist())
        np.testing.assert_allclose(d[b], np.sort(truth[b])[:K], rtol=1e-4, atol=1e-4)


def test_default_device_is_cuda():
    """Entry points run on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        assert Hnsw().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Hnsw()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BruteForceIndex()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            IvfFlatIndex()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AutoIndex()
    for make in (IvfFlatIndex, AutoIndex):
        assert make(device="cpu").device.type == "cpu"


def test_l1_and_nodist_match_reference(rng):
    """The two metrics persistence brought in, against the JAX package's on the
    same inputs (f32 sums in another order: rtol 1e-5)."""
    from hnsw_tpu import get_metric as j_metric
    q = rng.standard_normal((6, 24)).astype(np.float32)
    C = rng.standard_normal((6, 9, 24)).astype(np.float32)
    l1, jl1 = get_metric("L1"), j_metric("L1")
    np.testing.assert_array_equal(l1.np_batch(q, C[0]), jl1.np_batch(q, C[0]))
    np.testing.assert_allclose(l1.scores(torch.from_numpy(q), torch.from_numpy(C)).numpy(),
                               np.array(jl1.jnp_scores(q, C)), rtol=1e-5)
    np.testing.assert_allclose(
        l1.matmul_scores(torch.from_numpy(q), torch.from_numpy(C[0])).numpy(),
        l1.np_batch(q, C[0]), rtol=1e-5)
    nod = get_metric("DistNoDist")
    assert nod.scores is None and nod.np_batch(q, C[0]).shape == (6, 9)
    np.testing.assert_array_equal(nod.np_batch(q[0], C[0]),
                                  j_metric("NoDist").np_batch(q[0], C[0]))


METRIC_NAMES = ["L1", "L2", "Cosine", "Dot", "Hamming", "Jaccard", "Hellinger",
                "Jeffreys", "JensenShannon", "Levenshtein", "NoDist"]


@pytest.mark.parametrize("name", METRIC_NAMES + ["Dist" + n for n in METRIC_NAMES]
                         + ["Manhattan"])
def test_unported_metric_names_the_queue(name):
    """Every metric name of the JAX package, and its ``Dist`` alias, resolves
    in the port to the metric the JAX package resolves it to (the queue that
    once held six of them is done); an unknown name raises ``ValueError`` in
    both."""
    from hnsw_tpu import get_metric as j_metric
    if name == "Manhattan":
        for resolve in (get_metric, j_metric):
            with pytest.raises(ValueError, match="unknown distance"):
                resolve(name)
        return
    m = get_metric(name)
    assert m.name == j_metric(name).name == name.removeprefix("Dist")
    assert (m.scores is None) == (j_metric(name).jnp_scores is None)
    assert (m.matmul_scores is None) == (j_metric(name).jnp_matmul_scores is None)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "hnsw_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(p.relative_to(ROOT)), m) for p in files for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "hnsw_tpu")]
    assert not bad, bad


def test_kernel_sources_call_no_finished_kernel():
    """Every kernel library is its own hand-written CUDA source with a plain C
    interface: no cuBLAS, CUTLASS, cuDNN or PyTorch header, and one source,
    launch count and binding per library."""
    from hnsw_tpu_torch.ops import kernel_lib
    assert set(kernel_lib.SOURCES) == {"beam_step", "codec_scores", "codec_scores_gathered",
                                       "id_scores", "scan_topk", "scan_topk_unpacked"}
    for name in kernel_lib.SOURCES:
        src = (kernel_lib.CSRC / f"{name}.cu").read_text()
        assert "__global__" in src and f"{name}_launch" in src
        low = src.lower()
        for banned in ("cublas", "cutlass", "cudnn", "torch/", "aten/", "thrust/", "cub/"):
            assert banned not in low, (name, banned)
    assert {"codec_scores_gathered", "scan_topk_unpacked"} <= set(kernel_lib.LAUNCHES)
