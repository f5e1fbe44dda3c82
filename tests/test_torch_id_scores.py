"""Scores of id-named rows (``hnsw_tpu_torch/ops/id_scores.py``) on the CPU.

On CPU tensors ``id_scores`` runs its plain version, which must score bit for
bit as the expressions it replaced: the rows gathered into a ``[B, K, d]``
copy (an invalid id stood in by a valid row) and scored by
``scores_gathered``, then masked to +INF. The route to the CUDA kernel is
decided from the inputs alone; the kernel itself is held against the plain
version in the ``cuda``-marked tests of ``tests/test_torch_kernels.py``."""

import contextlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from hnsw_tpu_torch import Hnsw, IvfFlatIndex
from hnsw_tpu_torch.ops import beam_search, id_scores as ids_mod, insert_rounds, kernel_lib
from hnsw_tpu_torch.ops.distances import DISTANCES, scores_gathered
from hnsw_tpu_torch.ops.id_scores import id_scores, id_scores_entry, id_scores_plain
from hnsw_tpu_torch.models import ivf as ivf_mod
from hnsw_tpu_torch.utils.profiling import PROFILER

INF = float("inf")
# every metric ``scores_gathered`` scores: the inner-product forms and each
# metric with a batched form (a ``Dist`` alias of each inner-product form too)
SCORED = sorted(n for n, m in DISTANCES.items()
                if m.scores is not None and not (n.startswith("Dist") and n not in
                                                 ("DistL2", "DistDot", "DistCosine")))


def _rows(rng, metric, n, d, dtype=torch.float32):
    """A table a metric scores: small symbol codes for Levenshtein and
    Hamming, positive values for the divergences, Gaussian otherwise."""
    if metric in ("Levenshtein", "DistLevenshtein"):
        return torch.from_numpy(rng.integers(0, 5, (n, d)).astype(np.float32))
    if metric in ("Hamming", "DistHamming"):
        return torch.from_numpy(rng.integers(0, 2, (n, d)).astype(np.uint8))
    if metric in ("Jaccard", "Hellinger", "Jeffreys", "JensenShannon"):
        return torch.from_numpy(rng.random((n, d)).astype(np.float32))
    return torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)


def _case(rng, metric, B=6, K=9, n=40, d=16, dtype=torch.float32):
    X = _rows(rng, metric, n, d, dtype)
    xf = X.to(torch.float32)
    sq = (xf * xf).sum(-1)
    q = _rows(rng, metric, B, d).to(X.dtype if X.dtype == torch.uint8 else torch.float32)
    ids = torch.from_numpy(rng.integers(-1, n, (B, K)).astype(np.int32))
    ids[0, :3] = torch.tensor([n - 1, n - 1, -1])  # the last row, repeated; a -1
    return q, X, sq, ids


def _before(metric, q, X, sq, ids):
    """The expression each call site held: invalid ids stood in by the
    table's last row, the rows gathered and scored, then masked."""
    valid = ids >= 0
    safe = torch.where(valid, ids, X.shape[0] - 1).long()
    return torch.where(valid, scores_gathered(metric, q, X[safe], sq[safe]), INF)


@pytest.mark.parametrize("metric", SCORED)
def test_cpu_scores_are_the_replaced_expression_bit_for_bit(rng, metric):
    """Every metric ``scores_gathered`` takes, f32 rows (and bf16 rows for
    the inner-product forms): the same bits as the gather-and-score
    expression, +INF exactly where an id is negative, no kernel launched."""
    kernel_lib.reset_launch_counts()
    dtypes = [torch.float32]
    if metric in ids_mod.FORMS:
        dtypes.append(torch.bfloat16)
    for dtype in dtypes:
        q, X, sq, ids = _case(rng, metric, dtype=dtype)
        got = id_scores(metric, q, X, sq, ids)
        want = _before(metric, q, X, sq, ids)
        assert got.dtype == torch.float32 and got.shape == ids.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(torch.isinf(got) & (got > 0) & (ids < 0), ids < 0)
    assert sum(kernel_lib.LAUNCHES.values()) == 0


def test_plain_version_clamps_large_ids_and_takes_any_integer_dtype(rng):
    """An id past the table is scored as its last row (the clamp every call
    site made); int64 ids (IVF's packed rows) score as int32 ones."""
    q, X, sq, ids = _case(rng, "L2")
    big = ids.clone()
    big[1, 2] = 10 ** 6
    want = ids.clone()
    want[1, 2] = X.shape[0] - 1
    assert torch.equal(id_scores("L2", q, X, sq, big), id_scores("L2", q, X, sq, want))
    assert torch.equal(id_scores("L2", q, X, sq, ids.long()), id_scores("L2", q, X, sq, ids))


@pytest.mark.parametrize("metric,dtype,entry", [
    ("L2", torch.float32, "f32"), ("DistL2", torch.float32, "f32"),
    ("Dot", torch.bfloat16, "bf16"), ("Cosine", torch.bfloat16, "bf16"),
    ("DistCosine", torch.float32, "f32"), ("DistDot", torch.float32, "f32"),
    ("L2", torch.bfloat16, "bf16"),
    ("L2", torch.float16, None),       # a dtype the kernel has no entry for
    ("L1", torch.float32, None), ("Hamming", torch.uint8, None),
    ("Levenshtein", torch.float32, None), ("Jaccard", torch.float32, None),
    ("NoDist", torch.float32, None),
])
def test_route_is_chosen_from_metric_and_dtype(metric, dtype, entry):
    """The kernel takes the inner-product metrics on f32 or bf16 rows, of
    any width (no d is refused); each entry has a launch counter."""
    assert id_scores_entry(metric, dtype) == entry
    if entry is not None:
        assert kernel_lib.ID_SCORES_ENTRIES.index(entry) == (0 if entry == "f32" else 1)
        assert f"id_scores.{entry}" in kernel_lib.LAUNCHES


@pytest.mark.parametrize("metric", ["L2", "Cosine", "L1"])
def test_plain_version_copies_in_column_chunks_bit_for_bit(rng, monkeypatch, metric):
    """The plain version makes its ``[B, K, d]`` copy a few columns of ids at
    a time (``PLAIN_COPY``); cut into chunks of 4 columns, with a ragged
    last one, the scores are the same bits as one copy of all the columns."""
    q, X, sq, ids = _case(rng, metric, K=11)
    whole = id_scores_plain(metric, q, X, sq, ids)
    monkeypatch.setattr(ids_mod, "PLAIN_COPY", 4 * X.shape[1])
    assert torch.equal(id_scores_plain(metric, q, X, sq, ids).view(torch.int32),
                       whole.view(torch.int32))
    assert torch.equal(whole.view(torch.int32), _before(metric, q, X, sq, ids).view(torch.int32))


def test_cpu_tables_take_the_plain_version_uncounted(rng, monkeypatch):
    """A CPU table never reaches the kernel library, whatever its metric and
    depth, and is not counted as a card call that took the plain version."""
    monkeypatch.setattr(PROFILER, "enabled", True)
    PROFILER.reset()
    kernel_lib.reset_launch_counts()
    monkeypatch.setattr(kernel_lib, "load", lambda name: pytest.fail("kernel loaded"))
    for metric, d in (("L2", 16), ("Cosine", 36), ("L1", 16)):
        q, X, sq, ids = _case(rng, metric, d=d)
        id_scores(metric, q, X, sq, ids)
    assert sum(kernel_lib.LAUNCHES.values()) == 0
    assert "id_scores.plain" not in PROFILER.report().get("counters", {})
    PROFILER.reset()


def test_wrapper_launches_through_the_counted_helper():
    """The wrapper hands its library call to ``kernel_lib.launch`` once and
    counts nowhere else; the library is one of the sources built."""
    import inspect
    src = inspect.getsource(ids_mod)
    assert "LAUNCHES[" not in src.split('"""', 2)[2]
    assert src.count("kernel_lib.launch(") == 1
    assert "id_scores" in kernel_lib.SOURCES
    assert (kernel_lib.CSRC / "id_scores.cu").exists()


@contextlib.contextmanager
def _patched(monkeypatch, fn):
    with monkeypatch.context() as m:
        for mod in (beam_search, insert_rounds, ivf_mod):
            m.setattr(mod, "id_scores", fn)
        yield


@pytest.mark.parametrize("lo,extend", [(False, False), (True, True)])
def test_build_and_search_equal_the_replaced_expression(rng, monkeypatch, lo, extend):
    """A device build (with the bf16 traversal copy and the widen pass, or
    without either) and the searches through it, once through ``id_scores``
    and once through the expression it replaced: the same tables and the
    same answers, bit for bit."""
    monkeypatch.setenv("HNSW_BUILD_LO", "1" if lo else "0")
    X = rng.standard_normal((1500, 24)).astype(np.float32)
    Q = rng.standard_normal((40, 24)).astype(np.float32)

    def run():
        h = Hnsw(max_nb_connection=6, max_elements=len(X), ef_construction=32,
                 dist="L2", device="cpu")
        h.set_extend_candidates(extend)
        h.parallel_insert(X, mode="device", batch_size=256)
        ids, d = beam_search.device_search_batch(h, Q, 10, 32)
        return h, ids, d

    h1, i1, d1 = run()
    with _patched(monkeypatch, _before):
        h2, i2, d2 = run()
    assert h1.check_graph_equality(h2)
    np.testing.assert_array_equal(i1, i2)
    assert np.array_equal(d1.view(np.int32), d2.view(np.int32))


def test_ivf_refine_equals_the_replaced_expression(rng, monkeypatch):
    """IVF's exact refine through ``id_scores`` and through the expression it
    replaced: the same rows and distances, padding rows and unfilled slots
    at +INF."""
    X = rng.standard_normal((3000, 16)).astype(np.float32)
    Q = rng.standard_normal((32, 16)).astype(np.float32)
    ix = IvfFlatIndex("L2", n_clusters=16, device="cpu")
    ix.parallel_insert(X)
    a = ix.search_batch(Q, 10, nprobe=4)
    ix2 = IvfFlatIndex("L2", n_clusters=16, device="cpu")
    ix2.parallel_insert(X)
    with _patched(monkeypatch, _before):
        b = ix2.search_batch(Q, 10, nprobe=4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
