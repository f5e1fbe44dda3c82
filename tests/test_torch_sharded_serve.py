"""The sharded tier's serving path (``ShardedHnsw.search_stream``, the path
of the benchmark's four-card cell) on four shards of one CPU device: its
answers against the benchmark's plain reference (``benchmark/references/L2.py``
judged by ``benchmark/judge.py``), the shards' exact top-k against the
reference's top-k over the whole corpus, the map of merged rows to external
ids, and the spans and counters of the
fan-out, the lockstep and the merge."""

import numpy as np
import pytest
import torch

from benchmark import datagen, judge, references
from hnsw_tpu_torch import ShardedHnsw
from hnsw_tpu_torch.ops.beam_search import smallest
from hnsw_tpu_torch.utils.profiling import PROFILER, enable_profiling

torch.set_num_threads(2)

SHARDS, N, D, NQ, K, EF = 4, 4800, 32, 200, 10, 64
GAUSS = {"recipe": "gauss", "intrinsic": 16, "noise": 0.02}
SHARD_SPANS = {"shard.start", "shard.step", "shard.poll", "shard.merge"}


@pytest.fixture(scope="module")
def cell():
    """Seeded corpus and queries (the cells' recipe), meshed over four CPU
    shards at the sharded cell's arguments scaled down."""
    X, Q = datagen.make(GAUSS, N, NQ, D, 2**31 + 4099, "cpu")
    sh = ShardedHnsw(n_shards=SHARDS, device="cpu", max_nb_connection=12,
                     max_elements=N // SHARDS, ef_construction=64, dist="L2")
    sh.set_keeping_pruned(True)
    sh.modify_level_scale(0.5)
    sh.parallel_insert((X.numpy(), np.arange(N)), mode="auto", batch_size=512)
    assert sh._mesh_rounds > 0  # "auto" took the mesh build
    return X, Q, sh


@pytest.fixture
def profiling():
    PROFILER.reset()
    enable_profiling()
    try:
        yield PROFILER
    finally:
        enable_profiling(False)
        PROFILER.reset()


def test_stream_answers_meet_the_reference(cell):
    """Ids are corpus rows; no bad row, recall over the cell's floor, and each
    distance within the cell's ``dist_gap`` of the fp64 one."""
    X, Q, sh = cell
    ids, dists = sh.search_stream(Q.numpy(), K, EF, expand=4, batch=128)
    ref = references.for_metric("L2")
    got = judge.judge(ref, X, Q, ref.truth(X, Q, K), np.arange(NQ), ids, dists)
    assert got["answers"] == NQ and got["bad_rows"] == 0
    assert got["recall_at_10"] >= 0.98 and got["dist_gap"] <= 1e-5, got


def test_shards_exact_topk_merged_is_the_whole_corpus_topk(cell):
    """Each shard's exact top-k (the exact search restricted to that shard's
    rows), merged by distance, is the reference's top-k over all the rows:
    the shards together hold the whole answer."""
    X, Q, sh = cell
    parts = [sh.exact_search_batch(Q.numpy(), K, filter=np.sort(h._origin[:h._nb_point]))
             for h in sh.shards]
    for (ids, _), h in zip(parts, sh.shards):  # each part answers from its shard alone
        assert np.isin(ids, h._origin[:h._nb_point]).all()
    ids = torch.as_tensor(np.concatenate([p[0] for p in parts], 1))
    dists = torch.as_tensor(np.concatenate([p[1] for p in parts], 1))
    d, order = smallest(dists, K)
    merged = torch.gather(ids, 1, order)
    t_ids, t_d2 = references.for_metric("L2").truth(X, Q, K)
    np.testing.assert_array_equal(merged.numpy(), t_ids.numpy())
    np.testing.assert_allclose(d.double().numpy() ** 2, t_d2.numpy(), rtol=1e-5, atol=1e-6)
    whole, _ = sh.exact_search_batch(Q.numpy(), K)
    np.testing.assert_array_equal(whole, t_ids.numpy())


def test_merged_rows_map_to_external_ids_as_the_shards_origins_say(cell):
    """The gather on the merge's device against a plain host lookup in each
    shard's ``_origin``: -1 and INF where a row has no answer (a local id of
    -1 or an infinite distance), every other row its shard's external id."""
    _, _, sh = cell
    st = sh._build_state()
    assert [g.n for g in st.graphs] == [h._nb_point for h in sh.shards]
    assert st.origin.shape == (SHARDS, st.cap1)
    g = torch.Generator().manual_seed(7)
    shard = torch.randint(0, SHARDS, (64, K), generator=g, dtype=torch.int32)
    local = torch.randint(0, N // SHARDS, (64, K), generator=g, dtype=torch.int32)
    dists = torch.rand((64, K), generator=g)
    local[:8, -2:] = -1
    dists[8:16, -1] = float("inf")
    ids, d = sh._to_external(st, local, shard, dists)
    s, lo, dd = shard.numpy(), local.numpy(), dists.numpy()
    ok = (lo >= 0) & np.isfinite(dd)
    want = np.full(lo.shape, -1, np.int64)
    want[ok] = [sh.shards[a]._origin[b] for a, b in zip(s[ok], lo[ok])]
    assert ids.dtype == np.int64 and d.dtype == np.float32
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_array_equal(d, np.where(ok, dd, np.inf))
    assert (~ok).sum() == 24


@pytest.mark.parametrize("entry", ["search_stream", "search_batch"])
def test_a_call_records_its_shard_spans_under_search_call(cell, profiling, entry):
    _, Q, sh = cell
    getattr(sh, entry)(Q.numpy()[:64], K, EF)
    ev = profiling.events()
    roots = [e for e in ev if e.name == "search.call"]
    assert len(roots) == 1 and roots[0].parent is None
    by_id = {e.span: e for e in ev}
    names = {e.name for e in ev}
    assert SHARD_SPANS <= names
    for e in ev:
        if e.name in SHARD_SPANS:
            assert e.call == roots[0].call
            up = e
            while up.parent is not None:  # every shard span lies inside the call
                up = by_id[up.parent]
            assert up is roots[0]
    c = profiling.report()["counters"]
    steps = sum(e.name == "shard.step" for e in ev)
    polls = sum(e.name == "shard.poll" for e in ev)
    merges = sum(e.name == "shard.merge" for e in ev)
    assert steps == polls >= 1 and merges == 1  # one batch: one merge
    assert c["shard.steps"] + c["shard.idle_steps"] == SHARDS * steps


def test_a_shard_that_finishes_first_counts_idle_steps(cell, profiling):
    """Shard 0 reporting done after its first chunk: every later chunk is one
    idle slot, and steps + idle slots stay shards x chunks."""
    _, Q, sh = cell
    q = Q.numpy()[:64]
    sh.search_batch(q, K, EF)  # the programs built
    profiling.reset()
    sh.search_batch(q, K, EF)
    chunks = sum(e.name == "shard.step" for e in profiling.events())
    assert chunks >= 2
    progs = [p for p in sh._programs[0]._progs.values() if hasattr(p, "n_chunks")]
    for p in progs:
        p.finished = lambda j: True
    try:
        profiling.reset()
        sh.search_batch(q, K, EF)
    finally:
        for p in progs:
            del p.finished
    c = profiling.report()["counters"]
    assert sum(e.name == "shard.step" for e in profiling.events()) == chunks
    assert c["shard.idle_steps"] == chunks - 1
    assert c["shard.steps"] == (SHARDS - 1) * chunks + 1


def test_nothing_is_recorded_with_profiling_off(cell):
    _, Q, sh = cell
    PROFILER.reset()
    assert not PROFILER.enabled
    sh.search_stream(Q.numpy()[:64], K, EF)
    sh.search_batch(Q.numpy()[:64], K, EF)
    assert PROFILER.events() == [] and "counters" not in PROFILER.report()
