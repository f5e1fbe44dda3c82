"""The search as one device program (``hnsw_tpu_torch/ops/program.py``) on
the CPU, on the graph of ``tests/test_torch_search.py`` (3000 x 32, M=8): the
program's pieces run in the same order as on the card, without capture, and
answer bit for bit what the eager ``search_program`` answers (early exit per
iteration), in the unrolled form (one graph) and the chunked form (a head,
chunks of 8 iterations, a tail); without a codec the answers are set-equal to
the JAX package's. Then the program cache, the launch-count bookkeeping
against a stub graph, the sharded tier's interleaved per-shard programs and
the bench's device-resident rate."""

import contextlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from hnsw_tpu.ops.beam_search import device_search_batch as j_search
from hnsw_tpu_torch import Hnsw, IvfFlatIndex, ShardedHnsw, bench
from hnsw_tpu_torch.ops import beam_search as tbs
from hnsw_tpu_torch.ops import kernel_lib, program
from hnsw_tpu_torch.ops.beam_search import (_device_mask, device_search_batch,
                                            device_search_stream, search_program,
                                            serve_static)
from hnsw_tpu_torch.ops.codec_scores import codec_scores_plain
from hnsw_tpu_torch.ops.scan_topk import l2_topk_stream, pad_corpus
from hnsw_tpu_torch.ops.stream import query_stream
from hnsw_tpu_torch.parallel.sharded import _merge_shard_topk
from test_torch_search import K, N, _assert_set_equal, pair  # noqa: F401 (fixture)

FILTER = list(range(0, N, 3))

# (id, codec, search arguments); max_iters None is the serving default
CASES = [
    ("plain", None, {}),
    ("filtered", None, {"filter": FILTER}),
    ("pool", None, {"pool": 64, "knbn": 20, "ef": 24}),
    ("i8-fused", "i8", {"allow_fused": True}),
    ("i8-unfused", "i8", {"allow_fused": False}),
    ("iters10", None, {"max_iters": 10}),
    ("iters64", None, {"max_iters": 64}),
    # 130 = 16 chunks of 8 and one of 2; one expansion an iteration into a
    # beam of 128 runs to the cap, so the short last chunk runs
    ("iters130", None, {"max_iters": 130, "ef": 128, "expand": 1}),
]


def _static(ht, kw):
    kw = dict(kw)
    fil = kw.pop("filter", None)
    static = serve_static(ht.device_codec(), ef=kw.pop("ef", 48), knbn=kw.pop("knbn", K),
                          use_mask=fil is not None, **kw)
    return static, fil


@contextlib.contextmanager
def _codec(ht, kind):
    ht.set_traversal_codec(kind)
    try:
        yield
    finally:
        ht.set_traversal_codec(None)


@pytest.mark.parametrize("codec,kw", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_program_equals_eager_search(pair, codec, kw):
    """The program's ids and distances are the eager search's, bit for bit."""
    ht, _, _, Q = pair
    with _codec(ht, codec):
        static, fil = _static(ht, kw)
        g = ht.device_graph()
        mask = _device_mask(ht, g, fil) if fil is not None else None
        q = torch.as_tensor(Q)
        prog = ht.device_program(len(Q), torch.float32, **static)
        assert prog.unrolled == (static["max_iters"] <= program.UNROLL_MAX)
        assert prog.n_chunks == (0 if prog.unrolled else -(-static["max_iters"] // 8))
        ids_p, d_p = prog.run(q, mask)
        ids_e, d_e = search_program(g, q, mask, codec=ht.device_codec(), **static)
        np.testing.assert_array_equal(ids_p.numpy(), ids_e.numpy())
        np.testing.assert_array_equal(d_p.numpy(), d_e.numpy())
        if static["max_iters"] == 130:
            assert prog._flags[-1] is not None  # the 2-iteration chunk ran
        # a second call of the cached program answers the same
        assert ht.device_program(len(Q), torch.float32, **static) is prog
        ids_2, d_2 = prog.run(q, mask)
        np.testing.assert_array_equal(ids_2.numpy(), ids_e.numpy())
        np.testing.assert_array_equal(d_2.numpy(), d_e.numpy())


NO_CODEC = [c for c in CASES if c[1] is None]


@pytest.mark.parametrize("kw", [c[2] for c in NO_CODEC], ids=[c[0] for c in NO_CODEC])
def test_program_set_equal_to_jax(pair, kw):
    """``device_search_batch`` through the program, without a codec, returns
    the JAX package's id sets and distances (as
    ``test_exact_traversal_set_equal``)."""
    ht, hj, _, Q = pair
    ht.set_traversal_codec(None)
    hj.set_traversal_codec(None)
    kw = dict(kw)
    knbn, ef = kw.pop("knbn", K), kw.pop("ef", 48)
    ids_t, d_t = device_search_batch(ht, Q, knbn, ef, **kw)
    ids_j, d_j = j_search(hj, Q, knbn, ef, **kw)
    _assert_set_equal(ids_t, d_t, np.array(ids_j), np.array(d_j))


def test_stream_ragged_tail(pair):
    """``device_search_stream`` with a ragged tail batch builds a program per
    batch shape and answers each batch as the eager search does."""
    ht, _, _, Q = pair
    ht.set_traversal_codec(None)
    Qs = np.concatenate([Q, Q[:22]])  # 70 queries: batches of 32, 32 and 6
    ids, dists = device_search_stream(ht, Qs, K, 48, batch=32, filter=FILTER)
    static, _ = _static(ht, {"filter": FILTER})
    g = ht.device_graph()
    mask = _device_mask(ht, g, FILTER)
    for s in range(0, len(Qs), 32):
        qb = torch.as_tensor(Qs[s:s + 32])
        ids_e, d_e = search_program(g, qb, mask, codec=None, **static)
        ids_e = ids_e.numpy().astype(np.int64)
        ids_e[~np.isfinite(d_e.numpy())] = -1
        np.testing.assert_array_equal(ids[s:s + 32], ids_e)
        np.testing.assert_array_equal(dists[s:s + 32], d_e.numpy())
    shapes = {k[2] for k in ht._programs._progs}
    assert {32, 6} <= shapes


@pytest.fixture
def small():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((400, 16)).astype(np.float32)
    h = Hnsw(max_nb_connection=8, max_elements=500, ef_construction=32, dist="L2",
             device="cpu")
    h.parallel_insert(X[:300], mode="device", batch_size=128)
    return h, X


def test_version_bump_drops_programs(small):
    h, X = small
    Q = X[300:310]
    device_search_batch(h, Q, 5, 16)
    old = next(iter(h._programs._progs.values()))
    assert len(h._programs) == 1
    h.parallel_insert((X[300:340], np.arange(300, 340)), mode="device", batch_size=128)
    ids, _ = device_search_batch(h, Q, 5, 16)
    assert len(h._programs) == 1
    new = next(iter(h._programs._progs.values()))
    assert new is not old and new.g is h.device_graph()
    # the new program searches the grown graph
    static, _ = _static(h, {"knbn": 5, "ef": 16})
    want, _ = search_program(h.device_graph(), torch.as_tensor(Q), None, codec=None,
                             **static)
    np.testing.assert_array_equal(ids, want.numpy())
    assert (h._origin[ids[:, 0]] >= 300).mean() >= 0.5  # the new points are found


def test_set_traversal_codec_drops_programs(small):
    h, X = small
    device_search_batch(h, X[300:310], 5, 16)
    device_search_batch(h, X[300:305], 5, 16)
    assert len(h._programs) == 2
    h.set_traversal_codec("i8")
    assert len(h._programs) == 0
    device_search_batch(h, X[300:310], 5, 16)
    (prog,) = h._programs._progs.values()
    assert prog.codec is h.device_codec() and prog.codec is not None
    h.set_entry_pivots(0)
    assert len(h._programs) == 0


class StubProgram:
    def __init__(self, name, pool_bytes=0):
        self.name, self.pool_bytes, self.device = name, pool_bytes, torch.device("cpu")


def test_cache_keeps_the_most_recent_programs():
    cache = program.ProgramCache()
    for i in range(program.MAX_PROGRAMS + 1):
        cache.get(0, i, lambda i=i: StubProgram(i))
    assert len(cache) == program.MAX_PROGRAMS and 0 not in cache._progs
    cache.get(0, 1, lambda: pytest.fail("a cached program was rebuilt"))
    cache.get(0, 9, lambda: StubProgram(9))
    assert 1 in cache._progs and 2 not in cache._progs  # 1 was used last
    cache.get(1, 1, lambda: StubProgram(1))  # a new tag drops every program
    assert list(cache._progs) == [1]


def test_cache_keeps_its_pools_within_the_budget(monkeypatch):
    """Before a build the cache keeps room for one more program as large as
    the largest it holds; after it, the pools fit the budget."""
    cache = program.ProgramCache()
    monkeypatch.setattr(cache, "_budget", lambda: 10)
    for i in range(3):
        cache.get(0, i, lambda i=i: StubProgram(i, 4))
    assert list(cache._progs) == [1, 2] and cache.pool_bytes() == 8
    cache.get(0, 3, lambda: StubProgram(3, 9))  # alone over the budget: kept
    assert list(cache._progs) == [3]
    cache.get(0, 4, lambda: StubProgram(4, 1))
    assert list(cache._progs) == [4]


class StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay only counts."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@contextlib.contextmanager
def stub_capture(graph):
    yield


def _launch_b1():
    kernel_lib.launch("codec_scores_ids", "bulk", lambda: 0)


def test_piece_launch_bookkeeping():
    """A capture's launches are recorded, the counters put back, and the
    recorded launches added on every replay."""
    before = dict(kernel_lib.LAUNCHES)

    def fn():
        _launch_b1()
        _launch_b1()
        kernel_lib.launch("codec_scores_gathered", "stream", lambda: 0)

    piece = program.Piece(fn, StubGraph(), stub_capture)
    assert kernel_lib.LAUNCHES == before
    assert piece.launches == {"codec_scores_ids": 2, "codec_scores_ids.bulk": 2,
                              "codec_scores_gathered": 1,
                              "codec_scores_gathered.stream": 1}
    piece.replay()
    piece.replay()
    assert piece.graph.replays == 2
    assert kernel_lib.LAUNCHES["codec_scores_ids.bulk"] == before["codec_scores_ids.bulk"] + 4
    assert (kernel_lib.LAUNCHES["codec_scores_gathered"]
            == before["codec_scores_gathered"] + 2)
    assert kernel_lib.LAUNCHES["scan_topk"] == before["scan_topk"]


def test_failed_capture_raises_and_restores_counts():
    before = dict(kernel_lib.LAUNCHES)

    def fn():
        _launch_b1()
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        program.Piece(fn, StubGraph(), stub_capture)
    assert kernel_lib.LAUNCHES == before


@pytest.mark.parametrize("max_iters,graphs", [(10, 1), (20, 5)], ids=["unrolled", "chunked"])
def test_program_counts_launches_per_replay(pair, monkeypatch, max_iters, graphs):
    """A whole program on stub graphs: B1 counted once per beam iteration on
    every call, none at build time; the chunked form (the gate lowered to 8)
    builds a head, three chunks (8, 8, 4 iterations) and a tail."""
    ht, _, _, Q = pair

    def counted(*a, **kw):
        _launch_b1()
        return codec_scores_plain(*a, **kw)

    monkeypatch.setattr(tbs, "codec_scores", lambda src, q, qsn, scale, blocks, M0, form:
                        counted(src, q, qsn, scale, blocks, M0, form))
    monkeypatch.setattr(program, "UNROLL_MAX", 8 if graphs > 1 else program.UNROLL_MAX)
    with _codec(ht, "i8"):
        static, _ = _static(ht, {"max_iters": max_iters})
        before = dict(kernel_lib.LAUNCHES)
        prog = program.SearchProgram(ht.device_graph(), ht.device_codec(), len(Q),
                                     torch.float32, "cpu", graph_factory=StubGraph,
                                     capture=stub_capture, **static)
        assert kernel_lib.LAUNCHES == before
        pieces = [prog._head, *prog._chunks] + ([prog._tail] if prog._tail else [])
        assert len(pieces) == graphs
        assert sum(p.launches.get("codec_scores_ids.bulk", 0) for p in pieces) == max_iters
        for call in (1, 2):
            for j in range(prog.n_chunks):  # every chunk, as a batch running to the cap
                prog._flags[j] = torch.tensor(False)
            prog.run(torch.as_tensor(Q))
            assert (kernel_lib.LAUNCHES["codec_scores_ids.bulk"]
                    == before["codec_scores_ids.bulk"] + call * max_iters)
            assert all(p.graph.replays == call for p in pieces)


@pytest.fixture(scope="module")
def sharded():
    rng = np.random.default_rng(0x5B)
    X = rng.random((1600, 16)).astype(np.float32)
    sh = ShardedHnsw(n_shards=8, device="cpu", max_elements=1600 // 8 + 8,
                     max_nb_connection=12, ef_construction=48, dist="L2")
    sh.parallel_insert((X, np.arange(len(X))), mode="mesh", batch_size=128)
    return sh, rng.random((40, 16)).astype(np.float32)


@pytest.mark.parametrize("codec", [None, "i8"])
def test_sharded_programs_equal_eager(sharded, codec):
    """``ShardedHnsw.search_batch`` through eight per-shard programs (the
    chunked form: the cap is 4*ef//4 + 32), interleaved chunk by chunk, equals
    the eager search of every shard merged the same way."""
    sh, Q = sharded
    sh.set_traversal_codec(codec)
    try:
        ids, dists = sh.search_batch(Q, 10, 64, filter=list(range(0, 1600, 2)))
        st, programs, _ = sh._search_fn(10, 64, list(range(0, 1600, 2)), 4, None)
        progs = programs(len(Q), torch.float32)
        assert all(p.n_chunks == 12 for p in progs)  # 96 iterations
        # each shard's program holds its snapshot and codec, keyed as a
        # one-card program is
        codecs = sh._codecs() or [None] * 8
        assert [p.g for p in progs] == st.graphs and [p.codec for p in progs] == codecs
        assert (progs[0].codec is not None) == (codec is not None)
        for c, p, g, cd in zip(sh._programs, progs, st.graphs, codecs):
            assert c._progs[program.program_key(g, cd, len(Q), torch.float32, "cpu", **{
                k: v for k, v in p.kw.items() if k != "codec"})] is p
        masks = sh._masks(list(range(0, 1600, 2)), st)
        e_ids, e_d = [], []
        for p, m in zip(progs, masks):
            i, d = search_program(p.g, torch.as_tensor(Q), m, **p.kw)
            ok = (i >= 0) & (i < p.g.n)
            e_ids.append(torch.where(ok, i, -1))
            e_d.append(torch.where(ok, d, float("inf")))
        want = sh._to_external(st, *_merge_shard_topk(e_ids, e_d, 10, sh.devices[0]))
    finally:
        sh.set_traversal_codec("auto")
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(dists, want[1])
    assert (ids[ids >= 0] % 2 == 0).all()


def test_query_stream_front_end():
    """The front end every stream shares: float32 rows (one query a batch of
    one), float16 for "f16", the outputs -1 and inf, the batches' rows; any
    other query dtype raises."""
    q, ids, dists, work = query_stream(np.arange(4, dtype=np.float64), 3, 2)
    assert q.dtype == np.float32 and q.shape == (1, 4) and work == [(0, 1)]
    q, ids, dists, work = query_stream(np.ones((5, 4)), 3, 2, query_dtype="f16")
    assert q.dtype == np.float16 and work == [(0, 2), (2, 4), (4, 5)]
    assert ids.dtype == np.int64 and (ids == -1).all() and ids.shape == (5, 3)
    assert dists.dtype == np.float32 and np.isinf(dists).all() and dists.shape == (5, 3)
    with pytest.raises(ValueError, match="query_dtype"):
        query_stream(np.ones((5, 4)), 3, 2, query_dtype="bf16")


@pytest.mark.parametrize("entry", ["device_search_stream", "l2_topk_stream",
                                   "ShardedHnsw.search_stream", "IvfFlatIndex.search_stream"])
def test_every_stream_takes_the_shared_front_end(sharded, entry):
    """The four streams answer one 1-d query as a batch of one and refuse a
    query dtype other than f16 or f32."""
    sh, Q = sharded
    h = sh.shards[0]
    X = np.asarray(h._data[:h._nb_point], np.float32)
    if entry == "l2_topk_stream":
        Xp, xsq, _ = pad_corpus(X)
        Xp, xsq = torch.from_numpy(Xp), torch.from_numpy(xsq)
    if entry == "IvfFlatIndex.search_stream":
        ix = IvfFlatIndex(n_clusters=8, nprobe=4, device="cpu")
        ix.parallel_insert((X, np.arange(len(X))))
    run = {"device_search_stream": lambda q, **kw: device_search_stream(h, q, 5, 16, **kw),
           "l2_topk_stream": lambda q, **kw: l2_topk_stream(
               q, Xp, xsq, 5, batch=8, acc=1, **kw)[::-1],
           "ShardedHnsw.search_stream": lambda q, **kw: sh.search_stream(q, 5, 16, **kw),
           "IvfFlatIndex.search_stream": lambda q, **kw: ix.search_stream(q, 5, batch=8, **kw),
           }[entry]
    ids, dists = run(Q[0])
    assert ids.shape == dists.shape == (1, 5) and ids.dtype == np.int64
    with pytest.raises(ValueError, match="query_dtype"):
        run(Q[0], query_dtype="bf16")


def test_kernel_rate_replays_the_stream_program(small, monkeypatch):
    """The bench's device-resident rate replays the captured program (the one
    the stream serves with) over the resident sub-batches."""
    h, X = small
    runs = []
    run = program.SearchProgram.run
    monkeypatch.setattr(program.SearchProgram, "run",
                        lambda self, *a: runs.append(self) or run(self, *a))
    cfg = bench.Config(device="cpu", qbatch=32, kernel_s=2, k=5, qdtype=None, pool=0)
    kqps = bench.kernel_rate(cfg, h, X[300:364], 16)
    assert kqps is None or kqps > 0
    (prog,) = h._programs._progs.values()
    assert runs == [prog] * ((1 + 2) * (1 + bench.DIFF_PAIRS))
    ids, _ = device_search_stream(h, X[300:364], 5, 16, batch=32, pool=cfg.pool)
    assert len(h._programs) == 1  # the stream found the same program
