"""The build as device programs (``hnsw_tpu_torch/ops/program.py``:
``BuildPrograms``, ``RoundProgram``) on the CPU. On the card a round program's
pieces are CUDA graphs: a key's first round runs them uncaptured, the second
captures (which runs nothing) and replays, later rounds replay. Here the
pieces run on stub graphs that behave so (``DeferredPiece``: a capture runs
nothing, a replay runs the piece), so every round is applied exactly once, as
on the card. Held against the eager ``round_step`` bit for bit and against
the JAX package's ``_round_step``; then the pieces of this slice that run no
round: the fixed-shape ``_add_counts``, the chunked host reads of
``_label_prop``, the chunked codec build and the k-means program."""

import contextlib
import gc

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp

import hnsw_tpu.models.ivf as jivf
import hnsw_tpu.ops.components as jcomp
import hnsw_tpu.ops.graph_arrays as jga
import hnsw_tpu.ops.insert_rounds as jir
import hnsw_tpu_torch.models.ivf as tivf
import hnsw_tpu_torch.ops.insert_rounds as tir
from hnsw_tpu_torch import Hnsw, from_arrays, to_arrays
from hnsw_tpu_torch.convert import params_of
from hnsw_tpu_torch.ops import components, graph_arrays, program
from hnsw_tpu_torch.ops.insert_rounds import BuildTensors, RoundConfig, round_step
from test_torch_build import _base, jax_from_state
from test_torch_program import StubGraph, stub_capture


class DeferredPiece(program.Piece):
    """A piece on a stub graph that behaves as a CUDA graph does for a
    round: the capture runs nothing and counts no launch, each replay runs
    the piece's function once."""

    def __init__(self, fn, graph=None, capture=None):
        super().__init__(fn)
        self.graph = graph

    def replay(self):
        if self.graph is not None:
            self.graph.replays += 1
        self.fn()


@pytest.fixture
def stubs(monkeypatch):
    """Round programs' pieces as ``DeferredPiece``; yields the list that
    collects the stub graphs made (``_programs``, ``rounds_through``)."""
    monkeypatch.setattr(program, "Piece", DeferredPiece)
    yield []


def _programs(graphs, device="cpu", share=program.POOL_SHARE):
    """A build's round programs on stub graphs, collected in ``graphs``."""
    def factory():
        graphs.append(StubGraph())
        return graphs[-1]
    return program.BuildPrograms(device, factory, stub_capture, share)


@contextlib.contextmanager
def rounds_through(graphs, made=None):
    """Builds in this scope run their rounds through round programs on stub
    graphs (collected in ``graphs``; the programs in ``made``), or with None
    the eager ``round_step``."""
    real = program.round_programs
    made = [] if made is None else made
    program.round_programs = (
        (lambda device, share=program.POOL_SHARE: None) if graphs is None
        else (lambda device, share=program.POOL_SHARE:
              made.append(_programs(graphs, device, share)) or made[-1]))
    try:
        yield
    finally:
        program.round_programs = real


def _build(X, graphs, batch=256, params=(), setup=(), made=None, **kw):
    """A device build of ``X`` through the round programs
    (``graphs``: the ``stubs`` fixture's list) or the eager rounds (None)."""
    h = Hnsw(max_elements=len(X), device="cpu",
             **{**dict(max_nb_connection=8, ef_construction=48, dist="L2"), **dict(params)})
    for k, v in dict(setup).items():
        getattr(h, k)(v)
    with rounds_through(graphs, made):
        h.parallel_insert(X, mode="device", batch_size=batch, **kw)
    assert hasattr(h, "_round_stats") == (graphs is not None)
    return h


def _assert_same_graph(a, b):
    ta, tb = to_arrays(a), to_arrays(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


@pytest.mark.parametrize("max_iters", [20, None], ids=["cap20", "default-cap"])
def test_device_build_through_programs_equals_eager(stubs, max_iters):
    """A whole device build through the round programs writes the eager
    build's tables, bit for bit. Cap 20 is not a multiple of CHUNK (chunks
    of 8, 8, 4); the default cap (56) runs 7 chunks, and the beam ends
    before it, mid-chunk. Every key's first run is uncaptured, later rounds
    replay."""
    rng = np.random.default_rng(5)
    X = rng.random((1400, 16)).astype(np.float32)
    kw = dict(build_max_iters=max_iters, setup={"modify_level_scale": 0.7})
    eager = _build(X, None, batch=128, **kw)
    assert not stubs
    h = _build(X, stubs, batch=128, **kw)
    _assert_same_graph(h, eager)
    s = h._round_stats
    assert s["first_runs"] == s["keys"] > 0 and s["captures"] > 0
    assert 0 < s["rounds_replayed"] < s["rounds"]
    assert stubs and all(g.replays >= 1 for g in stubs[:1])


def _peaks_by_kind(monkeypatch, sizes):
    """Round programs' first runs measure ``sizes[kind]`` bytes of peak (the
    card's measurement, which the CPU does not make)."""
    def memory(self, fn):
        fn()
        return 0, sizes.get(self.key[0], 1)
    monkeypatch.setattr(program.RoundProgram, "_memory", memory)


@pytest.mark.parametrize("case", ["below_every_key", "between_keys", "refused_for_good"])
def test_pool_over_budget_runs_uncaptured(stubs, monkeypatch, case):
    """A key whose captures would take the pool past the budget runs
    uncaptured for the rest of the build, and nothing raises: with the
    budget below every key's measured peak, no key captures; between the
    constructions' peak and the others', the constructions run uncaptured and
    the rest capture; both builds write the eager build's tables bit for
    bit. A key refused once is never captured, even when the budget would
    admit it later."""
    _peaks_by_kind(monkeypatch, {"build": 1000})
    if case == "refused_for_good":
        bt, cfg, batches = _rounds(np.random.default_rng(10), k=4)
        eager = _eager_copy(bt)
        progs = _programs(stubs)
        budget = [-1.0]
        monkeypatch.setattr(program.BuildPrograms, "_budget", lambda self: budget[0])
        for r, (bidx, entry) in enumerate(batches):
            round_step(eager.vectors, eager.sqnorms, eager.levels, eager.tables(), bidx,
                       entry, None, eager.indeg0, cfg=cfg)
            progs.round(bt, cfg, bidx, entry)
            _assert_state_equal(bt, eager, bt.cap1 - 1)
            if r == 1:
                budget[0] = float("inf")
        assert not stubs
        assert all(p.captured is False and p.runs == 4 for p in progs._progs.values())
        s = progs.stats
        assert s["uncaptured_keys"] == s["keys"] > 0 and s["captures"] == 0
        assert (s["rounds"], s["rounds_replayed"]) == (4, 0)
        return
    monkeypatch.setattr(program.BuildPrograms, "_budget",
                        lambda self: -1.0 if case == "below_every_key" else 500.0)
    seen = {}  # key -> (runs, captured) when the build drops its programs
    clear = program.BuildPrograms.clear
    monkeypatch.setattr(program.BuildPrograms, "clear", lambda self: seen.update(
        {key: (p.runs, p.captured) for (_, key), p in self._progs.items()}) or clear(self))
    X = np.random.default_rng(6).random((800, 8)).astype(np.float32)
    eager = _build(X, None, batch=64)
    made = []
    h = _build(X, stubs, batch=64, made=made)
    _assert_same_graph(h, eager)
    s = h._round_stats
    assert s["first_runs"] == s["keys"] == len(seen) > 0 and s["peaks"]["build"] == 1000
    assert s["uncaptured"]["build"] >= 1000
    # a key seen in one round only (the cold start's) never reaches a decision
    again = [c for runs, c in seen.values() if runs > 1]
    assert all(c is None for runs, c in seen.values() if runs == 1)
    if case == "below_every_key":
        assert s["uncaptured_keys"] == len(again) and not any(again)
        assert s["captures"] == 0 and not stubs
        assert s["rounds_replayed"] == 0 and "head" in s["uncaptured"]
    else:
        assert 0 < s["uncaptured_keys"] < s["keys"] and s["captures"] > 0 and stubs
        assert set(s["uncaptured"]) == {"build"}
    assert not made[0]._progs and not made[0]._pool


class _FakeCard:
    """``torch.cuda``'s allocated bytes and peak statistics, as the caching
    allocator keeps them (reserved bytes never return)."""

    def __init__(self):
        self.allocated = self.peak = self.reserved = self.peak_reserved = 0
        self.resets = 0

    def alloc(self, n):
        self.allocated += n
        self.reserved = max(self.reserved, self.allocated)
        self.peak, self.peak_reserved = (max(self.peak, self.allocated),
                                         max(self.peak_reserved, self.reserved))

    def reset(self, device=None):
        self.peak, self.peak_reserved = self.allocated, self.reserved
        self.resets += 1

    def patch(self, monkeypatch):
        for name, fn in dict(memory_allocated=lambda d=None: self.allocated,
                             max_memory_allocated=lambda d=None: self.peak,
                             max_memory_reserved=lambda d=None: self.peak_reserved,
                             reset_peak_memory_stats=self.reset,
                             current_device=lambda: 0).items():
            monkeypatch.setattr(torch.cuda, name, fn)


@pytest.mark.parametrize("caller, piece", [(5000, 3000), (2000, 7000)],
                         ids=["caller-higher", "build-higher"])
def test_peak_memory_across_a_build(stubs, monkeypatch, caller, piece):
    """A build's first runs reset the card's peak statistics to measure their
    pieces; ``peak_memory`` across the build still gives the larger of the
    caller's peak and the build's, where ``torch.cuda``'s own peak reads only
    what followed the last reset."""
    card = _FakeCard()
    card.patch(monkeypatch)
    real = program.RoundProgram._memory
    on_card = type("OnCard", (), {"device": torch.device("cuda", 0)})()

    def memory(self, fn):
        def run():
            card.alloc(piece)
            fn()
            card.alloc(-piece)
        return real(on_card, run)

    monkeypatch.setattr(program.RoundProgram, "_memory", memory)
    program.reset_peak_memory("cuda:0")
    card.alloc(caller)
    card.alloc(100 - caller)  # the caller keeps 100 bytes through the build
    X = np.random.default_rng(6).random((800, 8)).astype(np.float32)
    h = _build(X, stubs, batch=64)
    assert card.resets > 1 and h._round_stats["peaks"]["build"] == piece
    want = max(caller, 100 + piece)
    assert program.peak_memory("cuda:0") == (want, want)
    assert torch.cuda.max_memory_allocated(0) == 100 + piece
    program.reset_peak_memory("cuda:0")
    assert program.peak_memory("cuda:0") == (100, want)


def test_build_leaves_no_program_alive(stubs):
    """A build's round programs are freed when it ends, without the cycle
    collector: none holds the build's tensors into the next phase."""
    X = np.random.default_rng(8).random((600, 8)).astype(np.float32)
    gc.collect()
    gc.disable()
    try:
        h = _build(X, stubs, batch=64)
        alive = [o for o in gc.get_objects() if type(o) is program.RoundProgram]
    finally:
        gc.enable()
    assert h._round_stats["captures"] > 0 and alive == []


def _round_setup(rng):
    """The state of ``test_torch_build.py::test_round_step_identical``: a
    600-point build and 256 new points; per package (tables, st, cfg, bidx,
    entry, extra) for one round."""
    h = _base(rng)
    state = to_arrays(h)
    X2 = rng.random((256, 16)).astype(np.float32)
    ids2 = np.arange(600, 856)
    out = {}
    for pkg, hnsw in (("torch", from_arrays(state, params_of(h), device="cpu")),
                      ("jax", jax_from_state(state, h))):
        mod = tir if pkg == "torch" else jir
        st = mod.HostBuildState(hnsw, (X2, ids2))
        Br = st.ramp(256)
        max_obs, nonempty = st.entry_level, tuple(bool(c > 0) for c in st.counts)
        entry = st.entry
        bidx, n_hi = st.round_batch(Br)
        B1 = 0 if n_hi == 0 else int(min(Br, mod._next_pow2(max(8, n_hi))))
        cfg = mod.RoundConfig(B=Br, cap1=st.cap1, num_layers=st.L, widths=st.widths,
                              efc=48, M=8, metric="L2", expand=8, max_obs=max_obs,
                              nonempty=nonempty, keep_pruned=False, B1=B1)
        out[pkg] = (st, cfg, bidx, entry)
    return out


def _tensors(st):
    vec = torch.from_numpy(st.vec_np())
    tables = [(torch.from_numpy(i), torch.from_numpy(d)) for i, d in st.tables_np()]
    return BuildTensors(vec, (vec * vec).sum(-1), torch.from_numpy(st.levels_np()), tables,
                        None, torch.from_numpy(st.indeg0_np()))


def _np_state(bt):
    return ([(i.numpy().copy(), d.numpy().copy()) for i, d in bt.tables()],
            bt.indeg0.numpy().copy())


def test_round_program_equals_jax(rng, stubs):
    """One round through the round programs from the state of
    ``test_round_step_identical`` writes what the JAX package's jitted
    ``_round_step`` writes: ids and in-degrees equal, dists within 1e-5, on
    every real row."""
    setup = _round_setup(rng)
    st, cfg, bidx, entry = setup["torch"]
    bt = _tensors(st)
    progs = _programs(stubs)
    progs.round(bt, cfg, bidx, entry)
    tt, it = _np_state(bt)
    st_j, cfg_j, bidx_j, entry_j = setup["jax"]
    tables = tuple((jnp.asarray(i), jnp.asarray(d)) for i, d in st_j.tables_np())
    vec = jnp.asarray(st_j.vec_np())
    tj, ij = jir._round_step(vec, (vec * vec).sum(-1), jnp.asarray(st_j.levels_np()), tables,
                             jnp.asarray(bidx_j), jnp.int32(entry_j), None,
                             jnp.asarray(st_j.indeg0_np()), cfg=cfg_j)
    n = st.n_total
    assert len(tt) == len(tj)
    for (a_i, a_d), (b_i, b_d) in zip(tt, tj):
        np.testing.assert_array_equal(a_i[:n], np.array(b_i)[:n])
        np.testing.assert_allclose(a_d[:n], np.array(b_d)[:n], rtol=1e-5)
    np.testing.assert_array_equal(it[:n], np.array(ij)[:n])


def _rounds(rng, k=3):
    """The 600-point build and ``k`` rounds of 128 new points each, all with
    one key (B=128, B1=0, the same levels), each with another entry point:
    (BuildTensors, cfg, [(bidx, entry)])."""
    h = _base(rng)
    X2 = rng.random((k * 128, 16)).astype(np.float32)
    st = tir.HostBuildState(h, (X2, np.arange(600, 600 + len(X2))))
    st.hnsw._level[st.n0:st.n_total] = 0  # every new point on layer 0 only
    cfg = RoundConfig(B=128, cap1=st.cap1, num_layers=st.L, widths=st.widths, efc=48, M=8,
                      metric="L2", expand=8, max_obs=st.entry_level,
                      nonempty=tuple(bool(c > 0) for c in st.counts), keep_pruned=False)
    level0 = np.flatnonzero(h._level[:600] == 0)
    batches = [(st.round_batch(128)[0], int(level0[r])) for r in range(k)]
    return _tensors(st), cfg, batches


def _eager_copy(bt):
    tables = [(i.clone(), d.clone()) for i, d in bt.tables()]
    return BuildTensors(bt.vectors, bt.sqnorms, bt.levels, tables, None, bt.indeg0.clone())


def _assert_state_equal(a, b, n):
    (ta, ia), (tb, ib) = _np_state(a), _np_state(b)
    for (x_i, x_d), (y_i, y_d) in zip(ta, tb):
        np.testing.assert_array_equal(x_i[:n], y_i[:n])
        np.testing.assert_array_equal(x_d[:n], y_d[:n])
    np.testing.assert_array_equal(ia[:n], ib[:n])


def test_capture_policy_and_entry_promotion(rng, stubs):
    """Three rounds with one key and three entry points (an entry promotion
    between rounds of one key): the first runs its pieces uncaptured, the
    second captures (running nothing) and replays, the third replays (a
    chunk is captured when a captured run first reaches it); each round,
    applied once, writes the eager round's tables bit for bit."""
    bt, cfg, batches = _rounds(rng)
    eager = _eager_copy(bt)
    progs = _programs(stubs)
    n = bt.cap1 - 1
    for r, (bidx, entry) in enumerate(batches):
        round_step(eager.vectors, eager.sqnorms, eager.levels, eager.tables(), bidx, entry,
                   None, eager.indeg0, cfg=cfg)
        progs.round(bt, cfg, bidx, entry)
        _assert_state_equal(bt, eager, n)
        keys = len(progs._progs)
        if r == 0:
            assert not stubs and progs.stats["first_runs"] == keys
        elif r == 1:
            assert len(stubs) > 0 and progs.stats["captures"] == keys
            fixed = [[q.graph for q in p._pieces_fixed] for p in progs._progs.values()]
            assert all(g.replays == 1 for g, *_ in fixed)
        else:  # nothing captured again; chunks no earlier run reached may be
            assert [[q.graph for q in p._pieces_fixed]
                    for p in progs._progs.values()] == fixed
            assert all(g.replays == 2 for g, *_ in fixed)
    s = progs.stats
    assert (s["rounds"], s["rounds_replayed"], s["captures"]) == (3, 2, s["keys"])
    assert len({e for _, e in batches}) == 3
    assert int(progs._states[128].entry[0]) == batches[-1][1]


def test_loops_end_mid_chunk(rng, stubs):
    """The descent stops after its first chunk of hops and the beam before
    its cap (56 iterations in 7 chunks), both mid-chunk; the chunks after the
    flag are skipped, never captured, and the answers are the eager
    round's."""
    bt, cfg, batches = _rounds(rng, k=2)
    eager = _eager_copy(bt)
    progs = _programs(stubs)
    for bidx, entry in batches:
        round_step(eager.vectors, eager.sqnorms, eager.levels, eager.tables(), bidx, entry,
                   None, eager.indeg0, cfg=cfg)
        progs.round(bt, cfg, bidx, entry)
    _assert_state_equal(bt, eager, bt.cap1 - 1)
    by_kind = {key[0]: p for (_, key), p in progs._progs.items()}
    for kind, n_chunks in (("descent", 8), ("build", 7)):
        p = by_kind[kind]
        assert p.n_chunks == n_chunks
        # the second round captured and replayed chunks 0..j, whose flags it set
        replays = [c.graph.replays if c is not None else 0 for c in p._chunks]
        j = replays.count(1) - 1
        assert replays == [1] * (j + 1) + [0] * (n_chunks - j - 1), (kind, replays)
        assert all(c is None for c in p._chunks[j + 1:])
        assert 0 <= j < n_chunks - 1 and bool(p._flags[j]), (kind, replays)


@pytest.mark.parametrize("efc", [16, 48], ids=["widen", "keep"])
def test_extend_branches(stubs, monkeypatch, efc):
    """``extend_candidates`` on: the host reads ``need.any()`` and replays the
    widen or the keep piece. At ef_construction 16 every beam returns at most
    2M = 16 candidates, so every round widens; at 48 the steady rounds keep
    (the first rounds, on a graph of fewer than 2M points, widen). Both
    builds equal the eager ones, and the layer-0 construction's captured
    widen (16) or keep (48) piece replays."""
    picks = {"widen": 0, "keep": 0}
    for name in picks:
        fn = getattr(tir.BuildPart, name)
        monkeypatch.setattr(tir.BuildPart, name,
                            lambda self, fn=fn, name=name: picks.__setitem__(
                                name, picks[name] + 1) or fn(self))
    monkeypatch.setattr(program.BuildPrograms, "clear", lambda self: None)
    rng = np.random.default_rng(9)
    X = rng.random((1300, 8)).astype(np.float32)
    kw = dict(params={"ef_construction": efc}, setup={"set_extend_candidates": True})
    eager = _build(X, None, batch=256, **kw)
    assert not stubs
    assert picks["widen"] > 0 and (efc == 16) == (picks["keep"] == 0)
    eager_picks = dict(picks)
    picks.update(widen=0, keep=0)
    made = []
    h = _build(X, stubs, batch=256, made=made, **kw)
    _assert_same_graph(h, eager)
    assert picks == eager_picks
    (progs,) = made
    (layer0,) = [p for (_, key), p in progs._progs.items()
                 if key[0] == "build" and key[2] == 0 and key[1] == 256]
    widen, keep = (piece.graph.replays for piece in layer0._pieces_fixed[-3:-1])
    assert widen + keep == layer0.runs - 1 > 0
    assert (widen > 0, keep > 0) == ((True, False) if efc == 16 else (False, True))
    s = h._round_stats
    assert (s["widen_replays"], s["keep_replays"]) == (widen, keep)


def _masked_counts(counts, idx, take, value):
    sel = idx[take].long()
    counts.index_add_(0, sel, torch.full(sel.shape, value, dtype=counts.dtype))


@pytest.mark.parametrize("shape", [(50, 7), (3000,)])
def test_add_counts_fixed_shape(shape):
    """The fixed-shape ``_add_counts`` equals the masked form, with -1
    indices, duplicates and more entries than rows."""
    rng = np.random.default_rng(len(shape))
    idx = torch.from_numpy(rng.integers(-1, 40, shape).astype(np.int32))
    take = (idx >= 0) & torch.from_numpy(rng.random(shape) < 0.7)
    for value in (1, -1):
        a = torch.from_numpy(rng.integers(0, 5, 41).astype(np.int32))
        b = a.clone()
        tir._add_counts(a, idx, take, value)
        _masked_counts(b, idx, take, value)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _fractured(rng, R=300, W=6):
    """A link table of several islands: a long chain (many sweeps), random
    clusters, isolated rows, and dead rows past ``n``."""
    tbl = np.full((R, W), -1, np.int32)
    for i in range(99):  # rows 0..99: a chain 99 -> ... -> 0, directed one way
        tbl[i + 1, 0] = i
    for lo in (100, 160, 220):  # three random clusters of 50
        for i in range(lo, lo + 50):
            tbl[i, :3] = rng.integers(lo, lo + 50, 3)
    return tbl


@pytest.mark.parametrize("max_sweeps", [512, 13], ids=["converged", "capped"])
def test_label_prop_chunked_reads_equal_jax(max_sweeps):
    """``_label_prop`` reading the host once per CHUNK sweeps answers the JAX
    package's labels, converged and cut at a cap that is not a multiple of
    CHUNK."""
    rng = np.random.default_rng(4)
    tbl = _fractured(rng)
    live = np.arange(len(tbl)) < 280
    got = components._label_prop(torch.from_numpy(tbl), torch.from_numpy(live), max_sweeps)
    want = jcomp._label_prop(jnp.asarray(tbl), jnp.asarray(live), max_sweeps=max_sweeps)
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    if max_sweeps == 512:
        assert len(np.unique(got.numpy()[:280])) > 30  # islands
        np.testing.assert_array_equal(components.component_labels(tbl, 280), got.numpy()[:280])


def _one_shot(g, kind, id_rows):
    """The codec blocks as one gather (the form the chunked build replaced)."""
    tbl = g.layer_ids[0]
    cap1, M0 = tbl.shape
    d = g.vectors.shape[1]
    v = g.vectors.to(torch.float32)
    if kind == "bf16":
        vq = v.to(torch.bfloat16)
    else:
        amax = torch.clamp_min(v.abs().max(), 1e-12)
        vq = torch.clamp(torch.round(v * (127.0 / amax)), -127, 127).to(torch.int8)
    blocks = vq[torch.clamp(tbl, 0, cap1 - 1).long()]
    if id_rows:
        idp = torch.full((cap1, id_rows * d // 4), -1, dtype=torch.int32)
        idp[:, :M0] = tbl
        blocks = torch.cat([blocks, idp.view(torch.int8).reshape(cap1, id_rows, d)], 1)
    return blocks.contiguous()


@pytest.mark.parametrize("d,kind,id_rows", [(128, "i8", 8), (16, "i8", 0), (128, "bf16", 0)])
def test_chunked_codec_equals_one_shot(d, kind, id_rows, monkeypatch):
    """The codec's chunked block build, with chunks of 7 rows (which do not
    divide cap1) and with the default chunk, is byte-equal to a one-shot
    gather, with and without id rows; the i8 blocks are the JAX codec's."""
    rng = np.random.default_rng(d)
    X = rng.standard_normal((300, d)).astype(np.float32)
    h = Hnsw(max_nb_connection=8, max_elements=300, ef_construction=32, dist="L2",
             device="cpu")
    h.parallel_insert(X, mode="serial")
    g = h.device_graph()
    want = _one_shot(g, kind, id_rows)
    assert g.cap1 % 7 != 0
    row_bytes = want[0].numel() * want.element_size()
    sq = graph_arrays.BeamCodec._build(g, kind, 0, None).blocks_sq
    for chunk in (7 * row_bytes + row_bytes // 2, graph_arrays.CODEC_CHUNK_BYTES):
        monkeypatch.setattr(graph_arrays, "CODEC_CHUNK_BYTES", chunk)
        c = graph_arrays.BeamCodec._build(g, kind, 0, None)
        assert c.id_rows == id_rows and c.blocks.is_contiguous()
        assert c.blocks.view(torch.uint8 if kind == "i8" else torch.int16).numpy().tobytes() \
            == want.view(torch.uint8 if kind == "i8" else torch.int16).numpy().tobytes()
        assert c.blocks_sq.numpy().tobytes() == sq.numpy().tobytes()
    if kind == "i8":
        from hnsw_tpu import Hnsw as JHnsw
        hj = JHnsw(max_nb_connection=8, max_elements=300, ef_construction=32, dist="L2")
        hj.parallel_insert(X, mode="serial")
        cj = jga.BeamCodec.build(hj.device_graph(), kind="i8")
        assert np.array(cj.blocks).tobytes() == want.numpy().tobytes()


def test_kmeans_program_equals_direct_and_jax():
    """The k-means step's program (``KmeansProgram``; on the CPU its piece
    runs on every call) answers ``_kmeans_assign`` and the JAX package's
    jitted ``_kmeans_assign``: assignments and alternates equal, sums and
    counts within f32 rounding."""
    rng = np.random.default_rng(12)
    X = rng.standard_normal((700, 24)).astype(np.float32)
    cent = X[rng.permutation(700)[:40]]
    Xt, ct = torch.from_numpy(X), torch.from_numpy(cent)
    csq = (ct * ct).sum(-1)
    prog = program.KmeansProgram(700, 40, 24, "cpu")
    got = prog.run(Xt, ct, csq)
    direct = tivf._kmeans_assign(Xt, ct, csq, 40)
    for a, b in zip(got, direct):
        assert torch.equal(a, b)
    cj = jnp.asarray(cent)
    want = jivf._kmeans_assign(jnp.asarray(X), cj, (cj * cj).sum(-1), C=40)
    np.testing.assert_array_equal(got[0].numpy(), np.array(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.array(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.array(want[2]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), np.array(want[3]))


def test_kmeans_one_program_per_chunk_shape(monkeypatch):
    """``_kmeans`` builds one program for its full chunks and one for the
    ragged tail, and answers as the JAX package's ``_kmeans``."""
    made = []
    real = tivf.KmeansProgram
    monkeypatch.setattr(tivf, "KmeansProgram",
                        lambda rows, C, d, device: made.append(rows) or real(rows, C, d, device))
    rng = np.random.default_rng(13)
    X = rng.standard_normal((1000, 8)).astype(np.float32)
    cent, top4 = tivf._kmeans(X, 16, 3, seed=7, chunk=300, device="cpu")
    assert sorted(made) == [100, 300]
    cj, tj = jivf._kmeans(X, 16, 3, seed=7, chunk=300)
    np.testing.assert_array_equal(top4, np.array(tj))
    np.testing.assert_allclose(cent, np.array(cj), rtol=1e-5, atol=1e-5)
