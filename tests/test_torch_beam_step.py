"""The beam iteration's bookkeeping (``hnsw_tpu_torch/ops/beam_step.py``).

On the CPU every function runs its plain version: the iteration must answer
bit for bit as the code it replaced (kept below as ``_old_step``), the route
must take the plain version for a CPU tensor, and the kernels' shared-memory
plan must count its bytes and refuse a shape past a block's memory before any
launch. The ``cuda``-marked tests hold the kernels (``csrc/beam_step.cu``)
to the plain versions on the card, bit for bit, after every iteration, and
drive a whole search and a whole build through them."""

import contextlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from hnsw_tpu_torch.ops import beam_step as bstep
from hnsw_tpu_torch.ops import kernel_lib
from hnsw_tpu_torch.ops.beam_search import BeamState, beam_setup, beam_step, scores_codec
from hnsw_tpu_torch.ops.beam_step import (_first_occurrence_dups, _member, _merge_beam,
                                          smallest)
from hnsw_tpu_torch.ops.graph_arrays import BeamCodec
from hnsw_tpu_torch.ops.id_scores import id_scores, id_scores_plain

INF = float("inf")


# ---- the iteration as it was before ``ops/beam_step.py`` (verbatim) ----

def _old_select(st):
    beam_exp = _member(st.beam_ids, st.hist)
    cand_d = torch.where(beam_exp | (st.beam_ids < 0), INF, st.beam_d)
    sel_d, pos = smallest(cand_d, st.E)
    nearest_d = sel_d[:, 0]
    worst = st.beam_d[:, st.ef - 1]
    if st.term_slack == 1.0:
        thresh = worst
    else:
        thresh = torch.where(torch.isfinite(worst),
                             worst + (st.term_slack - 1.0) * worst.abs(), INF)
    step_done = st.done | (nearest_d == INF) | (nearest_d > thresh)
    return step_done, ~step_done, sel_d, pos


def _old_expand(st, it, step_done, act, sel_d, pos):
    B, E, M, K, cap1 = st.beam_ids.shape[0], st.E, st.M, st.K, st.cap1
    sel_ok = act[:, None] & (sel_d < INF)
    src = torch.gather(st.beam_ids, 1, pos)
    slot = (it % st.n_slots) * E
    st.hist[:, slot:slot + E] = torch.where(sel_ok, src, -2)
    src_c = torch.clamp(src, 0, cap1 - 1)
    sc = None
    if st.codec is not None:
        sc, nbr = scores_codec(st.codec, st.q, src_c, st.qsq, st.qnorm, st.allow_fused)
    codec_ids = (st.allow_fused and st.codec is not None and st.codec.id_rows > 0
                 and st.codec.M0 == M and st.codec.blocks.dtype == torch.int8)
    if not codec_ids:
        nbr = st.tbl_ids[src_c.long()].reshape(B, K)
    valid = sel_ok[:, :, None].expand(B, E, M).reshape(B, K) & (nbr >= 0)
    in_beam = _member(nbr, st.beam_ids)
    in_hist = _member(nbr, st.hist)
    dup = _first_occurrence_dups(nbr, valid)
    valid = valid & ~in_beam & ~in_hist & ~dup
    new_ids = torch.where(valid, nbr, -1)
    if sc is None:
        sc = id_scores(st.metric_name, st.q, st.vectors, st.sqnorms, new_ids)
    else:
        sc = torch.where(valid, sc, INF)
    st.beam_ids, st.beam_d = _merge_beam(st.beam_ids, st.beam_d, new_ids, sc, st.ef)
    if st.use_mask:
        passf = valid & st.mask[torch.where(valid, nbr, cap1 - 1).long()]
        st.res_ids, st.res_d = _merge_beam(st.res_ids, st.res_d,
                                           torch.where(passf, nbr, -1),
                                           torch.where(passf, sc, INF), st.ef)
    if st.R:
        c_ids = torch.where(passf, nbr, -1) if st.use_mask else new_ids
        c_d = torch.where(passf, sc, INF) if st.use_mask else sc
        st.pool_ids, st.pool_d = _merge_beam(st.pool_ids, st.pool_d, c_ids, c_d, st.R)
    st.done = step_done


def _old_step(st, it):
    _old_expand(st, it, *_old_select(st))


# ---- states ----

def _codec(rng, X, tbl, scale=0.02):
    """An int8 codec whose id rows carry ``tbl`` (``BeamCodec``'s layout)."""
    N, M0 = tbl.shape
    d = X.shape[1]
    rid = max(1, -(-4 * M0 // d))
    rid += (-(M0 + rid)) % 8
    vec = np.clip(np.rint(X[np.maximum(tbl, 0)] / scale), -127, 127).astype(np.int8)
    idp = np.full((N, rid * d // 4), -1, np.int32)
    idp[:, :M0] = tbl
    blocks = np.concatenate([vec, idp.view(np.int8).reshape(N, rid, d)], axis=1)
    deq = vec.astype(np.float32) * np.float32(scale)
    return BeamCodec(blocks=torch.from_numpy(blocks),
                     blocks_sq=torch.from_numpy((deq * deq).sum(-1)),
                     scale=torch.tensor(scale, dtype=torch.float32), M0=M0, dim=d,
                     metric_name="L2", id_rows=rid)


def _state(seed, *, N, d, M, B, ef, E, dup_rows=0, dtype=torch.float32, mask=False,
           pool=0, codec=None, allow_fused=True, term_slack=1.0, max_iters=None,
           inactive=False, device="cpu"):
    """A beam's set-up on a random graph: ``N`` rows (copies of ``dup_rows``
    distinct rows where given, so distances tie), ``M`` random links a row
    with repeats and -1s, four start entries a query sorted by distance."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, d)).astype(np.float32)
    if dup_rows:
        X = X[rng.integers(0, dup_rows, N)]
    tbl = rng.integers(0, N - 1, (N, M)).astype(np.int32)
    tbl[rng.random((N, M)) < 0.1] = -1
    tbl[N - 1] = -1  # the sink row
    Q = rng.standard_normal((B, d)).astype(np.float32)
    Xt = torch.from_numpy(X)
    vectors = Xt.to(dtype)
    sq = (vectors.float() ** 2).sum(-1)
    q = torch.from_numpy(Q)
    starts = torch.from_numpy(rng.integers(0, N - 1, (B, 4)).astype(np.int32))
    sd, o = torch.sort(id_scores_plain("L2", q, vectors, sq, starts), dim=1, stable=True)
    starts = torch.gather(starts, 1, o)
    m = torch.from_numpy(rng.random(N) < 0.5) if mask else None
    cdc = _codec(rng, X, tbl) if codec else None
    active = torch.zeros(B, dtype=torch.bool) if inactive else None
    dev = torch.device(device)

    def on(x):
        return None if x is None else x.to(dev)

    if cdc is not None:
        cdc = BeamCodec(blocks=on(cdc.blocks), blocks_sq=on(cdc.blocks_sq),
                        scale=on(cdc.scale), M0=cdc.M0, dim=cdc.dim,
                        metric_name=cdc.metric_name, id_rows=cdc.id_rows)
    return beam_setup("L2", on(vectors), on(sq), on(torch.from_numpy(tbl)), on(q),
                      on(starts), on(sd), ef=ef, expand=E, mask=on(m), active=on(active),
                      max_iters=max_iters, codec=cdc, term_slack=term_slack, pool=pool,
                      allow_fused=allow_fused)


def _snapshot(st):
    return {f: getattr(st, f).clone() for f in (*BeamState.CARRY, "hist")
            if getattr(st, f) is not None}


def _assert_same(a, b, where):
    assert a.keys() == b.keys(), where
    for f in a:
        assert a[f].dtype == b[f].dtype and torch.equal(a[f], b[f]), (where, f)


CASES = {
    "plain": dict(),
    "mask_pool": dict(mask=True, pool=40),
    "pool": dict(pool=40),
    "codec_ids_slack": dict(codec=True, term_slack=1.1),
    "codec_gathered": dict(codec=True, allow_fused=False),
    "bf16_ring_wraps": dict(dtype=torch.bfloat16, E=8, ef=16, max_iters=30),
    "ties": dict(dup_rows=60),
    "all_done": dict(inactive=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_iteration_equals_the_code_it_replaced(case):
    """Every iteration of ``beam_step`` on the CPU leaves the beams, the
    reservoir, ``done`` and the ring as the replaced code did."""
    kw = dict(N=400, d=16, M=8, B=23, ef=24, E=4)
    kw.update(CASES[case])
    old, new = _state(5, **kw), _state(5, **kw)
    assert old.n_slots < old.max_iters or case != "bf16_ring_wraps"
    for it in range(old.max_iters):
        _old_step(old, it)
        beam_step(new, it)
        _assert_same(_snapshot(old), _snapshot(new), (case, it))


def test_plain_route_on_cpu_tensors_launches_nothing():
    """On CPU tensors ``select`` and ``merge`` are their plain versions, and
    no kernel launch is counted."""
    st = _state(3, N=300, d=8, M=6, B=9, ef=12, E=3)
    kernel_lib.reset_launch_counts()
    h1, h2 = st.hist.clone(), st.hist.clone()
    args = dict(slot=3, E=3, term_slack=1.0, cap1=st.cap1, tbl_ids=st.tbl_ids)
    got = bstep.select(st.beam_ids, st.beam_d, h1, st.done, **args)
    want = bstep.select_plain(st.beam_ids, st.beam_d, h2, st.done, **args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(h1, h2)
    sc = torch.rand(got[2].shape)
    for a, b in zip(bstep.merge(st.beam_ids, st.beam_d, got[2], sc, 12),
                    _merge_beam(st.beam_ids, st.beam_d, got[2], sc, 12)):
        assert torch.equal(a, b)
    assert kernel_lib.LAUNCHES["beam_step"] == 0
    assert "beam_step" in kernel_lib.SOURCES
    assert set(kernel_lib.BEAM_STEP_ENTRIES) == {"fused", "merge"}


# the cells' shapes: sift1m.batch and every card of sift4m.cards serve at ef
# 128, E 4, M0 96 (a ring of 4 x 34 ids); the build runs efC 800, E 8, M0 96
# (a ring of 8 x 216 ids, the reservoir-free merge of 800 + 768); beside them
# a k = 100 search at ef 192, E 8 (26 iterations), and the card tests'
# mask_pool and ties shapes
@pytest.mark.parametrize("W,H,K,E,want", [
    (128, 136, 384, 4, (128, 10, 10_800)),
    (800, 1728, 768, 8, (256, 12, 42_336)),
    (192, 208, 768, 8, (256, 11, 21_088)),
    (64, 160, 128, 4, (128, 9, 5_168)),
    (96, 120, 192, 4, (128, 9, 5_680)),
])
def test_select_plan_at_the_cells_shapes(W, H, K, E, want):
    assert bstep.select_plan(W, H, K, E) == want


@pytest.mark.parametrize("W,K,want", [(128, 384, (128, 512, 4_608)),
                                      (800, 768, (256, 1024, 11_392)),
                                      (256, 384, (128, 512, 5_120))])
def test_merge_plan_at_the_cells_shapes(W, K, want):
    assert bstep.merge_plan(W, K) == want


@pytest.mark.parametrize("entry,W,H,K", [
    ("fused", 30_000, 80, 768),        # the beam's selection keys
    ("fused", 128, 32_000, 768),       # the ring's hash table
    ("merge", 128, 0, 40_000),         # the candidates' keys
    ("merge", 60_000, 0, 384),         # the beam's
])
def test_a_shape_past_shared_memory_raises_with_its_sizes(entry, W, H, K):
    """A request past a block's shared memory raises before anything is
    allocated or launched (meta tensors hold no memory), naming its sizes."""
    B, E = 4, 8
    meta = dict(device="meta")
    beam_ids = torch.empty((B, W), dtype=torch.int32, **meta)
    beam_d = torch.empty((B, W), **meta)
    with pytest.raises(ValueError, match=r"beam_step\.%s: a beam of %d.*shared memory"
                       % (entry, W)):
        if entry == "merge":
            bstep._launch_merge(beam_ids, beam_d, torch.empty((B, K), dtype=torch.int32,
                                                              **meta),
                                torch.empty((B, K), **meta), W)
        else:
            bstep._launch_select(beam_ids, beam_d,
                                 torch.empty((B, H), dtype=torch.int32, **meta),
                                 torch.empty((B,), dtype=torch.bool, **meta), slot=0, E=E,
                                 term_slack=1.0, cap1=100,
                                 tbl_ids=torch.empty((100, K // E), dtype=torch.int32, **meta))


# ---- on the card ----

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile with nvcc for sm_90a")
    return torch.device("cuda")


@contextlib.contextmanager
def _plain_route():
    """Every beam iteration through the plain versions, on any device."""
    saved = bstep.select, bstep.merge
    bstep.select, bstep.merge = bstep.select_plain, _merge_beam
    try:
        yield
    finally:
        bstep.select, bstep.merge = saved


CARD_CASES = {
    # sift1m.batch's shape: ef 128, E 4, M0 96, serve_static's 34 iterations
    "serving": dict(N=50_000, d=128, M=96, B=1_003, ef=128, E=4, max_iters=34),
    # the build's: efC 800, E 8, M0 96, bf16 rows, 432 iterations over 216 slots
    "build": dict(N=50_000, d=128, M=96, B=300, ef=800, E=8, dtype=torch.bfloat16),
    "mask_pool": dict(N=20_000, d=64, M=32, B=500, ef=64, E=4, mask=True, pool=256,
                      max_iters=40),
    "codec_ids_slack": dict(N=20_000, d=128, M=96, B=700, ef=128, E=4, codec=True,
                            term_slack=1.1, max_iters=34),
    "codec_gathered": dict(N=20_000, d=128, M=96, B=300, ef=64, E=4, codec=True,
                           allow_fused=False, max_iters=20),
    "ties": dict(N=20_000, d=32, M=48, B=513, ef=96, E=4, dup_rows=700, max_iters=30),
    "all_done": dict(N=5_000, d=32, M=16, B=77, ef=32, E=4, inactive=True, max_iters=6),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernels_equal_plain_every_iteration_on_card(case):
    """The kernel route and the plain route, run side by side on the card from
    one set-up, hold equal beams, reservoirs, rings and ``done`` after every
    iteration; and the kernel route launched the kernels."""
    dev = _card()
    kw = CARD_CASES[case]
    a, b = _state(11, device=dev, **kw), _state(11, device=dev, **kw)
    kernel_lib.reset_launch_counts()
    for it in range(a.max_iters):
        with _plain_route():
            beam_step(a, it)
        beam_step(b, it)
        _assert_same(_snapshot(a), _snapshot(b), (case, it))
    torch.cuda.synchronize()
    assert kernel_lib.LAUNCHES["beam_step.fused"] > 0
    assert kernel_lib.LAUNCHES["beam_step.merge"] > 0
    if case == "build":
        assert a.max_iters > a.n_slots


def _step_inputs(seed, B, W, H, E, M, N, dev):
    """One iteration's inputs with a full ring: beams ascending with +INF
    tails and ids shared with the ring, a link table with repeats and -1s."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randint(0, 50, (B, W), generator=g).float()
    d[torch.rand((B, W), generator=g) < 0.2] = INF
    d = torch.sort(d, dim=1).values
    ids = torch.randint(0, N, (B, W), generator=g, dtype=torch.int32)
    ids = torch.where(d < INF, ids, -1)
    ring = torch.randint(0, N, (B, H), generator=g, dtype=torch.int32)
    ring[:, :W // 2] = ids[:, :W // 2].clamp_min(0)  # expanded beam entries
    tbl = torch.randint(-1, N, (N, M), generator=g, dtype=torch.int32)
    done = torch.rand((B,), generator=g) < 0.1
    return [x.to(dev) for x in (ids, d, ring, tbl, done)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["serving", "build"])
def test_one_step_with_a_full_ring_equals_plain_on_card(shape):
    """``select`` and ``merge`` at the cells' shapes on a ring that is full,
    with the slot written in its middle (the wrap-around), against their
    plain versions: bit for bit."""
    dev = _card()
    B, W, E, M, slots = (1_000, 128, 4, 96, 34) if shape == "serving" else \
        (257, 800, 8, 96, 216)
    H, N = E * slots, 3_000
    ids, d, ring, tbl, done = _step_inputs(7, B, W, H, E, M, N, dev)
    for slack in (1.0, 1.25):
        for it in (slots // 2, slots + 3):
            slot = (it % slots) * E
            args = dict(slot=slot, E=E, term_slack=slack, cap1=N)
            h_k, h_p = ring.clone(), ring.clone()
            got = bstep.select(ids, d, h_k, done, tbl_ids=tbl, **args)
            want = bstep.select_plain(ids, d, h_p, done, tbl_ids=tbl, **args)
            assert torch.equal(h_k, h_p)
            assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
            sel = want[0].logical_not()
            assert torch.equal(got[1][sel], want[1][sel])
            sc = torch.where(want[2] >= 0, torch.randint(0, 50, want[2].shape,
                                                         device=dev).float(), INF)
            for x, y in zip(bstep.merge(ids, d, want[2], sc, W),
                            _merge_beam(ids, d, want[2], sc, W)):
                assert torch.equal(x, y)


@pytest.mark.cuda
def test_plan_matches_the_kernel_library_on_card():
    """``select_plan`` and ``merge_plan`` count the bytes the library counts."""
    _card()
    lib = kernel_lib.load("beam_step")
    for W, H, K, E in ((128, 136, 384, 4), (800, 1728, 768, 8), (64, 80, 128, 4)):
        _, log_t, nbytes = bstep.select_plan(W, H, K, E)
        assert lib.beam_step_smem(W, K, E, log_t) == nbytes, W
        _, n_pad, nbytes = bstep.merge_plan(W, K)
        assert lib.beam_step_merge_smem(W, n_pad) == nbytes


@pytest.mark.cuda
def test_one_beam_step_runs_no_sort_on_card():
    """A profile of one iteration at the serving shape holds the two
    bookkeeping kernels and no device operation named for a sort."""
    dev = _card()
    st = _state(2, device=dev, **CARD_CASES["serving"])
    beam_step(st, 0)  # builds and warms
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        beam_step(st, 1)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    assert any("beam_select_kernel" in n for n in names), names
    assert any("beam_merge_kernel" in n for n in names), names
    assert not [n for n in names if "sort" in n.lower()], names


@pytest.fixture(scope="module")
def index_200k():
    dev = _card()
    from hnsw_tpu_torch import Hnsw
    rng = np.random.default_rng(0xB5)
    X = rng.standard_normal((200_000, 128)).astype(np.float32)
    Q = rng.standard_normal((2_000, 128)).astype(np.float32)

    def build(plain: bool):
        h = Hnsw(max_nb_connection=48, max_elements=len(X), ef_construction=200,
                 dist="L2", device=dev)
        with _plain_route() if plain else contextlib.nullcontext():
            h.parallel_insert(X, mode="device", batch_size=16_384)
        return h

    kernel_lib.reset_launch_counts()
    h = build(False)
    launches = dict(kernel_lib.LAUNCHES)
    return build, h, launches, X, Q


@pytest.mark.cuda
def test_build_through_the_kernels_equals_plain_on_card(index_200k):
    """``parallel_insert(mode="device")`` of 200,000 rows builds the same
    tables through the kernels as through the plain versions."""
    from hnsw_tpu_torch import to_arrays
    build, h, launches, _, _ = index_200k
    assert launches["beam_step.fused"] > 0 and launches["beam_step.merge"] > 0
    a, b = to_arrays(h), to_arrays(build(True))
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.cuda
@pytest.mark.parametrize("codec", [None, "i8"])
def test_search_program_through_the_kernels_equals_plain_on_card(index_200k, codec):
    """``search_program`` at the serving settings answers bit for bit alike
    through the kernels and through the plain versions, and the captured
    program (``device_search_batch``) answers as the eager one."""
    from hnsw_tpu_torch.ops.beam_search import (device_search_batch, search_program,
                                                serve_static)
    _, h, _, _, Q = index_200k
    h.set_traversal_codec(codec)
    try:
        g, cdc = h.device_graph(), h.device_codec()
        assert (cdc is None) == (codec is None)
        q = torch.as_tensor(Q, device=g.vectors.device)
        static = serve_static(cdc, ef=128, knbn=10)
        kernel_lib.reset_launch_counts()
        ids_k, d_k = search_program(g, q, None, codec=cdc, **static)
        torch.cuda.synchronize()
        assert kernel_lib.LAUNCHES["beam_step.merge"] > 0
        assert kernel_lib.LAUNCHES["beam_step.fused"] > 0
        with _plain_route():
            ids_p, d_p = search_program(g, q, None, codec=cdc, **static)
        assert torch.equal(ids_k, ids_p) and torch.equal(d_k, d_p)
        ids_r, d_r = device_search_batch(h, Q, 10, 128)
        ids_e = ids_k.cpu().numpy().astype(np.int64)
        d_e = d_k.cpu().numpy()
        ids_e[~np.isfinite(d_e)] = -1
        np.testing.assert_array_equal(ids_r, ids_e)
        np.testing.assert_array_equal(d_r, d_e)
    finally:
        h.set_traversal_codec(None)
