"""Kernels B1/B3 (codec gather + score), B4 (scores over gathered blocks), B2
(packed exact scan) and B5 (unpacked exact scan) of the PyTorch port against
the JAX package's Pallas kernels run in interpret mode.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
themselves are held against those plain versions in the ``cuda``-marked test
at the end (skipped without a card) and in ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax
import jax.lax as lax
import jax.numpy as jnp

from functools import partial

from jax.experimental import pallas as pl

from hnsw_tpu.ops.pallas_scores import (pallas_codec_scores,
                                        pallas_fused_codec_scores,
                                        pallas_fused_codec_scores_ids)
from hnsw_tpu.ops import pallas_topk as jtopk
from hnsw_tpu_torch.ops import codec_scores as cs
from hnsw_tpu_torch.ops import kernel_lib
from hnsw_tpu_torch.ops import scan_topk as st

# Scores: the two sides sum the same f32 products in different orders.
SC_RTOL, SC_ATOL = 1e-5, 1e-4


def _codec_case(rng, B=16, E=2, M0=8, d=128, N=64, r_id=None):
    blocks = rng.integers(-5, 6, (N, M0, d)).astype(np.int8)
    tbl = rng.integers(-1, N, (N, M0)).astype(np.int32)
    if r_id is None:  # id rows exactly as BeamCodec._build lays them out
        r_id = -(-(M0 + max(1, -(-(M0 * 4) // d))) // 8) * 8 - M0
    idp = np.full((N, r_id * d // 4), -1, np.int32)
    idp[:, :M0] = tbl
    blocks_ext = np.concatenate([blocks, idp.view(np.int8).reshape(N, r_id, d)], 1)
    q = rng.standard_normal((B, d)).astype(np.float32)
    src = rng.integers(0, N, (B, E)).astype(np.int32)
    return blocks, blocks_ext, tbl, q, src


def _qsn(q, form):
    qsq = (q * q).sum(-1, keepdims=True)
    return qsq if form == "l2" else np.sqrt(qsq)


@pytest.mark.parametrize("form", ["l2", "dot", "cosine"])
def test_b1_plain_matches_pallas_ids(rng, form):
    blocks, blocks_ext, tbl, q, src = _codec_case(rng)
    E, M0 = src.shape[1], blocks.shape[1]
    qsn = _qsn(q, form)
    sc_j, nbr_j = pallas_fused_codec_scores_ids(
        jnp.asarray(src), jnp.asarray(q), jnp.asarray(qsn), jnp.float32(0.1),
        jnp.asarray(blocks_ext), E, M0, form=form, qt=4, interpret=True)
    sc_t, nbr_t = cs.codec_scores(
        torch.from_numpy(src), torch.from_numpy(q), torch.from_numpy(qsn),
        torch.tensor(0.1, dtype=torch.float32), torch.from_numpy(blocks_ext), M0, form)
    np.testing.assert_allclose(sc_t.numpy(), np.array(sc_j), rtol=SC_RTOL, atol=SC_ATOL)
    np.testing.assert_array_equal(nbr_t.numpy(), np.array(nbr_j))
    np.testing.assert_array_equal(nbr_t.numpy(), tbl[src].reshape(len(q), E * M0))


@pytest.mark.parametrize("form", ["l2", "dot", "cosine"])
def test_b3_plain_matches_pallas(rng, form):
    blocks, _, _, q, src = _codec_case(rng)
    E, M0 = src.shape[1], blocks.shape[1]
    qsn = _qsn(q, form)
    ref = pallas_fused_codec_scores(
        jnp.asarray(src), jnp.asarray(q), jnp.asarray(qsn), jnp.float32(0.1),
        jnp.asarray(blocks), E, form=form, qt=4, interpret=True)
    sc_t, ids = cs.codec_scores(
        torch.from_numpy(src), torch.from_numpy(q), torch.from_numpy(qsn),
        torch.tensor(0.1, dtype=torch.float32), torch.from_numpy(blocks), M0, form)
    assert ids is None
    np.testing.assert_allclose(sc_t.numpy(), np.array(ref), rtol=SC_RTOL, atol=SC_ATOL)


@pytest.mark.parametrize("form", ["l2", "dot", "cosine"])
def test_b1_b3_plain_match_pallas_at_ragged_geometry(rng, form):
    """M0=12 with ONE id row at d=48 (the 48 id bytes fill it exactly; three
    16-byte words a row) and B=8, E=3, the table's last block among the nodes:
    the plain versions against the interpreted Pallas kernels, ids bit-equal."""
    blocks, blocks_ext, tbl, q, src = _codec_case(rng, B=8, E=3, M0=12, d=48, N=37, r_id=1)
    src[0, 0] = 36
    E, M0 = src.shape[1], blocks.shape[1]
    assert blocks_ext.shape == (37, 13, 48)
    qsn = _qsn(q, form)
    targs = (torch.from_numpy(src), torch.from_numpy(q), torch.from_numpy(qsn),
             torch.tensor(0.1, dtype=torch.float32))
    sc_j, nbr_j = pallas_fused_codec_scores_ids(
        jnp.asarray(src), jnp.asarray(q), jnp.asarray(qsn), jnp.float32(0.1),
        jnp.asarray(blocks_ext), E, M0, form=form, qt=4, interpret=True)
    sc_t, nbr_t = cs.codec_scores(*targs, torch.from_numpy(blocks_ext), M0, form)
    np.testing.assert_allclose(sc_t.numpy(), np.array(sc_j), rtol=SC_RTOL, atol=SC_ATOL)
    np.testing.assert_array_equal(nbr_t.numpy(), np.array(nbr_j))
    np.testing.assert_array_equal(nbr_t.numpy(), tbl[src].reshape(len(q), E * M0))
    ref = pallas_fused_codec_scores(
        jnp.asarray(src), jnp.asarray(q), jnp.asarray(qsn), jnp.float32(0.1),
        jnp.asarray(blocks), E, form=form, qt=4, interpret=True)
    sc_3, ids = cs.codec_scores(*targs, torch.from_numpy(blocks), M0, form)
    assert ids is None
    np.testing.assert_allclose(sc_3.numpy(), np.array(ref), rtol=SC_RTOL, atol=SC_ATOL)
    # both kernels recompute |c|^2 from the rows: B1 and B3 agree bit for bit
    np.testing.assert_array_equal(sc_3.numpy(), sc_t.numpy())


def _gathered_case(rng, B=16, K=24, d=32):
    """The inputs of the JAX package's own test of ``pallas_codec_scores``."""
    q = rng.standard_normal((B, d)).astype(np.float32)
    blk = rng.integers(-127, 128, (B, K * d)).astype(np.int8)
    bf = blk.reshape(B, K, d).astype(np.float32) * 0.017
    csq = (bf ** 2).sum(-1).astype(np.float32)
    return q, blk, bf, csq


@pytest.mark.parametrize("form", ["l2", "dot", "cosine"])
def test_b4_plain_matches_pallas(rng, form):
    q, blk, _, csq = _gathered_case(rng)
    csq = csq if form == "l2" else csq * 0
    qsn = _qsn(q, form)
    ref = pallas_codec_scores(jnp.asarray(q), jnp.asarray(blk), jnp.asarray(csq),
                              jnp.asarray(qsn), jnp.float32(0.017), form=form,
                              qt=8, interpret=True)
    out = cs.codec_scores_gathered(
        torch.from_numpy(q), torch.from_numpy(blk), torch.from_numpy(csq),
        torch.from_numpy(qsn), torch.tensor(0.017, dtype=torch.float32), form)
    np.testing.assert_allclose(out.numpy(), np.array(ref), rtol=SC_RTOL, atol=SC_ATOL)


@pytest.mark.parametrize("form", ["l2", "dot", "cosine"])
def test_b4_plain_matches_pallas_at_ragged_geometry(rng, form):
    """K=36 rows of d=48 (M0=12 x E=3) for B=8 queries against the interpreted
    Pallas kernel."""
    q, blk, _, csq = _gathered_case(rng, B=8, K=36, d=48)
    csq = csq if form == "l2" else csq * 0
    qsn = _qsn(q, form)
    ref = pallas_codec_scores(jnp.asarray(q), jnp.asarray(blk), jnp.asarray(csq),
                              jnp.asarray(qsn), jnp.float32(0.017), form=form,
                              qt=8, interpret=True)
    out = cs.codec_scores_gathered(
        torch.from_numpy(q), torch.from_numpy(blk), torch.from_numpy(csq),
        torch.from_numpy(qsn), torch.tensor(0.017, dtype=torch.float32), form)
    np.testing.assert_allclose(out.numpy(), np.array(ref), rtol=SC_RTOL, atol=SC_ATOL)


def test_b4_takes_any_shape(rng):
    """No ``B % qt`` and no ``d % 128`` / ``B % 8`` gate: B=5, K=7, d=40 against
    the f32 oracle (same summation-order tolerance)."""
    q, blk, bf, csq = _gathered_case(rng, B=5, K=7, d=40)
    qsq = (q * q).sum(-1, keepdims=True)
    out = cs.codec_scores_gathered(
        torch.from_numpy(q), torch.from_numpy(blk), torch.from_numpy(csq),
        torch.from_numpy(qsq), torch.tensor(0.017, dtype=torch.float32), "l2")
    ip = np.einsum("bd,bkd->bk", q, bf)
    np.testing.assert_allclose(out.numpy(), np.sqrt(np.maximum(qsq - 2 * ip + csq, 0)),
                               rtol=SC_RTOL, atol=SC_ATOL)
    with pytest.raises(ValueError, match="form"):
        cs.codec_scores_gathered(torch.from_numpy(q), torch.from_numpy(blk),
                                 torch.from_numpy(csq), torch.from_numpy(qsq),
                                 torch.tensor(0.017), "l1")


def test_cpu_wrappers_take_the_plain_version(rng):
    """A CPU tensor never reaches the kernel library (no nvcc here)."""
    kernel_lib.reset_launch_counts()
    blocks, blocks_ext, _, q, src = _codec_case(rng)
    cs.codec_scores(torch.from_numpy(src), torch.from_numpy(q),
                    torch.from_numpy(_qsn(q, "l2")), torch.tensor(0.1),
                    torch.from_numpy(blocks_ext), blocks.shape[1], "l2")
    X = rng.standard_normal((512, 16)).astype(np.float32)
    Xp, xsq, _ = st.pad_corpus(X, tn=256)
    st.scan_packed(torch.from_numpy(q[:, :16]), torch.from_numpy(Xp),
                   torch.from_numpy(xsq), 256, 8, 1)
    st.scan_unpacked(torch.from_numpy(q[:, :16]), torch.from_numpy(Xp),
                     torch.from_numpy(xsq), 256, 8, 1)
    gq, gblk, _, gcsq = _gathered_case(rng)
    cs.codec_scores_gathered(torch.from_numpy(gq), torch.from_numpy(gblk),
                             torch.from_numpy(gcsq), torch.from_numpy(_qsn(gq, "l2")),
                             torch.tensor(0.017), "l2")
    assert all(v == 0 for v in kernel_lib.LAUNCHES.values())
    # every wrapper has its own counter and one per kernel entry
    assert set(kernel_lib.LAUNCHES) == {
        "beam_step", "beam_step.fused", "beam_step.merge",
        "codec_scores_ids", "codec_scores_ids.bulk", "codec_scores_ids.rows",
        "codec_scores", "codec_scores.bulk", "codec_scores.rows",
        "codec_scores_gathered", "codec_scores_gathered.stream",
        "codec_scores_gathered.rows", "id_scores", "id_scores.f32", "id_scores.bf16",
        "scan_topk", "scan_topk.wgmma", "scan_topk.simt",
        "scan_topk.tf32x3", "scan_topk_unpacked", "scan_topk_unpacked.wgmma",
        "scan_topk_unpacked.simt", "scan_topk_unpacked.tf32x3"}


@pytest.mark.parametrize("d,M0,rid,entry", [
    (128, 56, 8, "bulk"), (128, 56, 0, "bulk"),   # the 200k index's codec; B3
    (48, 12, 1, "bulk"), (48, 10, 1, "bulk"),     # three words a row; 40 id bytes -> 48
    (16, 12, 3, "bulk"), (1024, 5, 1, "bulk"), (1024, 56, 8, "bulk"),
    (40, 12, 2, "rows"), (100, 8, 1, "rows"),     # d % 16
    (1040, 8, 1, "rows"), (2048, 8, 0, "rows"),   # more than two words per lane
    (1024, 120, 8, "rows"),                       # two stages do not fit
])
def test_codec_entry_is_chosen_by_shape(d, M0, rid, entry):
    """The fused wrapper picks its kernel entry from ``d``, ``M0`` and the id
    rows alone: whole 16-byte words up to ``BULK_MAX_D`` whose two-stage ring
    fits in shared memory take the bulk-copy ring, everything else the
    row-by-row kernel. Both names index the launch function's ``entry``
    argument and have a launch counter; B4 chooses by ``d``."""
    assert cs.codec_entry(d, M0, rid) == entry
    assert kernel_lib.CODEC_ENTRIES.index(entry) == (1 if entry == "bulk" else 0)
    name = "codec_scores_ids" if rid else "codec_scores"
    assert kernel_lib.LAUNCHES[f"{name}.{entry}"] == 0
    want = "stream" if d % 16 == 0 and d <= cs.BULK_MAX_D else "rows"
    assert cs.gathered_entry(d) == want
    assert kernel_lib.GATHERED_ENTRIES.index(want) == (1 if want == "stream" else 0)
    assert f"codec_scores_gathered.{want}" in kernel_lib.LAUNCHES


@pytest.mark.parametrize("d,M0,rid", [(128, 56, 8), (48, 12, 1), (48, 10, 1), (16, 12, 3),
                                      (1024, 5, 1), (128, 56, 0), (48, 12, 0)])
def test_codec_stage_bytes_rounds_ids_up_and_stays_in_the_block(d, M0, rid):
    """One bulk copy moves the vector rows and the id bytes behind them rounded
    up to 16: a multiple of 16 that holds every id and never leaves the node's
    block (so the table's last block is safe)."""
    stage = cs.codec_stage_bytes(d, M0, rid)
    assert stage % 16 == 0
    assert stage >= M0 * d + (4 * M0 if rid else 0)
    assert stage - (M0 * d + (4 * M0 if rid else 0)) < 16
    assert stage <= (M0 + rid) * d
    if rid == 0:
        assert stage == M0 * d


@pytest.mark.parametrize("name,entry", [
    ("codec_scores_ids", "bulk"), ("codec_scores", "rows"),
    ("codec_scores_gathered", "stream"), ("scan_topk", "wgmma"),
    ("scan_topk_unpacked", "simt")])
def test_failed_launch_raises_and_is_not_counted(monkeypatch, name, entry):
    """``kernel_lib.launch`` counts a launch only after the library's launch
    function returned 0: a refused launch raises and leaves the counts."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "no card")
    kernel_lib.reset_launch_counts()
    seen = []
    with pytest.raises(RuntimeError, match=f"{name}.{entry}: CUDA launch failed with error 1"):
        kernel_lib.launch(name, entry, lambda *a: seen.append(a) or 1, 7, 8)
    assert seen == [(7, 8)]
    assert all(v == 0 for v in kernel_lib.LAUNCHES.values())
    kernel_lib.launch(name, entry, lambda *a: 0, 7, 8)
    assert kernel_lib.LAUNCHES[name] == 1 and kernel_lib.LAUNCHES[f"{name}.{entry}"] == 1
    assert sum(kernel_lib.LAUNCHES.values()) == 2
    kernel_lib.reset_launch_counts()


def test_codec_wrappers_launch_through_the_counted_helper():
    """The four wrappers hand their library call to ``kernel_lib.launch`` and
    count nowhere else."""
    import inspect
    for mod in (cs, st):
        src = inspect.getsource(mod)
        assert "LAUNCHES[" not in src.split('"""', 2)[2]
        assert src.count("kernel_lib.launch(") == 2


@pytest.mark.parametrize("acc", [1, 3])
def test_b2_plain_matches_pallas(rng, acc):
    """Packed scan + decode + refine against ``pallas_l2_topk`` (interpret,
    packed) at tn=256, group=8 on an uneven tail (7 tiles; acc=3 -> 3+3+1)."""
    n, d, B, k = 1700, 32, 8, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((B, d)).astype(np.float32)
    Xp, xsq, perm = jtopk.pad_corpus(X, tn=256)
    dj, ij = jtopk.pallas_l2_topk(jnp.asarray(Q), jnp.asarray(Xp), jnp.asarray(xsq),
                                  k, tn=256, group=8, interpret=True, acc=acc,
                                  packed=True)
    dt, it = st.l2_topk(torch.from_numpy(Q), torch.from_numpy(Xp),
                        torch.from_numpy(xsq), k, tn=256, group=8, acc=acc)
    ij, it = np.array(ij), it.numpy()
    for b in range(B):
        assert set(ij[b].tolist()) == set(it[b].tolist())
    # the refine re-scores both sides' finalists with the same direct f32 form
    np.testing.assert_allclose(dt.numpy(), np.array(dj), rtol=1e-5)
    truth = ((Q[:, None, :].astype(np.float64) - X[None]) ** 2).sum(-1)
    for b in range(B):
        assert set(perm[it[b]].tolist()) == set(np.argsort(truth[b])[:k].tolist())


def _pallas_unpacked_outputs(Q, Xp, xsq, tn, group, acc):
    """The raw (outd, outi) of the JAX package's unpacked tile kernel: its
    ``pallas_call`` as ``pallas_l2_topk(packed=False)`` issues it, interpreted."""
    B, d = Q.shape
    N = Xp.shape[0]
    G, n_tiles = tn // group, N // tn
    acc = max(1, min(acc, n_tiles))
    n_blocks = -(-n_tiles // acc)
    out_spec = pl.BlockSpec((1, B, 2 * G), lambda i: (i // acc, 0, 0))
    outd, outi = pl.pallas_call(
        partial(jtopk._tile_kernel, G=G, TN=tn, A=acc),
        grid=(n_tiles,),
        in_specs=[pl.BlockSpec((B, d), lambda i: (0, 0)),
                  pl.BlockSpec((1, 1, tn), lambda i: (i, 0, 0)),
                  pl.BlockSpec((tn, d), lambda i: (i, 0))],
        out_specs=[out_spec, out_spec],
        out_shape=[jax.ShapeDtypeStruct((n_blocks, B, 2 * G), jnp.float32),
                   jax.ShapeDtypeStruct((n_blocks, B, 2 * G), jnp.int32)],
        interpret=True,
    )(jnp.asarray(Q), jnp.asarray(xsq).reshape(n_tiles, 1, tn), jnp.asarray(Xp))
    return np.array(outd), np.array(outi)


@pytest.mark.parametrize("acc", [1, 3])
@pytest.mark.parametrize("ties", [False, True], ids=["gauss", "ties"])
def test_b5_plain_matches_pallas_kernel_outputs(rng, acc, ties):
    """``scan_unpacked_plain`` against the unpacked Pallas tile kernel's own
    outputs, cell for cell: ids equal, values to f32 summation order. The
    "ties" corpus holds small integers, so the inner products are exact in
    f32, many candidates of a cell tie exactly, and every tie rule is
    exercised (lowest position in a tile, earlier tile for first place, the
    first round's loser for second place): values and ids are then equal bit
    for bit."""
    n, d, B = 1700, 32, 8
    if ties:
        X = rng.integers(-2, 3, (n, d)).astype(np.float32)
        Q = rng.integers(-2, 3, (B, d)).astype(np.float32)
    else:
        X = rng.standard_normal((n, d)).astype(np.float32)
        Q = rng.standard_normal((B, d)).astype(np.float32)
    Xp, xsq, _ = jtopk.pad_corpus(X, tn=256)
    dj, ij = _pallas_unpacked_outputs(Q, Xp, xsq, 256, 8, acc)
    dt, it = st.scan_unpacked(torch.from_numpy(Q), torch.from_numpy(Xp),
                              torch.from_numpy(xsq), 256, 8, acc)
    assert dt.dtype == torch.float32 and it.dtype == torch.int32
    if ties:
        np.testing.assert_array_equal(dt.numpy(), dj)
        np.testing.assert_array_equal(it.numpy(), ij)
    else:
        np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5, atol=1e-4)
        assert (it.numpy() == ij).mean() >= 0.999  # a near-tie may swap a pick


@pytest.mark.parametrize("acc", [1, 3])
def test_b5_l2_topk_matches_pallas(rng, acc):
    """``l2_topk(packed=False)`` (scan, top-k, + |q|^2, refine) against
    ``pallas_l2_topk(packed=False)`` on an uneven tail: ids equal, distances
    rtol 1e-5 (the same direct f32 form over the same finalists); and the
    port's unpacked ids equal its packed ids."""
    n, d, B, k = 1700, 32, 8, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((B, d)).astype(np.float32)
    Xp, xsq, perm = jtopk.pad_corpus(X, tn=256)
    dj, ij = jtopk.pallas_l2_topk(jnp.asarray(Q), jnp.asarray(Xp), jnp.asarray(xsq),
                                  k, tn=256, group=8, interpret=True, acc=acc,
                                  packed=False)
    targs = (torch.from_numpy(Q), torch.from_numpy(Xp), torch.from_numpy(xsq), k)
    du, iu = st.l2_topk(*targs, tn=256, group=8, acc=acc, packed=False)
    dp, ip_ = st.l2_topk(*targs, tn=256, group=8, acc=acc, packed=True)
    np.testing.assert_array_equal(iu.numpy(), np.array(ij))
    np.testing.assert_allclose(du.numpy(), np.array(dj), rtol=1e-5)
    np.testing.assert_array_equal(iu.numpy(), ip_.numpy())
    np.testing.assert_allclose(du.numpy(), dp.numpy(), rtol=1e-5)
    # unrefined: |q|^2 joins after the top-k; no mantissa bit is cleared
    dn, i_n = st.l2_topk(*targs, tn=256, group=8, acc=acc, packed=False, refine=False)
    djn, ijn = jtopk.pallas_l2_topk(jnp.asarray(Q), jnp.asarray(Xp), jnp.asarray(xsq),
                                    k, tn=256, group=8, interpret=True, acc=acc,
                                    packed=False, refine=False)
    np.testing.assert_array_equal(i_n.numpy(), np.array(ijn))
    np.testing.assert_allclose(dn.numpy(), np.array(djn), rtol=1e-4, atol=1e-4)


def test_b5_stream_unpacked(rng):
    """``l2_topk_stream(packed=False)``: several batches with an odd tail
    return what ``packed=True`` returns and the brute-force neighbours."""
    n, d, k = 1200, 32, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((50, d)).astype(np.float32)
    Xp, xsq, perm = st.pad_corpus(X, tn=256)
    args = (Q, torch.from_numpy(Xp), torch.from_numpy(xsq), k)
    kw = dict(tn=256, group=8, acc=2, batch=16)
    du, iu = st.l2_topk_stream(*args, packed=False, **kw)
    dp, ip_ = st.l2_topk_stream(*args, packed=True, **kw)
    np.testing.assert_array_equal(iu, ip_)
    np.testing.assert_allclose(du, dp, rtol=1e-5)
    truth = ((Q[:, None, :].astype(np.float64) - X[None]) ** 2).sum(-1)
    for b in range(len(Q)):
        assert set(perm[iu[b]].tolist()) == set(np.argsort(truth[b])[:k].tolist())


def test_b2_bf16_scan_refine(rng):
    """bf16 scan copy + f32 refine: no true neighbour is missed and the
    distances are the exact f32 ones (the BruteForceIndex configuration)."""
    n, d, B, k = 2000, 64, 8, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((B, d)).astype(np.float32)
    Xp, xsq, perm = st.pad_corpus(X, tn=256)
    Xt = torch.from_numpy(Xp)
    dd, ids = st.l2_topk(torch.from_numpy(Q), Xt, torch.from_numpy(xsq), k, tn=256,
                         group=8, Xscan=Xt.to(torch.bfloat16), overfetch=24, acc=1)
    d2 = ((Q[:, None, :].astype(np.float64) - X[None]) ** 2).sum(-1)
    for b in range(B):
        assert set(perm[ids[b].numpy()].tolist()) == set(np.argsort(d2[b])[:k].tolist())
        np.testing.assert_allclose(dd[b].numpy(), np.sqrt(np.sort(d2[b])[:k]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,tn", [(300, 256), (5000, 2048)])
def test_pad_corpus_byte_equal(rng, n, tn):
    X = rng.standard_normal((n, 24)).astype(np.float32)
    a = jtopk.pad_corpus(X, tn=tn)
    b = st.pad_corpus(X, tn=tn)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    """``kernel_lib.ptxas_report`` reads each entry's registers and spilled
    bytes from the report nvcc leaves beside a library; a source that was
    never built here reports no entry."""
    monkeypatch.setattr(kernel_lib, "BUILD_DIR", tmp_path)
    kernel_lib._lib_path("scan_topk").with_suffix(".ptxas.txt").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z4scanIfEvPKv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z4scanIfEvPKv\n"
        "    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 128 registers, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z4scanIbEvPKv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z4scanIbEvPKv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 96 registers, 400 bytes cmem[0]\n")
    rep = kernel_lib.ptxas_report()
    assert set(rep) == set(kernel_lib.SOURCES)
    assert rep["scan_topk"] == [
        {"entry": "_Z4scanIfEvPKv", "registers": 128, "spill_stores": 12, "spill_loads": 8},
        {"entry": "_Z4scanIbEvPKv", "registers": 96, "spill_stores": 0, "spill_loads": 0}]
    assert rep["scan_topk_unpacked"] == []


@pytest.mark.parametrize("dtype,d,packed,entry", [
    (torch.bfloat16, 128, True, "wgmma"), (torch.bfloat16, 128, False, "wgmma"),
    (torch.bfloat16, 16, True, "wgmma"), (torch.bfloat16, 48, False, "wgmma"),
    (torch.bfloat16, 256, True, "wgmma"), (torch.bfloat16, 192, False, "wgmma"),
    (torch.bfloat16, 256, False, "wgmma"),  # past the resident ring: the K-looped layout
    (torch.bfloat16, 272, True, "wgmma"),
    (torch.bfloat16, 40, True, "wgmma"), (torch.bfloat16, 100, False, "wgmma"),  # padded
    # full f32: three tf32 products a box on the tensor cores, at every depth
    (torch.float32, 128, True, "tf32x3"), (torch.float32, 128, False, "tf32x3"),
    (torch.float32, 40, True, "tf32x3"),
    (torch.bfloat16, 784, True, "wgmma"), (torch.bfloat16, 784, False, "wgmma"),
    (torch.bfloat16, 960, True, "wgmma"), (torch.bfloat16, 1536, False, "wgmma"),
    (torch.bfloat16, st.WGMMA_MAX_D, True, "wgmma"), (torch.float32, 784, True, "tf32x3"),
    (torch.float32, 784, False, "tf32x3"), (torch.float32, 960, True, "tf32x3"),
    (torch.float32, 960, False, "tf32x3"), (torch.float32, 1536, True, "tf32x3"),
    (torch.float32, st.WGMMA_MAX_D, False, "tf32x3"), (torch.float32, 100, True, "tf32x3"),
])
def test_scan_entry_is_chosen_by_dtype_and_depth(dtype, d, packed, entry):
    """The wrapper picks the kernel entry from dtype and ``d`` alone: bf16
    takes the tensor-core entry ``wgmma`` at every depth up to
    ``WGMMA_MAX_D`` (its copies padded with zero columns to
    ``scan_depth(d)``), f32 (whose contract is full f32) the tensor-core
    entry ``tf32x3`` at the same depths, in the K-looped layout. Every name
    indexes the launch functions' ``entry`` argument and has a launch
    counter."""
    assert st.scan_entry(dtype, d, packed) == entry
    w = st.scan_depth(d, dtype)
    assert w == d or dtype == torch.bfloat16
    q = torch.zeros((4, w), dtype=dtype)
    X = torch.zeros((256, w), dtype=dtype)
    got, layout = st._check_card_geometry(128, 256, 2, q, X, packed)
    assert got == entry
    assert st.SCAN_LAYOUTS[layout] == st.scan_layout(d, packed, dtype)
    assert kernel_lib.SCAN_ENTRIES.index(entry) == {"simt": 0, "wgmma": 1, "tf32x3": 2}[entry]
    name = "scan_topk" if packed else "scan_topk_unpacked"
    assert f"{name}.{entry}" in kernel_lib.LAUNCHES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_every_scan_depth_fits_the_block(dtype, packed):
    """Every depth the wrapper takes, ``0 < d <= WGMMA_MAX_D`` in either
    dtype, names an entry whose launch asks for at most ``SMEM_LIMIT`` bytes
    of shared memory with at least two ring stages (``scan_smem`` mirrors the
    launch functions). The f32-FMA entry ("simt"), which f32 scans took
    before, keeps its queries [d][64] in shared memory and asks for more past
    d = 842 packed and 715 unpacked: there an f32 scan could not launch."""
    for d in range(1, st.WGMMA_MAX_D + 1):
        w = st.scan_depth(d, dtype)
        entry = st.scan_entry(dtype, w, packed)
        nbytes, stages = st.scan_smem(entry, w, packed)
        assert nbytes <= st.SMEM_LIMIT and stages >= 2, (d, entry, nbytes, stages)
    last = 842 if packed else 715
    assert st.scan_smem("simt", last, packed)[0] <= st.SMEM_LIMIT
    assert st.scan_smem("simt", last + 1, packed)[0] > st.SMEM_LIMIT
    # the ring stages the launch functions pick (the K-looped bf16 ring: 5 and 3;
    # f32 beside the split's 32 KB lo area: 4 and 2)
    assert st.scan_smem("tf32x3", 960, packed)[1] == (4 if packed else 2)
    assert st.scan_smem("wgmma", 960, packed)[1] == (5 if packed else 3)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_scan_past_its_depth_raises_for_both_dtypes(packed):
    """Past ``WGMMA_MAX_D`` no entry launches, in bf16 or f32: the choice
    raises before any launch, with a message that names the limit and no
    other dtype to turn to. An f32 copy off the 4-column step raises too."""
    d = st.WGMMA_MAX_D + 1
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="WGMMA_MAX_D") as err:
            st.scan_entry(dtype, d, packed)
        assert "bf16 and in f32" in str(err.value)
        q = torch.zeros((4, st.scan_depth(d, dtype)), dtype=dtype)
        with pytest.raises(ValueError, match="WGMMA_MAX_D"):
            st._check_card_geometry(128, 256, 2, q, q, packed)
    q = torch.zeros((4, 102), dtype=torch.float32)
    with pytest.raises(ValueError, match="steps 4 columns"):
        st._check_card_geometry(128, 256, 2, q, q, packed)


@pytest.mark.parametrize("d,packed,layout", [
    (128, True, "resident"), (128, False, "resident"), (40, True, "resident"),
    (256, True, "resident"), (192, False, "resident"), (184, False, "resident"),
    (250, True, "resident"), (256, False, "kloop"), (260, True, "kloop"),
    (784, True, "kloop"), (784, False, "kloop"), (960, True, "kloop"),
])
def test_scan_layout_is_chosen_by_depth(d, packed, layout):
    """The tensor-core entry keeps the query tile resident while two ring
    stages fit beside it (``RESIDENT_MAX_D``, of the padded depth) and walks
    the depth in 64-column boxes above; f32 is K-looped at every depth."""
    assert st.scan_layout(d, packed) == layout
    assert st.SCAN_LAYOUTS.index(layout) == (0 if layout == "resident" else 1)
    assert st.scan_layout(d, packed, torch.float32) == "kloop"


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_bf16_scan_past_its_depth_or_unpadded_raises(packed):
    """A bf16 scan the tensor-core entry cannot launch raises before any
    launch (nothing falls back to the f32-FMA entry): past ``WGMMA_MAX_D``,
    and a copy that is not padded to the 16-column step."""
    d = st.WGMMA_MAX_D + 1
    with pytest.raises(ValueError, match="WGMMA_MAX_D"):
        st.scan_entry(torch.bfloat16, d, packed)
    q = torch.zeros((4, st.scan_depth(d)), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="WGMMA_MAX_D"):
        st._check_card_geometry(128, 256, 2, q, q, packed)
    q = torch.zeros((4, 100), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="scan_copy"):
        st._check_card_geometry(128, 256, 2, q, q, packed)
    with pytest.raises(ValueError, match="columns"):
        st._check_card_geometry(128, 256, 2, q, torch.zeros((256, 112), dtype=torch.bfloat16),
                                packed)


@pytest.mark.parametrize("d", [100, 40])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_scan_copy_pads_zero_columns_and_keeps_the_answer(rng, d, packed):
    """The bf16 scan copy carries zero columns up to ``scan_depth(d)``; the
    plain scan through ``l2_topk`` (which pads the queries to the copy's
    width) gives the unpadded copy's answer, ids equal and distances the
    same f32 refine."""
    n, B, k = 3000, 8, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32))
    Xp, xsq, _ = st.pad_corpus(X)
    Xt = torch.from_numpy(Xp)
    pad = st.scan_copy(Xt)
    assert pad.dtype == torch.bfloat16 and pad.shape == (Xp.shape[0], st.scan_depth(d))
    assert st.scan_depth(d) % 16 == 0 and st.scan_depth(d) - d < 16
    assert bool((pad[:, d:] == 0).all()) and torch.equal(pad[:, :d], Xt.to(torch.bfloat16))
    assert torch.equal(st.scan_copy(Xt, torch.float32), Xt)
    args = (Q, Xt, torch.from_numpy(xsq), k)
    dp, ip_ = st.l2_topk(*args, Xscan=pad, acc=1, packed=packed)
    du, iu = st.l2_topk(*args, Xscan=Xt.to(torch.bfloat16), acc=1, packed=packed)
    np.testing.assert_array_equal(np.sort(ip_.numpy(), 1), np.sort(iu.numpy(), 1))
    np.testing.assert_allclose(dp.numpy(), du.numpy(), rtol=1e-6)


@pytest.mark.parametrize("d,acc", [(784, 3), (100, 1)])
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_plain_scans_match_pallas_at_high_d(rng, d, acc, k, packed):
    """The port's plain scans through ``l2_topk`` against ``pallas_l2_topk``
    (interpreted) at the JAX package's high-d geometry (``tn = pick_tn(d)``,
    512 at d = 784, and ``group = tn // 128``) on a ragged tail (d = 784: 4
    tiles in spans of 3 + 1), at k = 10 and k = 100: ids equal as sets,
    distances within the d = 128 cases' rtol (the same direct f32 refine over
    the same finalists); at k = 10 the ids are the true neighbours."""
    n, B = (2000, 8) if d == 784 else (3000, 16)
    tn = jtopk.pick_tn(d)
    group = tn // 128
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((B, d)).astype(np.float32)
    Xp, xsq, perm = jtopk.pad_corpus(X, tn=tn)
    dj, ij = jtopk.pallas_l2_topk(jnp.asarray(Q), jnp.asarray(Xp), jnp.asarray(xsq),
                                  k, tn=tn, group=group, interpret=True, acc=acc,
                                  packed=packed)
    dt, it = st.l2_topk(torch.from_numpy(Q), torch.from_numpy(Xp), torch.from_numpy(xsq),
                        k, tn=tn, group=group, acc=acc, packed=packed)
    np.testing.assert_array_equal(np.sort(it.numpy(), 1), np.sort(np.array(ij), 1))
    np.testing.assert_allclose(dt.numpy(), np.array(dj), rtol=1e-5)
    if k == 10:  # at k = 100 a keep-2 cell of 12 rows drops true neighbours on both sides
        truth = ((Q[:, None, :].astype(np.float64) - X[None]) ** 2).sum(-1)
        for b in range(B):
            assert set(perm[it[b]].tolist()) == set(np.argsort(truth[b])[:k].tolist())


@pytest.mark.parametrize("d,packed", [(960, True), (784, False), (962, True)])
@pytest.mark.parametrize("k", [10, 100])
def test_plain_f32_scans_match_pallas_at_high_d(rng, d, packed, k):
    """The full-precision scan (``Xscan=None`` on both sides: the f32 corpus
    itself) through ``l2_topk`` against ``pallas_l2_topk`` (interpreted) at
    the JAX package's geometry for the depth (``tn = pick_tn(d)``, 512 here,
    ``group = tn // 128``), at k = 10 and 100: ids equal as sets, distances
    the same direct f32 refine. At d = 962, off the f32 scan's 4-column step,
    the port scans a zero-padded f32 copy (``scan_copy``, 964 columns), as
    ``BruteForceIndex`` makes it: the answer is the reference's."""
    n, B = 1500, 8
    tn = jtopk.pick_tn(d)
    group = tn // 128
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((B, d)).astype(np.float32)
    Xp, xsq, perm = jtopk.pad_corpus(X, tn=tn)
    dj, ij = jtopk.pallas_l2_topk(jnp.asarray(Q), jnp.asarray(Xp), jnp.asarray(xsq),
                                  k, tn=tn, group=group, interpret=True, acc=2,
                                  packed=packed, Xscan=None)
    Xt = torch.from_numpy(Xp)
    Xscan = st.scan_copy(Xt, torch.float32)
    assert (Xscan is Xt) == (d % 4 == 0)
    assert Xscan.shape[1] == st.scan_depth(d, torch.float32)
    dt, it = st.l2_topk(torch.from_numpy(Q), Xt, torch.from_numpy(xsq), k, tn=tn,
                        group=group, acc=2, packed=packed,
                        Xscan=None if Xscan is Xt else Xscan)
    np.testing.assert_array_equal(np.sort(it.numpy(), 1), np.sort(np.array(ij), 1))
    np.testing.assert_allclose(dt.numpy(), np.array(dj), rtol=1e-5)


def test_tf32_split_is_exact_and_rounds_to_nearest(rng):
    """``tf32_split``, the split the ``tf32x3`` entry makes of every box in
    shared memory: ``hi`` is ``x`` with its low 13 bits cleared (what the
    tensor cores read of the loaded f32 word), so the rest ``x - hi`` is
    exact (``hi + (x - hi) == x`` bit for bit); ``lo`` holds tf32's bits too,
    the rest rounded to the nearest tf32 (ties away from zero, as
    ``cvt.rna.tf32.f32``): ``hi + lo`` lies within half a tf32 ulp of the
    rest from ``x``, 2^-22 of it."""
    x = np.concatenate([
        rng.standard_normal(20000) * np.exp2(rng.integers(-30, 30, 20000)),
        [0.0, -0.0, 1.0, -1.0, 3.0e38, -3.0e38, 1e-40],
        # rests that tie between two tf32 values, 2^-11 (1 + 2^-11), either
        # sign (ties round away from zero, to 2^-11 (1 + 2^-10))
        [1.0 + 2.0 ** -11 + 2.0 ** -22, -(1.0 + 2.0 ** -11 + 2.0 ** -22)],
    ]).astype(np.float32)
    xt = torch.from_numpy(x)
    hi, lo = st.tf32_split(xt)
    assert hi.dtype == lo.dtype == torch.float32
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rest = xt - hi
    assert torch.equal(hi + rest, xt)
    assert bool((hi.abs() <= xt.abs()).all())  # truncated toward zero
    tie = 2.0 ** -11 + 2.0 ** -21
    assert hi[-2].item() == 1.0 and lo[-2].item() == tie and lo[-1].item() == -tie
    x64 = x.astype(np.float64)
    err = np.abs(hi.numpy().astype(np.float64) + lo.numpy() - x64)
    normal = np.abs(x64) >= 2.0 ** -100  # the rest a normal f32 too
    assert np.all(err[normal] <= 2.0 ** -22 * np.abs(x64[normal]))


@pytest.mark.parametrize("d", [784, 960])
def test_tf32x3_product_holds_fp64_within_the_terms(rng, d):
    """The ``tf32x3`` entry's arithmetic, modelled on the CPU
    (``tf32x3_dots``: per 32-column box ``ql xh + qh xl + qh xh`` of the tf32
    parts, ``ql xl`` left out): ``v = |x|^2 - 2 q.x`` within
    ``B2_TERM_RTOL`` (1e-6) of its terms ``|x|^2 + 2 |q.x|`` from an fp64
    evaluation of the same f32 inputs, at the high-d shapes the card runs
    (bench.py's gauss rows). One tf32 product alone misses that bound."""
    from hnsw_tpu_torch.bench import f32_dataset

    X, Q = f32_dataset("gauss", rng, 2000, 32, d, 16)
    Xt, Qt = torch.from_numpy(X), torch.from_numpy(Q)
    g64 = Qt.double() @ Xt.double().T
    xsq = (Xt.double() ** 2).sum(1)[None, :]
    terms = xsq + 2.0 * g64.abs()
    rtol = _chip_smoke().B2_TERM_RTOL
    v3 = xsq.float() - 2.0 * st.tf32x3_dots(Qt, Xt)
    err3 = float(((v3.double() - (xsq - 2.0 * g64)).abs() / terms).max())
    assert err3 <= rtol, err3
    qh, xh = st.tf32_split(Qt)[0], st.tf32_split(Xt)[0]
    v1 = xsq.float() - 2.0 * (qh @ xh.T)
    err1 = float(((v1.double() - (xsq - 2.0 * g64)).abs() / terms).max())
    assert err1 > 10 * rtol, err1


def _chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def test_card_geometry_raises_on_what_the_kernels_do_not_take():
    q = torch.zeros((4, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="128 lane groups"):
        st._check_card_geometry(32, 256, 8, q, q, True)
    with pytest.raises(ValueError, match="one type"):
        st._check_card_geometry(128, 256, 2, q, q.to(torch.float32), True)
    with pytest.raises(ValueError, match="bf16 or f32"):
        st._check_card_geometry(128, 256, 2, q.to(torch.float16), q.to(torch.float16), False)


def test_scan_launch_counters_per_entry():
    """Each scan launch counts once for its wrapper and once for the entry it
    took; ``reset_launch_counts`` zeroes both."""
    kernel_lib.reset_launch_counts()
    ok = lambda *a: 0
    kernel_lib.launch("scan_topk", "wgmma", ok)
    kernel_lib.launch("scan_topk", "wgmma", ok)
    kernel_lib.launch("scan_topk", "simt", ok)
    kernel_lib.launch("scan_topk_unpacked", "simt", ok)
    L = kernel_lib.LAUNCHES
    assert (L["scan_topk"], L["scan_topk.wgmma"], L["scan_topk.simt"]) == (3, 2, 1)
    assert (L["scan_topk_unpacked"], L["scan_topk_unpacked.wgmma"],
            L["scan_topk_unpacked.simt"]) == (1, 0, 1)
    kernel_lib.reset_launch_counts()
    assert all(v == 0 for v in L.values())


def test_lib_name_hashes_the_headers_a_source_includes(tmp_path, monkeypatch):
    """A library is named by a hash of its ``.cu`` and of every ``csrc``
    header it includes, directly or through another header: editing one
    renames (rebuilds) it, editing a header it does not include does not."""
    monkeypatch.setattr(kernel_lib, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include <cuda.h>\n#include "tile.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "tile.cuh").write_text('#pragma once\n  #  include "ptx.cuh"\n')
    (tmp_path / "ptx.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    a0, b0 = kernel_lib._lib_path("a"), kernel_lib._lib_path("b")
    (tmp_path / "other.cuh").write_text("// v2\n")
    assert (kernel_lib._lib_path("a"), kernel_lib._lib_path("b")) == (a0, b0)
    (tmp_path / "ptx.cuh").write_text("// v2\n")       # a header of a header
    a1 = kernel_lib._lib_path("a")
    assert a1 != a0 and kernel_lib._lib_path("b") == b0
    (tmp_path / "tile.cuh").write_text('#pragma once\n#include "ptx.cuh"\n// edited\n')
    assert kernel_lib._lib_path("a") not in (a0, a1)
    # the package's own scans include the shared tile header
    monkeypatch.undo()
    for name in ("scan_topk", "scan_topk_unpacked"):
        assert b"scan_tile.cuh" in kernel_lib._source_bytes(kernel_lib.CSRC / f"{name}.cu")
        assert (kernel_lib.CSRC / "scan_tile.cuh").read_bytes() in \
            kernel_lib._source_bytes(kernel_lib.CSRC / f"{name}.cu")


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_plain_scans_match_pallas_at_ragged_card_geometry(rng, packed):
    """The card's geometry (G = 128 lane groups: tn=256, group=2) at its
    ragged edges: B = 136 is not a multiple of the kernels' 128-query tile,
    the 7 tiles split into spans of 3 + 3 + 1, and the last tile is mostly
    padding rows. The plain versions against the interpreted Pallas kernels:
    the packed scan through decode and refine, the unpacked scan's raw
    outputs cell for cell."""
    n, d, B, k, tn, group, acc = 1700, 32, 136, 10, 256, 2, 3
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((B, d)).astype(np.float32)
    Xp, xsq, perm = jtopk.pad_corpus(X, tn=tn)
    targs = (torch.from_numpy(Q), torch.from_numpy(Xp), torch.from_numpy(xsq))
    assert st._geometry(Xp.shape[0], tn, group, acc)[:4] == (128, 7, 3, 3)
    if packed:
        dj, ij = jtopk.pallas_l2_topk(jnp.asarray(Q), jnp.asarray(Xp), jnp.asarray(xsq),
                                      k, tn=tn, group=group, interpret=True, acc=acc,
                                      packed=True)
        dt, it = st.l2_topk(*targs, k, tn=tn, group=group, acc=acc)
        np.testing.assert_array_equal(np.sort(it.numpy(), 1), np.sort(np.array(ij), 1))
        np.testing.assert_allclose(dt.numpy(), np.array(dj), rtol=1e-5)
        out = st.scan_packed(*targs, tn, group, acc)
        assert out.shape == (3, B, 256) and out.dtype == torch.int32
        # padding rows stay finite (3e38 packs below INT_MAX) and sort last
        LB = st._geometry(Xp.shape[0], tn, group, acc)[4]
        vals = (out & ~((1 << LB) - 1)).view(torch.float32)
        assert bool(torch.isfinite(vals).all()) and int(out.max()) < st._INT_MAX
    else:
        dj, ij = _pallas_unpacked_outputs(Q, Xp, xsq, tn, group, acc)
        dt, it = st.scan_unpacked(*targs, tn, group, acc)
        assert dt.shape == (3, B, 256)
        np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5, atol=1e-4)
        assert (it.numpy() == ij).mean() >= 0.999  # a near-tie may swap a pick


@pytest.mark.cuda
def test_kernels_match_plain_on_card(rng):
    """The CUDA kernels against their plain versions (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile with nvcc for sm_90a")
    dev = torch.device("cuda")
    # d=128 takes the kernel's 16-byte loads, d=40 its scalar rows
    for d in (128, 40):
        blocks, blocks_ext, _, q, src = _codec_case(rng, B=64, E=4, M0=16, d=d, N=256)
        for blk in (blocks_ext, blocks):
            for form in ("l2", "dot", "cosine"):
                args = (torch.from_numpy(src).to(dev), torch.from_numpy(q).to(dev),
                        torch.from_numpy(_qsn(q, form)).to(dev),
                        torch.tensor(0.1, device=dev), torch.from_numpy(blk).to(dev),
                        16, form)
                sk, ik = cs.codec_scores(*args)
                sp, ip_ = cs.codec_scores_plain(*args)
                torch.testing.assert_close(sk, sp, rtol=SC_RTOL, atol=SC_ATOL)
                assert (ik is None and ip_ is None) or torch.equal(ik, ip_)
    # B4: d=128 takes 16-byte loads, d=40 scalar rows; any B and K
    for B, K, d in ((64, 224, 128), (5, 7, 40)):
        q, blk, _, csq = _gathered_case(rng, B=B, K=K, d=d)
        for form in ("l2", "dot", "cosine"):
            args = (torch.from_numpy(q).to(dev), torch.from_numpy(blk).to(dev),
                    torch.from_numpy(csq).to(dev),
                    torch.from_numpy(_qsn(q, form)).to(dev),
                    torch.tensor(0.017, device=dev), form)
            torch.testing.assert_close(cs.codec_scores_gathered(*args),
                                       cs.codec_scores_gathered_plain(*args),
                                       rtol=SC_RTOL, atol=SC_ATOL)
    # the ragged group, through every entry that takes the shape: three words a
    # row (d=48), one lane a row (d=16), two words in each of 32 lanes
    # (d=1024), no whole word (d=40), two passes of the warps over M0=100 rows;
    # 48, 40 and 20 id bytes; E=1 to 3; B=5; the table's last block among the
    # nodes
    for d, M0, rid, E in ((48, 12, 1, 1), (48, 10, 1, 3), (48, 12, 0, 3), (40, 12, 2, 1),
                          (16, 12, 3, 3), (1024, 5, 1, 1), (1024, 5, 0, 3),
                          (128, 100, 4, 2), (256, 20, 1, 2)):
        blocks, blocks_ext, _, q, src = _codec_case(rng, B=5, E=E, M0=M0, d=d, N=37,
                                                    r_id=max(rid, 1))
        src[0, 0] = 36
        blk = torch.from_numpy(blocks_ext if rid else blocks).to(dev)
        entries = dict.fromkeys((cs.codec_entry(d, M0, rid), "rows"))
        name = "codec_scores_ids" if rid else "codec_scores"
        for form in ("l2", "dot", "cosine"):
            args = (torch.from_numpy(src).to(dev), torch.from_numpy(q).to(dev),
                    torch.from_numpy(_qsn(q, form)).to(dev),
                    torch.tensor(0.1, device=dev), blk, M0, form)
            sp, ip_ = cs.codec_scores_plain(*args)
            for ent in entries:
                kernel_lib.reset_launch_counts()
                sk, ik = cs.codec_scores(*args, entry=ent)
                torch.testing.assert_close(sk, sp, rtol=SC_RTOL, atol=SC_ATOL)
                assert (ik is None and ip_ is None) or torch.equal(ik, ip_)
                assert kernel_lib.LAUNCHES[f"{name}.{ent}"] == 1
        if "bulk" not in entries:  # named for a shape it does not take: raises, uncounted
            kernel_lib.reset_launch_counts()
            with pytest.raises(RuntimeError, match="launch failed"):
                cs.codec_scores(*args, entry="bulk")
            assert all(v == 0 for v in kernel_lib.LAUNCHES.values())
    for B, K, d in ((5, 7, 48), (5, 33, 16), (5, 37, 1024)):
        q, blk, _, csq = _gathered_case(rng, B=B, K=K, d=d)
        for form in ("l2", "dot", "cosine"):
            args = (torch.from_numpy(q).to(dev), torch.from_numpy(blk).to(dev),
                    torch.from_numpy(csq).to(dev),
                    torch.from_numpy(_qsn(q, form)).to(dev),
                    torch.tensor(0.017, device=dev), form)
            for ent in ("stream", "rows"):
                torch.testing.assert_close(cs.codec_scores_gathered(*args, entry=ent),
                                           cs.codec_scores_gathered_plain(*args),
                                           rtol=SC_RTOL, atol=SC_ATOL)
    # B2 and B5. bf16 takes the tensor-core entry at every depth: d=128 and
    # d=48 (one partly filled 64-column box) in the resident layout, d=100 too
    # (its copies padded to 112 columns), d=240 resident for B2 and K-looped
    # for B5, d=784 (13 boxes, the last a quarter full) K-looped for both: B=100
    # is not a multiple of its 128-query tile, the 5 tiles split into spans of
    # 2 + 2 + 1, the last tile holds 1240 padding rows. f32 (full-precision
    # contract) takes the tf32x3 entry, K-looped in 32-column boxes: d=40 (a
    # last box of 8 columns), 128, 784 (the last box half full) and 960. The
    # plain versions' f32 products run in full f32 (TF32 off, as set here).
    torch.backends.cuda.matmul.allow_tf32 = False
    tn, grp, acc = st.SCAN_TN, st.SCAN_GROUP, 2
    for d, dtype, entry in ((128, torch.bfloat16, "wgmma"), (48, torch.bfloat16, "wgmma"),
                            (100, torch.bfloat16, "wgmma"), (240, torch.bfloat16, "wgmma"),
                            (784, torch.bfloat16, "wgmma"),
                            (128, torch.float32, "tf32x3"), (40, torch.float32, "tf32x3"),
                            (784, torch.float32, "tf32x3"), (960, torch.float32, "tf32x3")):
        X = rng.standard_normal((9000, d)).astype(np.float32)
        Xp, xsq, _ = st.pad_corpus(X)
        Xd, xd = torch.from_numpy(Xp).to(dev), torch.from_numpy(xsq).to(dev)
        Q = torch.from_numpy(rng.standard_normal((100, d)).astype(np.float32)).to(dev)
        qs, Xs = st.scan_copy(Q, dtype), st.scan_copy(Xd, dtype)
        kernel_lib.reset_launch_counts()
        # the packed output itself: the decoded value drops LB mantissa bits and
        # the two sides sum in different orders (rtol 1e-4); a near-tie may swap
        # a cell's pick, so loc bits agree on all but a few cells
        pk = st.scan_packed(qs, Xs, xd, tn, grp, acc)
        pp = st.scan_packed_plain(qs, Xs, xd, tn, grp, acc)
        mask = (1 << st._geometry(Xp.shape[0], tn, grp, acc)[4]) - 1
        assert float(((pk & mask) == (pp & mask)).float().mean()) >= 0.999
        torch.testing.assert_close((pk & ~mask).view(torch.float32),
                                   (pp & ~mask).view(torch.float32), rtol=1e-4, atol=1e-4)
        # B5: full f32 values of |x|^2 - 2 q.x, which cancels to near 0 while
        # its terms do not: the two summation orders differ by a few f32
        # roundings at the terms' magnitude |x|^2 + 2 |q.x| (1e-6 of it); ids
        # equal but for near-ties
        uk, jk = st.scan_unpacked(qs, Xs, xd, tn, grp, acc)
        up, jp = st.scan_unpacked_plain(qs, Xs, xd, tn, grp, acc)
        pick = xd[jp.long()]
        assert bool(((uk - up).abs() <= 1e-6 * (pick + (pick - up).abs())).all())
        assert float((jk == jp).float().mean()) >= 0.999
        assert kernel_lib.LAUNCHES[f"scan_topk.{entry}"] == 1
        assert kernel_lib.LAUNCHES[f"scan_topk_unpacked.{entry}"] == 1
        # after the refine both routes and the plain version agree
        Xscan = Xs if dtype == torch.bfloat16 else None
        dk, ik = st.l2_topk(Q, Xd, xd, 10, Xscan=Xscan, acc=acc)
        dp, ipl = st.l2_topk(Q, Xd, xd, 10, Xscan=Xscan, acc=acc, plain=True)
        assert torch.equal(torch.sort(ik, 1).values, torch.sort(ipl, 1).values)
        torch.testing.assert_close(dk, dp, rtol=1e-5, atol=0)
        du, iu = st.l2_topk(Q, Xd, xd, 10, Xscan=Xscan, acc=acc, packed=False)
        assert torch.equal(torch.sort(iu, 1).values, torch.sort(ik, 1).values)
        torch.testing.assert_close(du, dk, rtol=1e-5, atol=0)



@pytest.mark.cuda
def test_id_scores_match_plain_on_card(rng, monkeypatch):
    """``id_scores`` against ``id_scores_plain`` on the card: f32 and bf16
    rows, L2 / Dot / Cosine, B = 1 and 10,000 at K = 384, with -1 ids,
    repeated ids and the table's last row, at every kind of row the kernel
    reads: d = 128, 960 and 2048 (16-byte words, the query in registers),
    36 and 25 (f32 words; bf16 and f32 rows read an element a load), 1536
    (past the registers: 16-byte words in passes), a table whose rows lie
    d + 5 elements apart from an address 4 bytes past a 16-byte boundary.
    Every call launches the kernel (entry by dtype) and none is counted as a
    plain call, but an f16 table's (no kernel entry), which takes the plain
    version and bumps ``id_scores.plain``. +INF exactly at the negative ids;
    elsewhere the two sum the same exact products in different orders and
    differ by at most ``ID_SCORES_TERM_RTOL`` (1e-6) of the terms
    (``chip_smoke.id_scores_err``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile with nvcc for sm_90a")
    from hnsw_tpu_torch.ops import id_scores as isc
    from hnsw_tpu_torch.utils.profiling import PROFILER

    smoke = _chip_smoke()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(PROFILER, "enabled", True)
    N, K = 50_000, 384
    cases = [(d, dtype, False) for d in (128, 960, 36, 25, 1536)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(2048, torch.bfloat16, False), (128, torch.float32, True),
              (128, torch.bfloat16, True), (128, torch.float16, False)]
    for d, dtype, strided in cases:
        if strided:  # rows d + 5 apart, the first 4 bytes past a boundary
            W = torch.from_numpy(rng.standard_normal((N, d + 5)).astype(np.float32))
            V = W.to(dev).to(dtype)[:, 1:1 + d]
            assert V.stride() == (d + 5, 1)
        else:
            V = torch.from_numpy(rng.standard_normal((N, d)).astype(np.float32)).to(
                dev).to(dtype).contiguous()
        Vf = V.float()
        sq = (Vf * Vf).sum(-1)
        del Vf
        entry = isc.id_scores_entry("L2", dtype)
        for B in (1, 10_000):
            q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).to(dev)
            ids = torch.from_numpy(rng.integers(-1, N, (B, K)).astype(np.int32)).to(dev)
            ids[:, :5] = torch.tensor([N - 1, N - 1, -1, 7, 7], dtype=torch.int32)
            for metric in ("L2", "Dot", "Cosine"):
                kernel_lib.reset_launch_counts()
                PROFILER.reset()
                got = isc.id_scores(metric, q, V, sq, ids)
                torch.cuda.synchronize()
                counters = PROFILER.report().get("counters", {})
                if entry is None:
                    assert kernel_lib.LAUNCHES["id_scores"] == 0
                    assert counters.get("id_scores.plain") == 1
                else:
                    assert kernel_lib.LAUNCHES[f"id_scores.{entry}"] == 1
                    assert "id_scores.plain" not in counters
                assert torch.equal(torch.isinf(got), ids < 0)
                assert bool((got[ids < 0] > 0).all())
                for s in range(0, B, 2048):  # the plain copy, 2048 queries at a time
                    c = slice(s, s + 2048)
                    want = isc.id_scores_plain(metric, q[c], V, sq, ids[c])
                    err = smoke.id_scores_err(torch, metric, got[c], want, q[c], sq,
                                              ids[c])
                    assert err <= smoke.ID_SCORES_TERM_RTOL, (d, dtype, strided, B,
                                                              metric, err)
                del got
        del V, sq
    PROFILER.reset()


@pytest.mark.cuda
def test_captured_search_without_codec_equals_eager_on_card(rng):
    """A search program captured at sift1m's settings without a codec (M =
    48, ef 128, expand 4: the beam scores f32 rows through ``id_scores``)
    answers what the eager ``search_program`` answers, and none of its
    scores take the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile with nvcc for sm_90a")
    from hnsw_tpu_torch import Hnsw
    from hnsw_tpu_torch.ops.beam_search import (device_search_batch, search_program,
                                                serve_static)
    from hnsw_tpu_torch.utils.profiling import PROFILER

    X = rng.standard_normal((20_000, 128)).astype(np.float32)
    Q = rng.standard_normal((2048, 128)).astype(np.float32)
    h = Hnsw(max_nb_connection=48, max_elements=len(X), ef_construction=200, dist="L2",
             device="cuda")
    h.set_traversal_codec(None)
    h.parallel_insert(X, mode="device", batch_size=4096)
    was = PROFILER.enabled
    PROFILER.enabled = True
    PROFILER.reset()
    try:
        kernel_lib.reset_launch_counts()
        ids_p, d_p = device_search_batch(h, Q, 10, 128)  # captures, then replays
        ids_p2, d_p2 = device_search_batch(h, Q, 10, 128)
        assert kernel_lib.LAUNCHES["id_scores.f32"] > 0
        assert "id_scores.plain" not in PROFILER.report().get("counters", {})
    finally:
        PROFILER.enabled = was
        PROFILER.reset()
    g = h.device_graph()
    q = torch.as_tensor(Q, device=g.vectors.device)
    ids_e, d_e = search_program(g, q, None, codec=None,
                                **serve_static(None, ef=128, knbn=10))
    ids_e = ids_e.cpu().numpy().astype(np.int64)
    d_e = d_e.cpu().numpy()
    ids_e[~np.isfinite(d_e)] = -1
    np.testing.assert_array_equal(ids_p, ids_e)
    np.testing.assert_array_equal(ids_p2, ids_e)
    np.testing.assert_array_equal(d_p, d_e)
