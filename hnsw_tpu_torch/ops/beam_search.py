"""Batched HNSW search over the dense graph — counterpart of
``hnsw_tpu/ops/beam_search.py``.

A batch of queries advances in lock-step; per iteration each query

  1. picks its ``expand`` nearest not-yet-expanded beam entries,
  2. scores their whole layer-0 neighbourhoods — through the int8 codec
     (kernel B1, ``ops/codec_scores.py``, which also returns the neighbour
     ids; or, with ``allow_fused=False``, a torch gather of the blocks and
     kernel B4 over them) or the exact f32 vector gather,
  3. suppresses revisits (beam membership, an expansion-history ring and
     intra-step duplicates), and
  4. merges beam and candidates into the best ``ef``.

Termination follows the reference's rule (nearest unexpanded candidate
farther than the worst kept result). An iteration is three pieces
(``beam_setup``, ``beam_step``, ``beam_finish``; ``search_begin`` and
``search_end`` around them): the eager ``search_program`` runs up to
``max_iters`` iterations and stops as soon as every query is done, and
``ops/program.py`` captures the same pieces as the device program the serving
entry points replay (one graph up to 48 iterations, as the reference
unrolls; chunks above). The 8/128 alignment gate on the kernels is gone: both
codec kernels serve every loop length and shape, and ``allow_fused`` — which
the JAX package derives from ``max_iters <= 48`` — is the caller's switch
here. Revisit tests are
sorted-membership lookups (``torch.searchsorted``) instead of [B, K, H]
broadcast compares; the answers are the same.

With the int8 codec, traversal scores follow the kernel's arithmetic (f32
query against dequantized blocks), not the JAX CPU path's int8 x int8 dot
against a quantized query; the final beam is re-scored exactly either way
(``exact_rerank``). Sorts are stable, so ties go to the lower position as
with ``lax.top_k``; ``lax.sort`` promises no tie order, so tie order can
differ from the JAX package where distances are equal.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..filter import filter_mask
from ..utils.profiling import PROFILER
from .codec_scores import codec_scores, codec_scores_gathered

INF = float("inf")


def smallest(x, k: int):
    """(values, positions) of the ``k`` smallest entries per row, ascending;
    ties keep the lower position (``lax.top_k`` on the negated scores)."""
    v, i = torch.sort(x, dim=1, stable=True)
    return v[:, :k], i[:, :k]


def _ip_f32(q, cvecs):
    """[B,d] x [B,K,d] inner products in f32. A bf16 store is scored as f32
    products of the bf16-rounded inputs (the JAX package's bf16-in, f32-out einsum):
    a bf16 einsum would round its result to bf16."""
    if cvecs.dtype == torch.bfloat16:
        a = q.to(torch.bfloat16).to(torch.float32)
    else:
        a = q.to(torch.float32)
    return torch.einsum("bd,bkd->bk", a, cvecs.to(torch.float32))


def scores_gathered(metric_name: str, q, cvecs, csq=None):
    """Distance of each query to its gathered candidates: [B,d] x [B,K,d] -> [B,K]."""
    from .distances import get_metric

    qf = q.to(torch.float32)
    if metric_name in ("L2", "DistL2"):
        g = _ip_f32(q, cvecs)
        sq = (qf * qf).sum(-1)[:, None]
        if csq is None:
            cf = cvecs.to(torch.float32)
            csq = (cf * cf).sum(-1)
        return torch.sqrt(torch.clamp_min(sq - 2.0 * g + csq, 0.0))
    if metric_name in ("Dot", "DistDot"):
        return 1.0 - _ip_f32(q, cvecs)
    if metric_name in ("Cosine", "DistCosine"):
        s = _ip_f32(q, cvecs)
        cf = cvecs.to(torch.float32)
        denom = torch.linalg.norm(qf, dim=-1)[:, None] * torch.linalg.norm(cf, dim=-1)
        return 1.0 - torch.where(denom > 0, s / torch.clamp_min(denom, 1e-10), 0.0)
    m = get_metric(metric_name)
    if m.scores is None:
        raise NotImplementedError(f"metric {metric_name} has no batched form")
    return m.scores(q, cvecs)


def scores_matmul(metric_name: str, q, pv, psq):
    """Distances of every query to a fixed pivot set through one matmul:
    [B,d] x [P,d] -> [B,P] (inner-product family; other metrics through their
    ``matmul_scores``, a user metric's included)."""
    qf = q.to(torch.float32)
    if metric_name in ("L2", "DistL2", "Dot", "DistDot", "Cosine", "DistCosine"):
        g = qf @ pv.to(torch.float32).T
    if metric_name in ("L2", "DistL2"):
        qsq = (qf * qf).sum(-1)[:, None]
        return torch.sqrt(torch.clamp_min(qsq - 2.0 * g + psq[None, :], 0.0))
    if metric_name in ("Dot", "DistDot"):
        return 1.0 - g
    if metric_name in ("Cosine", "DistCosine"):
        qn = torch.linalg.norm(qf, dim=-1)[:, None]
        pn = torch.sqrt(torch.clamp_min(psq, 1e-20))[None, :]
        return 1.0 - g / torch.clamp_min(qn * pn, 1e-10)
    from .distances import get_metric
    m = get_metric(metric_name)
    if m.matmul_scores is not None:
        return m.matmul_scores(qf, pv, psq)
    raise NotImplementedError(f"pivot scan unsupported for {metric_name}")


def _dedup_pairs(ids, dd):
    """Remove duplicate ids from (ids, dists) rows: sort by id, mask repeats,
    re-sort by distance."""
    B = ids.shape[0]
    si, o = torch.sort(ids, dim=1, stable=True)
    sd = torch.gather(dd, 1, o)
    dup = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=ids.device),
                     si[:, 1:] == si[:, :-1]], dim=1) | (si < 0)
    sd = torch.where(dup, INF, sd)
    si = torch.where(dup, -1, si)
    sd2, o2 = torch.sort(sd, dim=1, stable=True)
    return torch.gather(si, 1, o2), sd2


def _merge_beam(beam_ids, beam_d, new_ids, new_d, ef: int):
    """(beam ∪ candidates) -> best ef, ascending (exact, one key-value sort)."""
    cat_ids = torch.cat([beam_ids, new_ids], dim=1)
    cat_d = torch.cat([beam_d, new_d], dim=1)
    sd, o = torch.sort(cat_d, dim=1, stable=True)
    return torch.gather(cat_ids, 1, o[:, :ef]), sd[:, :ef]


def _member(x, pool):
    """[B,K] bool: is x[b,k] one of pool[b,:]? (sorted lookup)"""
    ps = torch.sort(pool, dim=1).values
    pos = torch.searchsorted(ps, x.contiguous())
    return torch.gather(ps, 1, torch.clamp_max(pos, ps.shape[1] - 1)) == x


def _first_occurrence_dups(nbr, valid):
    """[B,K] bool: a valid entry whose id already occurs at a lower position
    among the valid entries (the intra-step duplicate mask)."""
    B = nbr.shape[0]
    key = torch.where(valid, nbr, -1)
    sk, order = torch.sort(key, dim=1, stable=True)
    ds = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=nbr.device),
                    sk[:, 1:] == sk[:, :-1]], dim=1) & (sk >= 0)
    return torch.empty_like(ds).scatter_(1, order, ds)


def scores_codec(codec, q, src_c, qsq, qnorm, allow_fused: bool = True):
    """Approximate distances of each query to the E expanded nodes' full
    neighbourhoods through the blocked codec: [B,E] -> ([B,E*M0], ids or
    None). int8 codecs go through ``codec_scores`` (kernel B1/B3 on the card,
    its plain version on the CPU), which reads the blocks where they lie; with
    ``allow_fused=False`` the vector rows and their ``blocks_sq`` are gathered
    with torch indexing first and scored by ``codec_scores_gathered`` (kernel
    B4), which returns no ids. bf16 codecs take a plain gather."""
    m = codec.metric_name
    form = "l2" if m in ("L2", "DistL2") else "dot" if m in ("Dot", "DistDot") else "cosine"
    qsn = qsq if form == "l2" else qnorm
    B, E = src_c.shape
    K = E * codec.M0
    if codec.blocks.dtype == torch.int8:
        if allow_fused:
            return codec_scores(src_c, q, qsn, codec.scale, codec.blocks, codec.M0, form)
        rows = src_c.long()
        blk = codec.blocks[rows, :codec.M0]  # [B, E, M0, d]: vector rows only
        csq = codec.blocks_sq[rows].reshape(B, K)
        return codec_scores_gathered(q, blk.reshape(B, K * codec.dim), csq, qsn,
                                     codec.scale, form), None
    blk = codec.blocks[src_c.long()][:, :, :codec.M0].reshape(B, K, codec.dim)
    ip = _ip_f32(q, blk) * codec.scale
    if form == "l2":
        csq = codec.blocks_sq[src_c.long()].reshape(B, K)
        return torch.sqrt(torch.clamp_min(qsq - 2.0 * ip + csq, 0.0)), None
    if form == "dot":
        return 1.0 - ip, None
    return 1.0 - ip / qnorm, None


def exact_rerank(metric_name, vectors, sqnorms, q, ids, k: int):
    """Re-score candidate ids against the exact f32 vectors; best k ascending."""
    cap1 = vectors.shape[0]
    safe = torch.clamp(ids, 0, cap1 - 1).long()
    sc = scores_gathered(metric_name, q, vectors[safe], sqnorms[safe])
    sc = torch.where(ids >= 0, sc, INF)
    v, order = smallest(sc, k)
    out_ids = torch.gather(ids, 1, order)
    return torch.where(v < INF, out_ids, -1), v


def beam_iters(ef: int, expand: int, max_iters: Optional[int] = None) -> int:
    """The beam loop's iteration cap: ``max_iters``, or the reference's default
    ``max(16, 4*ef // expand + 32)``."""
    if max_iters is None:
        return max(16, (4 * int(ef)) // int(expand) + 32)
    return int(max_iters)


class BeamState:
    """One batch's beam loop between iterations: the tensors an iteration
    replaces (``CARRY``; the history ring ``hist`` is written in place) and
    what every iteration reads (queries, tables, codec, static sizes)."""

    CARRY = ("done", "beam_ids", "beam_d", "res_ids", "res_d", "pool_ids", "pool_d")


def beam_setup(metric_name: str, vectors, sqnorms, tbl_ids, q, start_ids,
               start_dists, *, ef: int, expand: int = 4, mask=None, active=None,
               max_iters: Optional[int] = None, codec=None, term_slack: float = 1.0,
               pool: int = 0, allow_fused: bool = True) -> BeamState:
    """The beam loop's set-up (arguments as ``beam_search_layer``): the
    start beams, the reservoir, the history ring and the query norms."""
    st = BeamState()
    B, d = q.shape
    cap1, M = tbl_ids.shape
    dev = q.device
    E = int(expand)
    st.max_iters = beam_iters(ef, E, max_iters)
    st.n_slots = min(st.max_iters, (2 * ef) // E + 16)
    H = E * max(st.n_slots, 1)
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    if start_ids.ndim == 1:
        start_ids = start_ids[:, None]
        start_dists = start_dists[:, None]
    S = start_ids.shape[1]
    assert S <= ef and (not pool or S <= int(pool)), (S, ef, pool)
    start_ids = start_ids.to(torch.int32)
    start_dists = start_dists.to(torch.float32)
    start_ok = active[:, None] & (start_ids >= 0)
    pad_ids = torch.full((B, ef - S), -1, dtype=torch.int32, device=dev)
    pad_d = torch.full((B, ef - S), INF, device=dev)
    st.beam_ids = torch.cat([torch.where(start_ok, start_ids, -1), pad_ids], dim=1)
    st.beam_d = torch.cat([torch.where(start_ok, start_dists, INF), pad_d], dim=1)
    st.use_mask = mask is not None
    st.res_ids = st.res_d = st.pool_ids = st.pool_d = None
    if st.use_mask:
        start_pass = start_ok & mask[torch.clamp(start_ids, 0, cap1 - 1).long()]
        st.res_ids = torch.cat([torch.where(start_pass, start_ids, -1), pad_ids], dim=1)
        st.res_d = torch.cat([torch.where(start_pass, start_dists, INF), pad_d], dim=1)
    st.R = R = int(pool)
    if R:
        seed_ok = start_pass if st.use_mask else start_ok
        st.pool_ids = torch.cat([torch.where(seed_ok, start_ids, -1),
                                 torch.full((B, R - S), -1, dtype=torch.int32, device=dev)], 1)
        st.pool_d = torch.cat([torch.where(seed_ok, start_dists, INF),
                               torch.full((B, R - S), INF, device=dev)], 1)
    st.hist = torch.full((B, H), -2, dtype=torch.int32, device=dev)  # -2 matches nothing
    st.done = ~start_ok.any(dim=1)
    qf = q.to(torch.float32)
    st.qsq = (qf * qf).sum(-1)[:, None]
    st.qnorm = torch.sqrt(torch.clamp_min(st.qsq, 1e-20))
    # the kernel's id output replaces the table gather when the codec blocks
    # carry this table's rows
    st.codec_ids = (allow_fused and codec is not None and codec.id_rows > 0
                    and codec.M0 == M and codec.blocks.dtype == torch.int8)
    st.metric_name, st.vectors, st.sqnorms, st.tbl_ids = metric_name, vectors, sqnorms, tbl_ids
    st.q, st.mask, st.codec, st.allow_fused = q, mask, codec, allow_fused
    st.ef, st.E, st.M, st.K, st.cap1 = ef, E, M, E * M, cap1
    st.term_slack = term_slack
    return st


def beam_select(st: BeamState):
    """Step 1 of an iteration: the E nearest unexpanded beam entries
    (expanded == in the ring) and the termination test. Returns (step_done,
    act, sel_d, pos)."""
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


def beam_expand(st: BeamState, it: int, step_done, act, sel_d, pos):
    """Steps 2-5 of iteration ``it`` (a Python int, so the ring slot is a
    static slice): log the selected entries in the history ring, score their
    neighbourhoods, suppress revisits and merge into the beams."""
    B, E, M, K, cap1 = st.beam_ids.shape[0], st.E, st.M, st.K, st.cap1
    # 2. log them in the history ring and fetch their neighbourhoods
    sel_ok = act[:, None] & (sel_d < INF)
    src = torch.gather(st.beam_ids, 1, pos)
    slot = (it % st.n_slots) * E
    st.hist[:, slot:slot + E] = torch.where(sel_ok, src, -2)
    src_c = torch.clamp(src, 0, cap1 - 1)
    sc = None
    if st.codec is not None:
        sc, nbr = scores_codec(st.codec, st.q, src_c, st.qsq, st.qnorm, st.allow_fused)
    if not st.codec_ids:
        nbr = st.tbl_ids[src_c.long()].reshape(B, K)
    valid = sel_ok[:, :, None].expand(B, E, M).reshape(B, K) & (nbr >= 0)
    # 3. revisit suppression: beam, history ring, intra-step duplicates
    in_beam = _member(nbr, st.beam_ids)
    in_hist = _member(nbr, st.hist)
    dup = _first_occurrence_dups(nbr, valid)
    valid = valid & ~in_beam & ~in_hist & ~dup
    nbr_c = torch.where(valid, nbr, cap1 - 1).long()
    # 4. exact f32 scores when there is no codec
    if sc is None:
        sc = scores_gathered(st.metric_name, st.q, st.vectors[nbr_c], st.sqnorms[nbr_c])
    sc = torch.where(valid, sc, INF)
    new_ids = torch.where(valid, nbr, -1)
    # 5. merge into the beams
    st.beam_ids, st.beam_d = _merge_beam(st.beam_ids, st.beam_d, new_ids, sc, st.ef)
    if st.use_mask:
        passf = valid & st.mask[nbr_c]
        st.res_ids, st.res_d = _merge_beam(st.res_ids, st.res_d,
                                           torch.where(passf, nbr, -1),
                                           torch.where(passf, sc, INF), st.ef)
    if st.R:
        c_ids = torch.where(passf, nbr, -1) if st.use_mask else new_ids
        c_d = torch.where(passf, sc, INF) if st.use_mask else sc
        st.pool_ids, st.pool_d = _merge_beam(st.pool_ids, st.pool_d, c_ids, c_d, st.R)
    st.done = step_done


def beam_step(st: BeamState, it: int):
    """Iteration ``it`` with no host read. Once every query is done it
    changes no output: ``done`` is sticky, so nothing is selected or valid,
    every merge keeps its (sorted) beam, and the ring's -2 writes are read by
    no later selection that could act."""
    beam_expand(st, it, *beam_select(st))


def beam_run(st: BeamState):
    """The eager loop: up to ``max_iters`` iterations, stopping at the first
    in which every query is done (one host read per iteration)."""
    for it in range(st.max_iters):
        sel = beam_select(st)
        if not bool(sel[1].any()):
            break  # every query done: the rest of the iteration is a no-op
        beam_expand(st, it, *sel)


def beam_finish(st: BeamState):
    """The loop's outputs: the (filtered) result beam, and the deduplicated
    reservoir when there is one."""
    out_ids, out_d = (st.res_ids, st.res_d) if st.use_mask else (st.beam_ids, st.beam_d)
    if st.R:
        pool_ids, pool_d = _dedup_pairs(st.pool_ids, st.pool_d)
        return out_ids, out_d, pool_ids, pool_d
    return out_ids, out_d


def beam_search_layer(metric_name: str, vectors, sqnorms, tbl_ids, q, start_ids,
                      start_dists, *, ef: int, expand: int = 4,
                      mask=None, active=None, max_iters: Optional[int] = None,
                      codec=None, term_slack: float = 1.0, pool: int = 0,
                      allow_fused: bool = True):
    """Beam search within one layer for a batch of queries.

    Args:
      vectors: [cap1, d] — row cap1-1 is the reserved sink row.
      tbl_ids: [cap1, M] neighbour table of this layer (-1 padded).
      q: [B, d] queries. start_ids/start_dists: [B] or [B, S] entries.
      mask: optional [cap1] bool — result-beam admission filter.
      active: optional [B] bool — queries to run.
      codec: optional BeamCodec — traversal scores from the blocked store;
        callers ``exact_rerank`` the returned beam.
      pool: if > 0, also keep every scored candidate in a top-``pool``
        reservoir (deduped at the end), returned as third/fourth outputs.
      allow_fused: int8 codec only — True scores through the fused gather +
        score kernel, False through a torch gather and the gathered-blocks
        kernel (neighbour ids then come from ``tbl_ids``).

    Returns (beam_ids [B,ef], beam_dists [B,ef]) ascending (the filtered
    result beam under ``mask``), plus (pool_ids, pool_dists) when ``pool``.
    The loop is eager (``beam_run``); ``ops/program.py`` replays the same
    pieces as a fixed-trip program.
    """
    st = beam_setup(metric_name, vectors, sqnorms, tbl_ids, q, start_ids, start_dists,
                    ef=ef, expand=expand, mask=mask, active=active, max_iters=max_iters,
                    codec=codec, term_slack=term_slack, pool=pool,
                    allow_fused=allow_fused)
    beam_run(st)
    return beam_finish(st)


def _best_neighbour(metric_name, vectors, sqnorms, tbl, q, pivot, act):
    cap1 = vectors.shape[0]
    nbr = tbl[torch.clamp(pivot, 0, cap1 - 1).long()]  # [B, M]
    valid = (nbr >= 0) & act[:, None]
    nbr_c = torch.where(valid, nbr, cap1 - 1).long()
    sc = scores_gathered(metric_name, q, vectors[nbr_c], sqnorms[nbr_c])
    sc = torch.where(valid, sc, INF)
    j = torch.argmin(sc, dim=1, keepdim=True)  # first minimum, as jnp.argmin
    return torch.gather(sc, 1, j)[:, 0], torch.gather(nbr, 1, j)[:, 0]


def greedy_scan_descent(metric_name, vectors, sqnorms, layer_ids, q, pivot, pivot_d,
                        top_layer: int, stop_layer: int = 0, stop_level=None):
    """Upper-layer descent of the production search path — one scan of the
    pivot's stored neighbour list per layer, moving to the best improving
    neighbour (reference ``src/hnsw.rs:1511-1529``)."""
    B = q.shape[0]
    for layer in range(top_layer, stop_layer, -1):
        if layer >= len(layer_ids):
            continue
        act = (torch.ones((B,), dtype=torch.bool, device=q.device)
               if stop_level is None else (layer > stop_level))
        best_d, best_i = _best_neighbour(metric_name, vectors, sqnorms,
                                         layer_ids[layer], q, pivot, act)
        better = act & (best_d < pivot_d)
        pivot = torch.where(better, best_i, pivot)
        pivot_d = torch.where(better, best_d, pivot_d)
    return pivot, pivot_d


MAX_HOPS = 64  # hops of one layer's insert-path descent


class DescentState:
    """One layer of the insert-path descent between hops: each walker's
    position ``p`` and distance ``pd``, whether it improved on its last hop,
    and which walkers run (``act``). A hop updates them in place, so a
    captured hop reads and writes the same buffers."""

    def __init__(self, pivot, pivot_d, act):
        self.p, self.pd = pivot.clone(), pivot_d.clone()
        self.improved, self.act = act.clone(), act


def descent_hop(ds: DescentState, metric_name, vectors, sqnorms, tbl, q):
    """One hop to the best improving neighbour. Once no walker improved it
    changes nothing (no walker is active, so no neighbour scores)."""
    best_d, best_i = _best_neighbour(metric_name, vectors, sqnorms, tbl, q, ds.p,
                                     ds.improved)
    better = ds.improved & (best_d < ds.pd)
    ds.p.copy_(torch.where(better, best_i, ds.p))
    ds.pd.copy_(torch.where(better, best_d, ds.pd))
    ds.improved.copy_(better)


def descent_layer(ds: DescentState, metric_name, vectors, sqnorms, tbl, q,
                  max_hops: int = MAX_HOPS):
    """The eager hop loop of one layer: stops at the first hop in which no
    walker improved (one host read a hop)."""
    for _ in range(max_hops):
        if not bool(ds.improved.any()):
            break
        descent_hop(ds, metric_name, vectors, sqnorms, tbl, q)


# Termination slack with a quantized codec when the caller picks none.
DEFAULT_CODEC_SLACK = 1.0


def _resolve_slack(term_slack, codec) -> float:
    if term_slack is not None:
        return float(term_slack)
    return DEFAULT_CODEC_SLACK if codec is not None else 1.0


def search_iters(ef: int, knbn: int, expand: int, max_iters=None,
                 pool: Optional[int] = None) -> int:
    """The beam loop's iteration cap for ``search_program``'s arguments."""
    P = 0 if pool is None else max(int(pool), knbn)
    return beam_iters(ef if P else max(ef, knbn), expand, max_iters)


class SearchState:
    """One batch between ``search_begin`` and ``search_end``: the beam loop's
    state (``beam``) and what the rerank reads."""


def search_begin(g, q, mask, *, ef: int, knbn: int, expand: int, use_mask: bool,
                 max_iters=None, codec=None, term_slack: float = 1.0,
                 rerank: Optional[int] = None, pool: Optional[int] = None,
                 seeds: int = 1, allow_fused: bool = True) -> SearchState:
    """The search's prologue: entry from one matmul over the pivot set (or the
    greedy descent on small graphs), then the layer-0 beam's set-up."""
    s = SearchState()
    s.g, s.q = g, q.to(torch.float32)
    q = s.q
    B = q.shape[0]
    layer0 = next((l for l, ne in enumerate(g.layer_nonempty) if ne), 0)
    if g.pivot_ids is not None:
        pv = g.vectors[g.pivot_ids.long()].to(torch.float32)
        psc = scores_matmul(g.metric_name, q, pv, g.sqnorms[g.pivot_ids.long()])
        if seeds > 1:
            d0, j = smallest(psc, seeds)
            pivot = g.pivot_ids[j]
        else:
            j = torch.argmin(psc, dim=1, keepdim=True)
            pivot = g.pivot_ids[j[:, 0]]
            d0 = torch.gather(psc, 1, j)[:, 0]
    else:
        ev = g.vectors[g.entry][None, None, :].expand(B, 1, q.shape[1])
        d0 = scores_gathered(g.metric_name, q, ev,
                             g.sqnorms[g.entry].reshape(1, 1).expand(B, 1))[:, 0]
        pivot = torch.full((B,), g.entry, dtype=torch.int32, device=q.device)
        pivot, d0 = greedy_scan_descent(g.metric_name, g.vectors, g.sqnorms,
                                        g.layer_ids, q, pivot, d0,
                                        top_layer=g.num_layers - 1,
                                        stop_layer=max(layer0, 0))
    tbl = (g.layer_ids[layer0] if layer0 < g.num_layers
           else torch.full((g.cap1, 1), -1, dtype=torch.int32, device=q.device))
    if codec is not None and codec.M0 < tbl.shape[1]:
        tbl = tbl[:, :codec.M0].contiguous()  # width-capped codec: same slice
    s.P = 0 if pool is None else max(int(pool), knbn)
    s.ef_t = ef if s.P else max(ef, knbn)
    s.knbn, s.rerank, s.codec = knbn, rerank, codec
    s.beam = beam_setup(g.metric_name, g.vectors, g.sqnorms, tbl, q, pivot, d0,
                        ef=s.ef_t, expand=expand, max_iters=max_iters,
                        mask=mask if use_mask else None, codec=codec,
                        term_slack=term_slack, pool=s.P, allow_fused=allow_fused)
    return s


def search_end(s: SearchState):
    """The search's epilogue: the beam's outputs, then the exact f32 rerank of
    the beam or the pool (with a codec or a pool). Returns (ids, dists)
    [B, knbn]."""
    out = beam_finish(s.beam)
    if s.P:
        _, _, ids, dists = out
    else:
        ids, dists = out
    g, knbn = s.g, s.knbn
    if s.codec is not None or s.P:
        R = ids.shape[1] if s.rerank is None else max(int(s.rerank), knbn)
        R = min(R, ids.shape[1])
        ids, dists = exact_rerank(g.metric_name, g.vectors, g.sqnorms, s.q,
                                  ids[:, :R], min(max(s.ef_t, knbn, s.P), R))
    return ids[:, :knbn], dists[:, :knbn]


def search_program(g, q, mask, *, ef: int, knbn: int, expand: int, use_mask: bool,
                   max_iters=None, codec=None, term_slack: float = 1.0,
                   rerank: Optional[int] = None, pool: Optional[int] = None,
                   seeds: int = 1, allow_fused: bool = True):
    """Full production search (reference ``search_filter``,
    ``src/hnsw.rs:1487-1599``): entry from one matmul over the pivot set (or
    the greedy descent on small graphs), the layer-0 beam (through the codec
    when given), then an exact f32 rerank of the beam or the pool. This is
    the eager form, one host read per beam iteration; ``ops/program.py``
    captures the same pieces (``search_begin``, ``beam_step``,
    ``search_end``) as the device program the serving entry points replay."""
    s = search_begin(g, q, mask, ef=ef, knbn=knbn, expand=expand, use_mask=use_mask,
                     max_iters=max_iters, codec=codec, term_slack=term_slack,
                     rerank=rerank, pool=pool, seeds=seeds, allow_fused=allow_fused)
    beam_run(s.beam)
    return search_end(s)


def serve_static(codec, *, ef: int, knbn: int, expand: int = 4, max_iters=None,
                 term_slack: float | None = None, rerank: int | None = None,
                 pool: int | None = None, seeds: int = 4, allow_fused: bool = True,
                 use_mask: bool = False) -> dict:
    """``search_program``'s static arguments as the serving entry points
    derive them (``max_iters`` ``max(8, ef // expand + 2)``, the codec's
    termination slack): the key of the program they replay."""
    if max_iters is None:
        max_iters = max(8, int(ef) // int(expand) + 2)
    return dict(ef=int(ef), knbn=int(knbn), expand=int(expand), use_mask=bool(use_mask),
                max_iters=int(max_iters), term_slack=_resolve_slack(term_slack, codec),
                rerank=rerank, pool=pool, seeds=int(seeds), allow_fused=bool(allow_fused))


def _device_mask(hnsw, g, filter):
    m = np.zeros(g.cap1, bool)
    m[: hnsw._nb_point] = filter_mask(filter, hnsw._origin[: hnsw._nb_point])
    return torch.as_tensor(m, device=g.vectors.device)


def device_search_stream(hnsw, queries: np.ndarray, knbn: int, ef: int,
                         batch: int = 4096, expand: int = 4, max_iters=None,
                         term_slack: float | None = None,
                         rerank: int | None = None, query_dtype=None,
                         filter=None, pool: int | None = None, seeds: int = 4,
                         allow_fused: bool = True):
    """Pipelined serving over a host query stream: batch i+1 uploads and
    batch i-1 comes back while batch i is searched by the index's search
    program (``Hnsw.device_program``: captured on the card, built for the
    full and the tail batch before the stream's threads start). Returns (ids,
    dists) over all queries (internal ids, -1 padded). ``query_dtype="f16"``
    sends the queries as float16 (all device math stays f32). ``allow_fused``
    as in ``beam_search_layer``."""
    from .stream import pipelined_stream, upload_batch, fetch_host

    with PROFILER.span("search.call"):
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if query_dtype in ("f16", "float16", np.float16):
            q = q.astype(np.float16)
        elif query_dtype not in (None, "f32", "float32", np.float32):
            raise ValueError(f"unsupported query_dtype {query_dtype!r}")
        nq = q.shape[0]
        out_i = np.full((nq, knbn), -1, np.int64)
        out_d = np.full((nq, knbn), np.inf, np.float32)
        work = [(s, min(s + batch, nq)) for s in range(0, nq, batch)]
        with PROFILER.span("search.prepare"):
            g = hnsw.device_graph()
            codec = hnsw.device_codec()
            mask = _device_mask(hnsw, g, filter) if filter is not None else None
            dev = g.vectors.device
            # the programs of the full and the tail batch, built before the
            # stream's threads start: a capture refuses the uploader's pinned copies
            dtype = torch.from_numpy(q[:0]).dtype
            static = serve_static(codec, ef=ef, knbn=knbn, expand=expand, max_iters=max_iters,
                                  term_slack=term_slack, rerank=rerank, pool=pool, seeds=seeds,
                                  allow_fused=allow_fused, use_mask=filter is not None)
            programs = {we - ws: hnsw.device_program(we - ws, dtype, **static)
                        for ws, we in work}

        def _upload(w):
            ws, we = w
            return upload_batch(q[ws:we], dev)

        def _dispatch(w, staged):
            x = staged.wait()
            return fetch_host(programs[x.shape[0]].run(x, mask))

        def _fetch(w, out):
            ws, we = w
            ids_h, d_h = out.get()
            ids_h = ids_h.astype(np.int64)
            ids_h[~np.isfinite(d_h)] = -1
            out_i[ws:we] = ids_h
            out_d[ws:we] = d_h

        PROFILER.add("stream.queries", nq)
        pipelined_stream(work, _upload, _dispatch, _fetch)
        return out_i, out_d


def device_search_batch(hnsw, queries: np.ndarray, knbn: int, ef: int, filter=None,
                        expand: int = 4, max_iters=None,
                        term_slack: float | None = None, pool: int | None = None,
                        seeds: int = 4, allow_fused: bool = True):
    """Host wrapper: snapshot the graph (cached), build the filter mask, run
    the index's search program for this batch (``Hnsw.device_program``),
    return numpy (internal ids [B,knbn] -1-padded, dists)."""
    q = np.asarray(queries, np.float32)
    if q.ndim == 1:
        q = q[None, :]
    if hnsw._nb_point == 0:
        B = q.shape[0]
        return np.full((B, knbn), -1, np.int64), np.full((B, knbn), np.inf, np.float32)
    with PROFILER.span("search.prepare"):
        g = hnsw.device_graph()
        codec = hnsw.device_codec()
        mask = _device_mask(hnsw, g, filter) if filter is not None else None
        prog = hnsw.device_program(q.shape[0], torch.float32, **serve_static(
            codec, ef=ef, knbn=knbn, expand=expand, max_iters=max_iters,
            term_slack=term_slack, pool=pool, seeds=seeds, allow_fused=allow_fused,
            use_mask=filter is not None))
    ids, dists = prog.run(torch.as_tensor(q, device=g.vectors.device), mask)
    ids = ids.cpu().numpy().astype(np.int64)
    dists = dists.cpu().numpy()
    ids[~np.isfinite(dists)] = -1
    return ids, dists
