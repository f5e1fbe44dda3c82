"""Synchronized batched insertion rounds — counterpart of
``hnsw_tpu/ops/insert_rounds.py``.

B points per round move through the whole insert pipeline together:

  1. upper-layer greedy descent (ef=1) with the reference's projection links
     (``src/hnsw.rs:1114-1155``)
  2. per-layer beam search with ef_construction (``beam_search_layer``)
  3. vectorized heuristic neighbour selection (the diversity prune of
     ``select_neighbours``, ``src/hnsw.rs:1299-1421``)
  4. forward-row writes, then a deterministic sort-based reverse-link merge
     in place of the reference's per-point locks
     (``reverse_update_neighborhood_simple``, ``src/hnsw.rs:1241-1289``).

Points within a round do not see each other; the result is deterministic
given (data order, batch size). The rounds have no Pallas kernel in the JAX
package either: they are sorts, gathers and scatters, written here as torch
ops. Translation notes:

  * ``lax.sort`` with ``num_keys=2`` is two chained stable sorts (minor key
    first); ``jnp.argsort`` (stable) is ``torch.sort(stable=True)``;
    ``lax.top_k`` is a stable ascending sort (ties to the lower index).
  * ``.at[].set`` with repeated indices only ever repeats the sink row, whose
    contents no search reads; ``.at[].add`` is ``index_add_`` over the taken
    entries (``_add_counts``).
  * ``bitcast_convert_type`` is ``Tensor.view(torch.int32)``; ``lax.cummax``
    is ``torch.cummax``; ``lax.cond`` a Python ``if`` on ``need.any()``.
  * The layer tables are updated in place (the JAX program donates them).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .beam_search import (scores_gathered, beam_search_layer, greedy_min_descent,
                          smallest)

INF = float("inf")


def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class RoundConfig:
    """Per-round configuration (see the JAX package's ``RoundConfig``)."""

    B: int
    cap1: int
    num_layers: int
    widths: tuple  # per-layer row width
    efc: int
    M: int
    metric: str
    expand: int
    max_obs: int  # entry level at round start
    nonempty: tuple  # per-layer: did the layer contain points at round start
    keep_pruned: bool
    extend: bool = False  # reference extend_candidates (src/hnsw.rs:1317-1362)
    # upper-layer work runs on the first B1 rows (the round is sorted by level
    # descending, so level >= 1 points form a small prefix); 0 skips it
    B1: int = 0
    max_iters: Optional[int] = None  # construction-beam iteration cap
    # layer-0 in-degree guarantee: each new point's min_indeg nearest backlinks
    # are protected from truncation, and an existing entry whose target has
    # <= min_indeg in-links is protected from eviction
    min_indeg: int = 2


# ----------------------------------------------------------- neighbour selection -----

# elements of one [rows, K, d] block of the generic pairwise form
_PAIRWISE_ELEMS = 1 << 27


def _pairwise_dists(metric: str, cvecs, csq):
    """[B,K,d] -> [B,K,K] candidate-candidate distances for the diversity prune.
    The inner-product metrics take one batched matmul; the others score each
    candidate against its query's K candidates through ``scores_gathered``,
    in blocks of whole (query, candidate) rows sized to ``_PAIRWISE_ELEMS``."""
    if metric in ("L2", "DistL2"):
        g = torch.einsum("bkd,bjd->bkj", cvecs, cvecs)
        return torch.sqrt(torch.clamp_min(csq[:, :, None] - 2.0 * g + csq[:, None, :], 0.0))
    if metric in ("Dot", "DistDot"):
        return 1.0 - torch.einsum("bkd,bjd->bkj", cvecs, cvecs)
    if metric in ("Cosine", "DistCosine"):
        nrm = torch.sqrt(torch.clamp_min(csq, 1e-20))
        u = cvecs / nrm[:, :, None]
        return 1.0 - torch.einsum("bkd,bjd->bkj", u, u)
    B, K, d = cvecs.shape
    rows = cvecs.reshape(B * K, d)
    step = max(1, _PAIRWISE_ELEMS // max(1, K * d))
    out = torch.empty((B * K, K), dtype=torch.float32, device=cvecs.device)
    for s in range(0, B * K, step):
        e = min(s + step, B * K)
        owner = torch.arange(s, e, device=cvecs.device) // K  # query of each row
        out[s:e] = scores_gathered(metric, rows[s:e], cvecs[owner])
    return out.reshape(B, K, K)


def select_neighbours_batched(metric: str, vectors, sqnorms, cand_ids, cand_d,
                              nb_conn: int, keep_pruned: bool, k_sel: Optional[int] = None):
    """Vectorized heuristic (reference ``select_neighbours``): walk candidates
    nearest-first, keep e only if no kept d has dist(e,d) <= dist(e,q);
    optionally refill from the pruned. Candidates beyond ``k_sel`` are never
    kept. Returns ([B,nb_conn] ids -1 padded, dists) ascending."""
    B, C = cand_ids.shape
    dev = cand_ids.device
    K = min(C, k_sel if k_sel is not None else max(2 * nb_conn, 128))
    ids = cand_ids[:, :K]
    dd = cand_d[:, :K]
    valid = ids >= 0
    cap1 = vectors.shape[0]
    safe = torch.clamp(ids, 0, cap1 - 1).long()
    cvecs = vectors[safe].to(torch.float32)
    csq = sqnorms[safe]
    P = _pairwise_dists(metric, cvecs, csq)
    n_valid = (cand_ids >= 0).sum(1)
    keep_all = n_valid <= nb_conn  # reference short-circuit (src/hnsw.rs:1318-1331)
    kept = torch.zeros((B, K), dtype=torch.bool, device=dev)
    count = torch.zeros((B,), dtype=torch.int32, device=dev)
    for k in range(K):
        conflict = (kept & (P[:, k, :] <= dd[:, k, None])).any(-1)
        take = valid[:, k] & (count < nb_conn) & ~conflict
        kept[:, k] = take
        count += take.to(torch.int32)
    if keep_pruned:
        disc = valid & ~kept
        room = (nb_conn - count)[:, None]
        refill = disc & (torch.cumsum(disc.to(torch.int32), dim=1) <= room)
        kept = kept | refill
    kept = torch.where(keep_all[:, None], valid, kept)
    # compact, preserving ascending-distance order
    posn = torch.where(kept, torch.arange(K, device=dev)[None, :], K + 1)
    order = torch.sort(posn, dim=1, stable=True).indices[:, :nb_conn]
    okay = torch.gather(kept, 1, order)
    sel_ids = torch.where(okay, torch.gather(ids, 1, order), -1)
    sel_d = torch.where(okay, torch.gather(dd, 1, order), INF)
    return sel_ids, sel_d


def extend_candidates_batched(metric: str, vectors, sqnorms, tbl0, q, cand_ids,
                              cand_d, nb_conn: int, act, k_out: int):
    """Layer-0 candidate-pool widening (reference ``src/hnsw.rs:1317-1362``):
    a point whose beam returned <= ``nb_conn`` candidates adds the layer-0
    neighbours of those candidates, scored against the query, deduped by id.
    Rounds where no point triggers pass the candidates through.
    Returns ([B, k_out] ids -1-padded, dists) ascending."""
    B, C = cand_ids.shape
    cap1, M0 = tbl0.shape
    dev = cand_ids.device
    W = min(C, nb_conn)
    P = W * M0
    n_valid = (cand_ids >= 0).sum(1)
    need = act & (n_valid <= nb_conn)
    if not bool(need.any()):
        k = min(k_out, C)
        ids = cand_ids[:, :k]
        dd = cand_d[:, :k]
        if k < k_out:
            ids = torch.cat([ids, torch.full((B, k_out - k), -1, dtype=torch.int32, device=dev)], 1)
            dd = torch.cat([dd, torch.full((B, k_out - k), INF, device=dev)], 1)
        return ids, dd
    src = cand_ids[:, :W]
    nb = tbl0[torch.clamp(src, 0, cap1 - 1).long()].reshape(B, P)
    ok = need[:, None] & (src >= 0).repeat_interleave(M0, dim=1) & (nb >= 0)
    chunk = max(M0, min(P, (1 << 21) // max(1, q.shape[1])))
    scs = []
    for s in range(0, P, chunk):
        blk = torch.where(ok[:, s:s + chunk], nb[:, s:s + chunk], cap1 - 1).long()
        scs.append(scores_gathered(metric, q, vectors[blk], sqnorms[blk]))
    sc = torch.where(ok, torch.cat(scs, dim=1), INF)
    m_ids = torch.cat([torch.where(cand_ids >= 0, cand_ids, cap1),
                       torch.where(ok, nb, cap1)], dim=1)
    m_d = torch.cat([cand_d, sc], dim=1)
    # dedup by id adjacency: stable sort by distance bits, then by id
    dbits = torch.where(m_ids < cap1, m_d, INF).contiguous().view(torch.int32)
    o0 = torch.sort(dbits, dim=1, stable=True).indices
    i0 = torch.gather(m_ids, 1, o0)
    d0 = torch.gather(m_d, 1, o0)
    o1 = torch.sort(torch.where(i0 < cap1, i0, cap1), dim=1, stable=True).indices
    i1 = torch.gather(i0, 1, o1)
    d1 = torch.gather(d0, 1, o1)
    dup = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                     i1[:, 1:] == i1[:, :-1]], 1)
    live = (i1 < cap1) & ~dup
    v, o3 = smallest(torch.where(live, d1, INF), k_out)
    out_ids = torch.gather(torch.where(live, i1, -1), 1, o3)
    return torch.where(v < INF, out_ids, -1), v


# ------------------------------------------------------------- reverse-link merge ----

def _reverse_merge(tbl_ids, tbl_d, eq, esrc, ed, valid, width: int,
                   indeg=None, eprot=None, min_indeg: int = 2):
    """Merge backlink edges (target q <- source src at dist d) into the
    target rows of one layer table, in place. Lossless: top-width of
    (existing ∪ incoming) equals the reference's sequential add+prune fold.
    With ``indeg``/``eprot`` (layer 0) the in-degree guarantee of
    ``RoundConfig.min_indeg`` applies. Returns (ids, dists) — plus the
    updated ``indeg`` when one was given."""
    E = eq.shape[0]
    cap1 = tbl_ids.shape[0]
    sink = cap1 - 1
    dev = eq.device
    protecting = indeg is not None
    qv = eq.to(torch.int32)
    sv = esrc.to(torch.int32)
    pr = (eprot if eprot is not None else torch.zeros((E,), dtype=torch.bool, device=dev)) & valid

    def ssort(key):
        return torch.sort(key, stable=True).indices

    # 1. dedup (q, src) — reference's `already` check (src/hnsw.rs:1258-1267)
    p_a = ssort(torch.where(valid, sv, cap1))
    q_a, s_a, d_a, v_a, pr_a = qv[p_a], sv[p_a], ed[p_a], valid[p_a], pr[p_a]
    p_b = ssort(torch.where(v_a, q_a, cap1))
    q_b, s_b, d_b, v_b, pr_b = q_a[p_b], s_a[p_b], d_a[p_b], v_a[p_b], pr_a[p_b]
    f = torch.zeros((1,), dtype=torch.bool, device=dev)
    dup = torch.cat([f, (q_b[1:] == q_b[:-1]) & (s_b[1:] == s_b[:-1])])
    v2 = v_b & ~dup
    # 2. group by target, ascending distance (protected edges first)
    dbits = torch.where(v2, d_b, INF).to(torch.float32).contiguous().view(torch.int32)
    dkey = (dbits >> 1) - (1 << 30) * (pr_b & v2).to(torch.int32)
    p_c = ssort(dkey)
    q_c, s_c, d_c, v_c, pr_c = q_b[p_c], s_b[p_c], d_b[p_c], v2[p_c], pr_b[p_c]
    p_d = ssort(torch.where(v_c, q_c, cap1))
    q3, s3, d3, v3, pr3 = q_c[p_d], s_c[p_d], d_c[p_d], v_c[p_d], pr_c[p_d]
    idx = torch.arange(E, device=dev)
    newq = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), q3[1:] != q3[:-1]])
    first = v3 & newq
    slot = torch.cumsum(first.to(torch.int64), 0) - 1
    seg_start = torch.cummax(torch.where(first, idx, -1), 0).values
    rank = idx - seg_start
    keep = v3 & (rank < width)
    # 3. dense incoming table [E+1, width] (row E is the spill for dropped edges)
    r_slot = torch.where(keep, slot, E)
    r_rank = torch.where(keep, torch.clamp(rank, 0, width - 1), 0)
    inc_ids = torch.full((E + 1, width), -1, dtype=torch.int32, device=dev)
    inc_ids[r_slot, r_rank] = torch.where(keep, s3, -1)
    inc_d = torch.full((E + 1, width), INF, dtype=torch.float32, device=dev)
    inc_d[r_slot, r_rank] = torch.where(keep, d3, INF).to(torch.float32)
    tq = torch.full((E + 1,), sink, dtype=torch.int64, device=dev)
    tq[torch.where(first, slot, E)] = torch.where(first, q3, sink).to(torch.int64)
    # 4. merge with existing rows: sort by (protection, distance), truncate,
    # re-sort survivors by distance
    ex_ids = tbl_ids[tq]
    ex_d = torch.where(ex_ids < 0, INF, tbl_d[tq])
    m_ids = torch.cat([ex_ids, inc_ids], dim=1)
    m_d = torch.cat([ex_d, inc_d], dim=1)
    if protecting:
        inc_prot = torch.zeros((E + 1, width), dtype=torch.bool, device=dev)
        inc_prot[r_slot, r_rank] = keep & pr3
        ex_prot = (ex_ids >= 0) & (indeg[torch.clamp(ex_ids, 0, cap1 - 1).long()] <= min_indeg)
        m_unprot = 1 - torch.cat([ex_prot, inc_prot], dim=1).to(torch.int32)
        o = torch.sort(m_d, dim=1, stable=True).indices  # minor key first
        o = torch.gather(o, 1, torch.sort(torch.gather(m_unprot, 1, o), dim=1,
                                          stable=True).indices)
        m_ids = torch.gather(m_ids, 1, o)[:, :width]
        m_d = torch.gather(m_d, 1, o)[:, :width]
        o = torch.sort(m_d, dim=1, stable=True).indices
    else:
        o = torch.sort(m_d, dim=1, stable=True).indices[:, :width]
    m_ids = torch.gather(m_ids, 1, o)
    m_d = torch.gather(m_d, 1, o)
    m_ids = torch.where(torch.isfinite(m_d), m_ids, -1)
    tbl_ids[tq] = m_ids
    tbl_d[tq] = m_d
    if not protecting:
        return tbl_ids, tbl_d
    # layer-0 in-degree: -1 per surviving BEFORE entry, +1 per AFTER entry, on
    # real (non-spill) rows only
    live = (tq != sink)[:, None]
    _add_counts(indeg, ex_ids, live & (ex_ids >= 0), -1)
    _add_counts(indeg, m_ids, live & (m_ids >= 0), 1)
    return tbl_ids, tbl_d, indeg


def _add_counts(counts, idx, take, value: int):
    """counts[idx[take]] += value, in place (the ``.at[].add`` of the JAX
    package). Only the taken entries are scattered: clamping the others onto
    one row, as the JAX form does, makes an accumulating ``index_put_`` walk
    that run of duplicates serially (11.9 s of a 24.9 s round of the 200k
    build on an H100)."""
    sel = idx[take].long()
    counts.index_add_(0, sel, torch.full(sel.shape, value, dtype=counts.dtype,
                                         device=counts.device))


# ------------------------------------------------------------------- round step ------

def round_step(vectors, sqnorms, levels, tables, batch_ids, entry,
               vectors_lo=None, indeg0=None, *, cfg: RoundConfig):
    """One synchronized insertion round. ``tables`` is a sequence of (ids,
    dists) per layer, updated in place and returned. With ``indeg0`` (a
    [cap1] int32 layer-0 in-degree array, also updated in place) the layer-0
    merge protects in-degree and the return value is ``(tables, indeg0)``.

    ``vectors_lo``: optional bf16 copy used only for traversal scoring; the
    candidates are re-scored in f32 before the neighbour selection."""
    metric = cfg.metric
    cap1 = cfg.cap1
    sink = cap1 - 1
    L = cfg.num_layers
    dev = vectors.device
    ids_t = [t[0] for t in tables]
    d_t = [t[1] for t in tables]
    vtrav = vectors_lo if vectors_lo is not None else vectors
    batch_ids = batch_ids.to(device=dev, dtype=torch.int32)
    bl = batch_ids.long()
    q = vectors[bl]

    def rescore_exact(qv, cand_ids, cand_d):
        if vectors_lo is None:
            return cand_ids, cand_d
        safe = torch.clamp(cand_ids, 0, cap1 - 1).long()
        sc = scores_gathered(metric, qv, vectors[safe], sqnorms[safe])
        sc = torch.where(cand_ids >= 0, sc, INF)
        sd, o = torch.sort(sc, dim=1, stable=True)
        return torch.gather(cand_ids, 1, o), sd

    lv = levels[bl]
    alive = lv >= 0
    B = cfg.B
    d0 = scores_gathered(metric, q, vectors[entry][None, None, :].expand(B, 1, q.shape[1]),
                         sqnorms[entry].reshape(1, 1).expand(B, 1))[:, 0]
    pivot = torch.full((B,), int(entry), dtype=torch.int32, device=dev)

    # 1. upper-layer ef=1 descent with projection recording
    recs = []

    def rec_hook(layer, p, dd, act):
        recs.append((layer, p, dd, act))

    empty = torch.full((cap1, 1), -1, dtype=torch.int32, device=dev)
    desc_tables = [ids_t[l] if (l < L and cfg.nonempty[l]) else empty for l in range(L)]
    pivot, d0, _ = greedy_min_descent(metric, vtrav, sqnorms, desc_tables, q, pivot, d0,
                                      top_layer=cfg.max_obs, stop_level=lv,
                                      record_hook=rec_hook)
    for (layer, p, dd, act) in recs:
        if layer >= L or not cfg.nonempty[layer]:
            continue
        a = act & alive
        tgt = torch.where(a, batch_ids, sink).long()
        ids_t[layer][tgt, 0] = torch.where(a, p, -1)
        d_t[layer][tgt, 0] = torch.where(a, dd, INF)

    # 2-4. construction, layers high..0: upper layers on the B1 prefix
    B1 = cfg.B1
    sel_upper = [None] * L
    for l in range(L - 1, 0, -1):
        if not cfg.nonempty[l] or B1 == 0:
            continue
        act_l = alive[:B1] & (lv[:B1] >= l)
        cand_ids, cand_d = beam_search_layer(metric, vtrav, sqnorms, ids_t[l],
                                             q[:B1], pivot[:B1], d0[:B1],
                                             ef=cfg.efc, expand=cfg.expand,
                                             active=act_l, max_iters=cfg.max_iters)
        cand_ids, cand_d = rescore_exact(q[:B1], cand_ids, cand_d)
        nb_conn = cfg.widths[l]
        sel_ids, sel_d = select_neighbours_batched(metric, vectors, sqnorms, cand_ids,
                                                   cand_d, nb_conn, cfg.keep_pruned)
        tgt = torch.where(act_l, batch_ids[:B1], sink).long()
        ids_t[l][tgt] = torch.where(act_l[:, None], sel_ids, -1)
        d_t[l][tgt] = torch.where(act_l[:, None], sel_d, INF)
        sel_upper[l] = (sel_ids, sel_d, act_l)
        has = act_l & torch.isfinite(sel_d[:, 0])
        pivot = torch.cat([torch.where(has, sel_ids[:, 0], pivot[:B1]), pivot[B1:]])
        d0 = torch.cat([torch.where(has, sel_d[:, 0], d0[:B1]), d0[B1:]])
    sel0 = None
    if cfg.nonempty[0]:
        act0 = alive
        cand_ids, cand_d = beam_search_layer(metric, vtrav, sqnorms, ids_t[0], q,
                                             pivot, d0, ef=cfg.efc, expand=cfg.expand,
                                             active=act0, max_iters=cfg.max_iters)
        cand_ids, cand_d = rescore_exact(q, cand_ids, cand_d)
        nb_conn = cfg.widths[0]
        if cfg.extend:
            k_win = min(cand_ids.shape[1], max(2 * nb_conn, 128))
            cand_ids, cand_d = extend_candidates_batched(
                metric, vectors, sqnorms, ids_t[0], q, cand_ids, cand_d, nb_conn,
                act0, k_out=k_win)
        sel_ids, sel_d = select_neighbours_batched(metric, vectors, sqnorms, cand_ids,
                                                   cand_d, nb_conn, cfg.keep_pruned)
        tgt = torch.where(act0, batch_ids, sink).long()
        ids_t[0][tgt] = torch.where(act0[:, None], sel_ids, -1)
        d_t[0][tgt] = torch.where(act0[:, None], sel_d, INF)
        sel0 = (sel_ids, sel_d, act0)
        if indeg0 is not None:
            _add_counts(indeg0, sel_ids, act0[:, None] & (sel_ids >= 0), 1)

    # 5. reverse-link merge, grouped by target layer l_n = new point's level
    if sel0 is not None:
        sids, sd, act0 = sel0
        ev0 = (sids >= 0) & act0[:, None] & (lv == 0)[:, None]
        eq0 = sids.reshape(-1)
        ed0 = sd.reshape(-1)
        es0 = batch_ids[:, None].expand(sids.shape).reshape(-1)
        v0 = ev0.reshape(-1) & (eq0 != es0)
        if indeg0 is None:
            _reverse_merge(ids_t[0], d_t[0], eq0, es0, ed0, v0, cfg.widths[0])
        else:
            ep0 = (torch.arange(sids.shape[1], device=dev)[None, :] < cfg.min_indeg
                   ).expand(sids.shape).reshape(-1)
            _reverse_merge(ids_t[0], d_t[0], eq0, es0, ed0, v0, cfg.widths[0],
                           indeg=indeg0, eprot=ep0, min_indeg=cfg.min_indeg)
    if B1 > 0:
        parts = []
        if sel0 is not None:
            sids, sd, _ = sel0
            parts.append((sids[:B1], sd[:B1]))
        for l in range(1, L):
            if sel_upper[l] is not None:
                parts.append((sel_upper[l][0], sel_upper[l][1]))
        if parts:
            eq = torch.cat([p[0] for p in parts], dim=1)
            edd = torch.cat([p[1] for p in parts], dim=1)
            esrc = batch_ids[:B1, None].expand(eq.shape)
            elv = lv[:B1, None].expand(eq.shape)
            eq, edd, esrc, elv = (x.reshape(-1) for x in (eq, edd, esrc, elv))
            ev = (eq >= 0) & (eq != esrc)
            for l_n in range(1, L):
                v_ln = ev & (elv == l_n)
                _reverse_merge(ids_t[l_n], d_t[l_n], eq, esrc, edd, v_ln, cfg.widths[l_n])
    out = tuple(zip(ids_t, d_t))
    return out if indeg0 is None else (out, indeg0)


# ------------------------------------------------------------------ host loop --------

class HostBuildState:
    """Host-side bookkeeping for one index's device build: allocates the new
    points' host rows, materializes the device-state arrays, schedules rounds
    and flushes the device tables back into the ``Hnsw`` (numpy; identical to
    the JAX package's)."""

    def __init__(self, hnsw, pairs, L: Optional[int] = None,
                 widths: Optional[tuple] = None, cap1: Optional[int] = None):
        self.hnsw = hnsw
        n0 = hnsw._nb_point
        is_arrays = (isinstance(pairs, tuple) and len(pairs) == 2
                     and hasattr(pairs[0], "ndim"))
        npts = len(pairs[0]) if is_arrays else len(pairs)
        new_levels = hnsw.level_sampler.generate(npts)
        # shuffle the processing order (external ids keep their identity):
        # round-mates are invisible to each other, so geometry-correlated
        # ingestion would starve whole clusters of intra-cluster links
        if npts > 1:
            p = np.random.default_rng(0xB10C ^ npts ^ n0).permutation(npts)
            pairs = ((pairs[0][p], np.asarray(pairs[1])[p]) if is_arrays
                     else [pairs[j] for j in p])
        if is_arrays:
            X, oids = pairs
            if npts:
                hnsw._set_dim(X.shape[1])
            hnsw._ensure_cap(n0 + npts)
            hnsw._data[n0:n0 + npts] = X
            hnsw._origin[n0:n0 + npts] = oids
            hnsw._level[n0:n0 + npts] = new_levels
            for lvl in np.unique(new_levels):
                m = new_levels == lvl
                base = hnsw._layer_npoints[lvl]
                hnsw._rank_in_layer[n0:n0 + npts][m] = base + np.arange(m.sum())
                hnsw._layer_npoints[lvl] = base + int(m.sum())
        else:
            if pairs:
                hnsw._set_dim(len(pairs[0][0]))
            hnsw._ensure_cap(n0 + npts)
            for k, ((v, oid), lvl) in enumerate(zip(pairs, new_levels)):
                i = n0 + k
                hnsw._data[i] = np.asarray(v, dtype=hnsw.dtype)
                hnsw._origin[i] = oid
                hnsw._level[i] = lvl
                hnsw._rank_in_layer[i] = hnsw._layer_npoints[lvl]
                hnsw._layer_npoints[lvl] += 1
        self.n0 = n0
        self.n_total = n0 + npts
        self.L = L if L is not None else (
            max(max(hnsw._layers.keys(), default=0), int(new_levels.max(initial=0)),
                int(hnsw._level[:n0].max(initial=0))) + 1)
        self.widths = widths if widths is not None else tuple(
            max(hnsw._layer_width(l),
                hnsw._layers[l].width if l in hnsw._layers else 0)
            for l in range(self.L))
        self.cap1 = cap1 if cap1 is not None else ((self.n_total + 7) // 8) * 8 + 1
        self.counts = np.array([int((hnsw._level[:n0] == l).sum())
                                for l in range(self.L)], np.int64)
        self.entry = hnsw._entry
        self.entry_level = int(hnsw._level[self.entry]) if self.entry >= 0 else 0
        self.cursor = n0

    def vec_np(self) -> np.ndarray:
        h = self.hnsw
        vec = np.zeros((self.cap1, h._dim), np.float32)
        vec[: self.n_total] = h._data[: self.n_total].astype(np.float32)
        return vec

    def levels_np(self) -> np.ndarray:
        lv = np.full(self.cap1, -1, np.int32)
        lv[: self.n_total] = self.hnsw._level[: self.n_total]
        return lv

    def indeg0_np(self) -> np.ndarray:
        """Layer-0 in-degree of the pre-existing graph (fresh builds: zeros)."""
        ind = np.zeros(self.cap1, np.int32)
        t = self.hnsw._layers.get(0)
        if t is not None and self.n0:
            v = t.ids[: self.n0]
            v = v[v >= 0]
            if len(v):
                bc = np.bincount(v, minlength=self.cap1)[: self.cap1]
                ind[: len(bc)] = bc
        return ind

    def tables_np(self) -> list:
        h = self.hnsw
        out = []
        for l in range(self.L):
            ids = np.full((self.cap1, self.widths[l]), -1, np.int32)
            dd = np.full((self.cap1, self.widths[l]), np.inf, np.float32)
            t = h._layers.get(l)
            if t is not None:
                ids[: self.n0, : t.width] = t.ids[: self.n0]
                dd[: self.n0, : t.width] = t.dists[: self.n0]
            out.append((ids, dd))
        return out

    @property
    def remaining(self) -> int:
        return self.n_total - self.cursor

    def ramp(self, B: int) -> int:
        """Cold-start ramp: a round may not exceed the points already in the
        graph (8, 16, ... B)."""
        return int(min(B, _next_pow2(max(8, self.cursor))))

    def round_batch(self, Br: int):
        """Take up to ``Br`` points for the next round: (bidx [Br] int32
        sink-padded, sorted level-descending; n_hi)."""
        h = self.hnsw
        s = self.cursor
        e = min(s + Br, self.n_total)
        bidx = np.full(Br, self.cap1 - 1, np.int32)
        round_levels = h._level[s:e]
        order = np.argsort(-round_levels, kind="stable")
        bidx[: e - s] = np.arange(s, e, dtype=np.int32)[order]
        n_hi = int((round_levels >= 1).sum())
        if e > s:
            self.counts[:] += np.bincount(round_levels, minlength=self.L)[: self.L]
            mx = int(round_levels.max(initial=-1))
            if mx > self.entry_level:  # entry promotion (reference check_entry_point)
                self.entry = int(s + int(np.argmax(round_levels == mx)))
                self.entry_level = mx
        self.cursor = e
        return bidx, n_hi

    def flush(self, tables_np):
        """Write the device tables (numpy (ids, dists) per layer) back."""
        h = self.hnsw
        n_total = self.n_total
        for l in range(self.L):
            t = h._layer_table(l)
            ids = np.asarray(tables_np[l][0][:n_total])
            dd = np.asarray(tables_np[l][1][:n_total])
            if ids.shape[1] > t.width and (ids[:, t.width:] >= 0).any():
                t.grow_width(ids.shape[1])
            t.ids[:n_total] = ids[:, : t.width]
            t.dists[:n_total] = dd[:, : t.width]
            t.counts[:n_total] = (ids[:, : t.width] >= 0).sum(1)
        h._nb_point = n_total
        h._entry = self.entry
        h._version += 1


def device_parallel_insert(hnsw, pairs, batch_size: Optional[int] = None,
                           expand: int = 8, build_max_iters: Optional[int] = None):
    """Build/extend an index with synchronized rounds on ``hnsw.device``.
    ``pairs`` is a list of ``(vector, id)`` tuples or an ``(X, ids)`` pair."""
    if isinstance(pairs, tuple) and len(pairs) == 2 and hasattr(pairs[0], "ndim"):
        X, ids = pairs
        if len(X) == 0:
            return
        if hnsw._nb_point == 0:
            hnsw.insert(X[0], int(ids[0]))  # seed entry point
            X, ids = X[1:], ids[1:]
            if len(X) == 0:
                return
        pairs = (X, ids)
    elif not pairs:
        return
    elif hnsw._nb_point == 0:
        v, i = pairs[0]
        hnsw.insert(v, i)
        pairs = pairs[1:]
        if not pairs:
            return
    from ..utils.logging import init_logging
    from ..utils.profiling import PROFILER

    dev = hnsw.device
    st = HostBuildState(hnsw, pairs)
    vectors = torch.as_tensor(st.vec_np(), device=dev)
    sqnorms = (vectors * vectors).sum(-1)
    levels_t = torch.as_tensor(st.levels_np(), device=dev)
    tables = [(torch.as_tensor(i, device=dev), torch.as_tensor(d, device=dev))
              for i, d in st.tables_np()]
    B = int(batch_size) if batch_size else int(min(4096, max(64, st.remaining)))
    if hnsw.extend_candidates:
        # the widen pass scores [B*(2M)^2, d] f32 neighbours-of-candidates;
        # cap the round so that operand stays ~6 GB
        d_ = hnsw._dim or 1
        cap = max(256, int(6e9 / ((2 * hnsw.max_nb_connection) ** 2 * d_ * 4)))
        if B > cap:
            init_logging().warning(
                "extend_candidates: capping build batch %d -> %d (widen-pass "
                "memory bound)", B, cap)
            B = cap
    metric = hnsw.metric.name
    # bf16 traversal copy at production scale (inner-product metrics);
    # HNSW_BUILD_LO=0/1 overrides
    lo_env = os.environ.get("HNSW_BUILD_LO")
    use_lo = (metric in ("L2", "DistL2", "Dot", "DistDot", "Cosine", "DistCosine")
              and st.n_total >= 32768) if lo_env is None else lo_env == "1"
    vectors_lo = vectors.to(torch.bfloat16) if use_lo else None
    protect = os.environ.get("HNSW_BUILD_PROTECT", "1") != "0"
    indeg0 = torch.as_tensor(st.indeg0_np(), device=dev) if protect else None
    min_indeg = int(os.environ.get("HNSW_MIN_INDEG", 2))
    PROFILER.add("build.points", st.remaining)
    while st.remaining:
        Br = st.ramp(B)
        max_obs, nonempty = st.entry_level, tuple(bool(c > 0) for c in st.counts)
        entry = st.entry
        bidx, n_hi = st.round_batch(Br)
        B1 = 0 if n_hi == 0 else int(min(Br, _next_pow2(max(8, n_hi))))
        cfg = RoundConfig(B=Br, cap1=st.cap1, num_layers=st.L, widths=st.widths,
                          efc=hnsw.ef_construction, M=hnsw.max_nb_connection,
                          metric=metric, expand=int(expand), max_obs=max_obs,
                          nonempty=nonempty,
                          keep_pruned=bool(hnsw.keep_pruned),
                          extend=bool(hnsw.extend_candidates), B1=B1,
                          max_iters=build_max_iters, min_indeg=min_indeg)
        with PROFILER.span("build.round"):
            out = round_step(vectors, sqnorms, levels_t, tables,
                             torch.as_tensor(bidx, device=dev), entry,
                             vectors_lo, indeg0, cfg=cfg)
            tables, indeg0 = out if protect else (out, None)
        if st.cursor % 50_000 < Br:  # reference prints every 50k (src/hnsw.rs:524-526)
            init_logging().info("device insert: %d points indexed", st.cursor)
    with PROFILER.span("build.flush"):
        st.flush([(i.cpu().numpy(), d.cpu().numpy()) for i, d in tables])
    if getattr(hnsw, "_auto_repair", True):
        import time as _time
        _t0 = _time.time()
        with PROFILER.span("build.repair"):
            repaired = hnsw.ensure_navigable()
        hnsw._repair_stats = {"repairs": int(repaired),
                              "seconds": round(_time.time() - _t0, 2),
                              "layer0_width": int(hnsw._layers[0].width)
                              if 0 in hnsw._layers else 0,
                              "incomplete": int(getattr(hnsw, "_repair_incomplete", 0))}
        if repaired:
            init_logging().info("navigability repair: %d links added in %.1fs",
                                repaired, hnsw._repair_stats["seconds"])
