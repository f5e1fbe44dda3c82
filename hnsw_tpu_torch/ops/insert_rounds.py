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
ops. A round is a sequence of parts (``round_plan``: the head, each upper
layer's descent, each layer's construction, the two merges), each a
``RoundPart`` whose loop, if it has one, is a sequence of steps after which
a device flag says that a further step changes nothing. ``round_step`` runs
them eagerly (one host read per beam iteration and per descent hop, the
reference's ``while_loop`` tests); ``ops/program.py::BuildPrograms`` captures
the same parts as device programs, which write the same tables bit for bit.
Translation notes:

  * ``lax.sort`` with ``num_keys=2`` is two chained stable sorts (minor key
    first); ``jnp.argsort`` (stable) is ``torch.sort(stable=True)``;
    ``lax.top_k`` is a stable ascending sort (ties to the lower index).
  * ``.at[].set`` with repeated indices only ever repeats the sink row, whose
    contents no search reads; ``.at[].add`` is an ``index_add_`` of
    ``value * take`` at a fixed shape (``_add_counts``).
  * ``bitcast_convert_type`` is ``Tensor.view(torch.int32)``; ``lax.cummax``
    is ``torch.cummax``; ``lax.cond`` a host read of ``need.any()`` that picks
    the widen pass or its pass-through.
  * The layer tables are updated in place (the JAX program donates them).
  * The entry point is a one-element tensor in the round's state, as the
    reference passes ``jnp.int32(entry)`` traced, so a promotion between
    rounds of one key changes no program.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..utils.profiling import PROFILER
from .beam_search import (MAX_HOPS, BeamState, DescentState, beam_finish, beam_iters,
                          beam_run, beam_setup, beam_step, descent_hop, descent_layer,
                          scores_gathered, smallest)

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


def extend_need(cand_ids, act, nb_conn: int):
    """[B] bool: the points whose candidate pool the widen pass grows. The
    round reads ``need.any()`` on the host and runs ``extend_widen`` or
    ``extend_keep`` (the reference's ``lax.cond``)."""
    return act & ((cand_ids >= 0).sum(1) <= nb_conn)


def extend_keep(cand_ids, cand_d, k_out: int):
    """The widen pass's other branch: the candidates, cut or -1/inf-padded to
    ``k_out``."""
    B, C = cand_ids.shape
    dev = cand_ids.device
    k = min(k_out, C)
    ids = cand_ids[:, :k]
    dd = cand_d[:, :k]
    if k < k_out:
        ids = torch.cat([ids, torch.full((B, k_out - k), -1, dtype=torch.int32, device=dev)], 1)
        dd = torch.cat([dd, torch.full((B, k_out - k), INF, device=dev)], 1)
    return ids, dd


def extend_widen(metric: str, vectors, sqnorms, tbl0, q, cand_ids, cand_d,
                 nb_conn: int, need, k_out: int):
    """Layer-0 candidate-pool widening (reference ``src/hnsw.rs:1317-1362``)
    for the points in ``need``: a point whose beam returned <= ``nb_conn``
    candidates adds the layer-0 neighbours of those candidates, scored
    against the query, deduped by id. Returns ([B, k_out] ids -1-padded,
    dists) ascending."""
    B, C = cand_ids.shape
    cap1, M0 = tbl0.shape
    dev = cand_ids.device
    W = min(C, nb_conn)
    P = W * M0
    src = cand_ids[:, :W]
    nb = tbl0[torch.clamp(src, 0, cap1 - 1).long()].reshape(B, P)
    # an expand, not repeat_interleave, which may read its output size
    # back to the host (a captured piece must not)
    ok = need[:, None] & (src >= 0)[:, :, None].expand(B, W, M0).reshape(B, P) & (nb >= 0)
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
    package), at a fixed shape and with no host read, so a captured round
    can run it: every entry adds ``value * take``, an untaken one 0 to a row
    of its own (entry i to row i mod len(counts)). Clamping the untaken
    entries onto one row, as the JAX form does, makes an accumulating
    ``index_put_`` walk that run of duplicates serially (11.9 s of a 24.9 s
    round of the 200k build on an H100). Integer adds are exact in any
    order."""
    flat = idx.reshape(-1).long()
    tk = take.reshape(-1)
    spread = torch.arange(flat.numel(), device=flat.device) % counts.shape[0]
    counts.index_add_(0, torch.where(tk, flat, spread), tk.to(counts.dtype) * value)


# ------------------------------------------------------------------- round step ------

class BuildTensors:
    """What every round of one build reads and writes: the vectors, their
    squared norms, the levels, each layer's (ids, dists) table and the
    layer-0 in-degree (updated in place), the bf16 traversal copy, and a
    table of no links for layers the descent passes through empty."""

    def __init__(self, vectors, sqnorms, levels, tables, vectors_lo=None, indeg0=None):
        self.vectors, self.sqnorms, self.levels = vectors, sqnorms, levels
        self.ids = [t[0] for t in tables]
        self.dists = [t[1] for t in tables]
        self.vectors_lo, self.indeg0 = vectors_lo, indeg0
        self.vtrav = vectors_lo if vectors_lo is not None else vectors
        self.cap1 = int(vectors.shape[0])
        self._empty = None

    def empty(self):
        if self._empty is None:
            self._empty = torch.full((self.cap1, 1), -1, dtype=torch.int32,
                                     device=self.vectors.device)
        return self._empty

    def held(self) -> tuple:
        """The identity of every tensor a round reads or writes (a captured
        round holds raw pointers to them)."""
        return tuple(id(t) for t in (self.vectors, self.sqnorms, self.levels,
                                     self.vectors_lo, self.indeg0, *self.ids, *self.dists))

    def tables(self) -> tuple:
        return tuple(zip(self.ids, self.dists))


class RoundState:
    """One round's tensors between its parts, for a batch of ``B``: the
    static inputs (``batch_ids``, ``entry``), what the head derives (queries,
    levels, liveness, the pivots and their distances) and each layer's
    selection, which the merges read. A part reads and writes them in place,
    so captured parts of different keys meet in the same buffers."""

    def __init__(self, B: int, d: int, device):
        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)
        self.B = int(B)
        self.batch_ids, self.entry = z(B), z(1)
        self.q, self.d0 = z(B, d, dtype=torch.float32), z(B, dtype=torch.float32)
        self.lv, self.pivot, self.alive = z(B), z(B), z(B, dtype=torch.bool)
        self._sel = {}

    def start(self, batch_ids, entry):
        """Copy a round's batch (its point ids, sink-padded) and entry point in."""
        self.batch_ids.copy_(torch.as_tensor(batch_ids, dtype=torch.int32))
        if torch.is_tensor(entry):
            self.entry.copy_(entry.reshape(1))
        else:
            self.entry.fill_(int(entry))

    def selection(self, layer: int, rows: int, width: int):
        """(ids, dists) of layer ``layer``'s selection for the first ``rows``
        points (the buffers the construction writes and the merges read)."""
        key = (layer, rows, width)
        if key not in self._sel:
            dev = self.q.device
            self._sel[key] = (torch.full((rows, width), -1, dtype=torch.int32, device=dev),
                              torch.full((rows, width), INF, device=dev))
        return self._sel[key]


class RoundPart:
    """One part of a round. ``begin``, then up to ``iters`` loop steps
    (``step(it)``; ``finished()`` is a device flag after which a step changes
    nothing), then ``end``; a part without a loop does all in ``begin``. With
    ``branches``, ``need`` (a device flag set by ``end``) picks ``widen`` or
    ``keep``, then ``after`` runs. ``loop`` is the eager loop, with its own
    host reads. ``ops/program.py`` captures the same methods as the round's
    device program."""

    iters = 0
    branches = False

    def begin(self):
        raise NotImplementedError

    def step(self, it: int):
        raise NotImplementedError

    def carry(self):
        """Put a loop's state back into the buffers ``begin`` made."""

    def finished(self):
        raise NotImplementedError

    def loop(self):
        pass

    def end(self):
        pass


def run_part(part: RoundPart):
    """A part with its eager loop (``round_step``'s form)."""
    part.begin()
    part.loop()
    part.end()
    if part.branches:
        (part.widen if bool(part.need) else part.keep)()
        part.after()


class HeadPart(RoundPart):
    """The batch's queries and levels, the entry's distance, the pivots."""

    def __init__(self, bt: BuildTensors, st: RoundState, metric: str):
        self.bt, self.st, self.metric = bt, st, metric

    def begin(self):
        bt, st = self.bt, self.st
        bl = st.batch_ids.long()
        st.q.copy_(bt.vectors[bl])
        st.lv.copy_(bt.levels[bl])
        st.alive.copy_(st.lv >= 0)
        e = st.entry.long()
        B, d = st.q.shape
        st.d0.copy_(scores_gathered(self.metric, st.q, bt.vectors[e][None].expand(B, 1, d),
                                    bt.sqnorms[e].reshape(1, 1).expand(B, 1))[:, 0])
        st.pivot.copy_(st.entry.expand(B))


class DescentPart(RoundPart):
    """The ef=1 descent through layer ``layer`` (``MAX_HOPS`` hops at most),
    then the pivots and the reference's projection link on that layer when
    it holds links (``src/hnsw.rs:1114-1155``)."""

    iters = MAX_HOPS

    def __init__(self, bt: BuildTensors, st: RoundState, metric: str, layer: int,
                 linked: bool):
        self.bt, self.st, self.metric, self.layer, self.linked = bt, st, metric, layer, linked
        self.tbl = bt.ids[layer] if linked else bt.empty()

    def begin(self):
        st = self.st
        self.ds = DescentState(st.pivot, st.d0, self.layer > st.lv)

    def step(self, it: int):
        descent_hop(self.ds, self.metric, self.bt.vtrav, self.bt.sqnorms, self.tbl, self.st.q)

    def finished(self):
        return ~self.ds.improved.any()

    def loop(self):
        descent_layer(self.ds, self.metric, self.bt.vtrav, self.bt.sqnorms, self.tbl,
                      self.st.q)

    def end(self):
        bt, st, ds = self.bt, self.st, self.ds
        st.pivot.copy_(torch.where(ds.act, ds.p, st.pivot))
        st.d0.copy_(torch.where(ds.act, ds.pd, st.d0))
        if self.linked:
            a = ds.act & st.alive
            tgt = torch.where(a, st.batch_ids, bt.cap1 - 1).long()
            bt.ids[self.layer][tgt, 0] = torch.where(a, st.pivot, -1)
            bt.dists[self.layer][tgt, 0] = torch.where(a, st.d0, INF)


class BuildPart(RoundPart):
    """Construction on layer ``layer`` for the first ``rows`` points (the
    B1 prefix on upper layers, the whole batch on layer 0): the
    ef_construction beam, the exact re-score, on layer 0 with ``extend`` the
    widen pass, the neighbour selection and the forward rows; then the
    pivots (upper layers) or the forward in-degree (layer 0)."""

    def __init__(self, bt: BuildTensors, st: RoundState, metric: str, layer: int,
                 rows: int, width: int, efc: int, expand: int, max_iters, keep_pruned: bool,
                 extend: bool = False, protect: bool = False):
        self.bt, self.st, self.metric, self.layer, self.rows = bt, st, metric, layer, rows
        self.width, self.efc, self.expand, self.max_iters = width, efc, expand, max_iters
        self.keep_pruned, self.protect = keep_pruned, protect
        self.branches = bool(extend) and layer == 0
        self.iters = beam_iters(efc, expand, max_iters)
        self.sel = st.selection(layer, rows, width)

    def begin(self):
        st, r = self.st, self.rows
        self.act = st.alive if self.layer == 0 else st.alive[:r] & (st.lv[:r] >= self.layer)
        self.beam = beam_setup(self.metric, self.bt.vtrav, self.bt.sqnorms,
                               self.bt.ids[self.layer], st.q[:r], st.pivot[:r], st.d0[:r],
                               ef=self.efc, expand=self.expand, active=self.act,
                               max_iters=self.max_iters)
        self._carry = {f: getattr(self.beam, f) for f in BeamState.CARRY
                       if getattr(self.beam, f) is not None}

    def step(self, it: int):
        beam_step(self.beam, it)

    def carry(self):
        for f, buf in self._carry.items():
            buf.copy_(getattr(self.beam, f))
            setattr(self.beam, f, buf)

    def finished(self):
        return self.beam.done.all()

    def loop(self):
        beam_run(self.beam)

    def end(self):
        cand_ids, cand_d = _rescore_exact(self.bt, self.metric, self.st.q[:self.rows],
                                          *beam_finish(self.beam))
        if not self.branches:
            self._select(cand_ids, cand_d)
            return
        self.k_win = min(cand_ids.shape[1], max(2 * self.width, 128))
        self._cands = (cand_ids, cand_d)
        self._need = extend_need(cand_ids, self.act, self.width)
        self.need = self._need.any()
        self._win = (torch.empty((self.rows, self.k_win), dtype=torch.int32,
                                 device=cand_ids.device),
                     torch.empty((self.rows, self.k_win), device=cand_ids.device))

    def widen(self):
        out = extend_widen(self.metric, self.bt.vectors, self.bt.sqnorms, self.bt.ids[0],
                           self.st.q, *self._cands, self.width, self._need, self.k_win)
        for buf, x in zip(self._win, out):
            buf.copy_(x)

    def keep(self):
        for buf, x in zip(self._win, extend_keep(*self._cands, self.k_win)):
            buf.copy_(x)

    def after(self):
        self._select(*self._win)

    def _select(self, cand_ids, cand_d):
        bt, st, l, r, act = self.bt, self.st, self.layer, self.rows, self.act
        sel_ids, sel_d = select_neighbours_batched(self.metric, bt.vectors, bt.sqnorms,
                                                   cand_ids, cand_d, self.width,
                                                   self.keep_pruned)
        tgt = torch.where(act, st.batch_ids[:r], bt.cap1 - 1).long()
        bt.ids[l][tgt] = torch.where(act[:, None], sel_ids, -1)
        bt.dists[l][tgt] = torch.where(act[:, None], sel_d, INF)
        self.sel[0].copy_(sel_ids)
        self.sel[1].copy_(sel_d)
        if l > 0:
            has = act & torch.isfinite(sel_d[:, 0])
            st.pivot[:r].copy_(torch.where(has, sel_ids[:, 0], st.pivot[:r]))
            st.d0[:r].copy_(torch.where(has, sel_d[:, 0], st.d0[:r]))
        elif self.protect:
            _add_counts(bt.indeg0, sel_ids, act[:, None] & (sel_ids >= 0), 1)


def _rescore_exact(bt: BuildTensors, metric: str, q, cand_ids, cand_d):
    """With a bf16 traversal copy: the candidates re-scored against the f32
    vectors and re-sorted; without one, as they are."""
    if bt.vectors_lo is None:
        return cand_ids, cand_d
    safe = torch.clamp(cand_ids, 0, bt.cap1 - 1).long()
    sc = scores_gathered(metric, q, bt.vectors[safe], bt.sqnorms[safe])
    sc = torch.where(cand_ids >= 0, sc, INF)
    sd, o = torch.sort(sc, dim=1, stable=True)
    return torch.gather(cand_ids, 1, o), sd


class MergeZeroPart(RoundPart):
    """The layer-0 reverse-link merge of the level-0 points' selections (with
    the in-degree guarantee under ``protect``)."""

    def __init__(self, bt: BuildTensors, st: RoundState, width: int, protect: bool,
                 min_indeg: int):
        self.bt, self.st, self.width, self.protect, self.min_indeg = (
            bt, st, width, protect, min_indeg)
        self.sel = st.selection(0, st.B, width)

    def begin(self):
        bt, st = self.bt, self.st
        sids, sd = self.sel
        ev0 = (sids >= 0) & st.alive[:, None] & (st.lv == 0)[:, None]
        eq0 = sids.reshape(-1)
        ed0 = sd.reshape(-1)
        es0 = st.batch_ids[:, None].expand(sids.shape).reshape(-1)
        v0 = ev0.reshape(-1) & (eq0 != es0)
        if not self.protect:
            _reverse_merge(bt.ids[0], bt.dists[0], eq0, es0, ed0, v0, self.width)
            return
        ep0 = (torch.arange(sids.shape[1], device=sids.device)[None, :] < self.min_indeg
               ).expand(sids.shape).reshape(-1)
        _reverse_merge(bt.ids[0], bt.dists[0], eq0, es0, ed0, v0, self.width,
                       indeg=bt.indeg0, eprot=ep0, min_indeg=self.min_indeg)


class MergeUpperPart(RoundPart):
    """The upper layers' reverse-link merge: the B1 prefix's selections on
    layer 0 (``with0``) and on each layer in ``uppers``, grouped by the new
    point's level."""

    def __init__(self, bt: BuildTensors, st: RoundState, B1: int, widths: tuple,
                 uppers: tuple, with0: bool):
        self.bt, self.st, self.B1, self.widths = bt, st, B1, widths
        self.parts = ([st.selection(0, st.B, widths[0])] if with0 else []) + [
            st.selection(l, B1, widths[l]) for l in sorted(uppers)]

    def begin(self):
        bt, st, B1 = self.bt, self.st, self.B1
        eq = torch.cat([p[0][:B1] for p in self.parts], dim=1)
        edd = torch.cat([p[1][:B1] for p in self.parts], dim=1)
        esrc = st.batch_ids[:B1, None].expand(eq.shape)
        elv = st.lv[:B1, None].expand(eq.shape)
        eq, edd, esrc, elv = (x.reshape(-1) for x in (eq, edd, esrc, elv))
        ev = (eq >= 0) & (eq != esrc)
        for l_n in range(1, len(self.widths)):
            _reverse_merge(bt.ids[l_n], bt.dists[l_n], eq, esrc, edd, ev & (elv == l_n),
                           self.widths[l_n])


def round_plan(cfg: RoundConfig, protect: bool) -> list:
    """The parts of a round, in order, as ``(key, make)``: ``key`` names the
    part and every static it reads (of ``cfg``, and whether the in-degree
    guarantee runs), ``make(bt, st)`` builds it. The layer-0 construction
    depends on neither ``B1`` nor ``max_obs``, so every steady round shares
    its key."""
    B, B1, L, m = cfg.B, cfg.B1, cfg.num_layers, cfg.metric
    beam = (cfg.efc, cfg.expand, cfg.max_iters, cfg.keep_pruned)
    plan = [(("head", B), lambda bt, st: HeadPart(bt, st, m))]
    for l in range(min(cfg.max_obs, L - 1), 0, -1):
        linked = bool(cfg.nonempty[l])
        plan.append((("descent", B, l, linked),
                     lambda bt, st, l=l, linked=linked: DescentPart(bt, st, m, l, linked)))
    uppers = tuple(l for l in range(L - 1, 0, -1) if cfg.nonempty[l]) if B1 else ()
    for l in uppers:
        plan.append((("build", B, l, B1, cfg.widths[l]) + beam,
                     lambda bt, st, l=l: BuildPart(bt, st, m, l, B1, cfg.widths[l],
                                                   *beam)))
    if cfg.nonempty[0]:
        plan.append((("build", B, 0, B, cfg.widths[0]) + beam + (cfg.extend, protect),
                     lambda bt, st: BuildPart(bt, st, m, 0, B, cfg.widths[0], *beam,
                                              extend=cfg.extend, protect=protect)))
        plan.append((("merge0", B, cfg.widths[0], protect, cfg.min_indeg),
                     lambda bt, st: MergeZeroPart(bt, st, cfg.widths[0], protect,
                                                  cfg.min_indeg)))
    if B1 and (cfg.nonempty[0] or uppers):
        plan.append((("merge_upper", B, B1, cfg.widths, uppers, bool(cfg.nonempty[0])),
                     lambda bt, st: MergeUpperPart(bt, st, B1, cfg.widths, uppers,
                                                   bool(cfg.nonempty[0]))))
    return plan


def round_step(vectors, sqnorms, levels, tables, batch_ids, entry,
               vectors_lo=None, indeg0=None, *, cfg: RoundConfig):
    """One synchronized insertion round, eager: every part of ``round_plan``
    with its own loop (one host read per beam iteration and per descent
    hop). ``tables`` is a sequence of (ids, dists) per layer, updated in
    place and returned. With ``indeg0`` (a [cap1] int32 layer-0 in-degree
    array, also updated in place) the layer-0 merge protects in-degree and
    the return value is ``(tables, indeg0)``. ``entry``: an int or a
    one-element tensor.

    ``vectors_lo``: optional bf16 copy used only for traversal scoring; the
    candidates are re-scored in f32 before the neighbour selection.
    ``ops/program.py::BuildPrograms`` runs the same parts as captured device
    programs and writes the same tables."""
    bt = BuildTensors(vectors, sqnorms, levels, tables, vectors_lo, indeg0)
    st = RoundState(cfg.B, vectors.shape[1], vectors.device)
    st.start(batch_ids, entry)
    for key, make in round_plan(cfg, indeg0 is not None):
        with PROFILER.span("build.part." + key[0]):
            run_part(make(bt, st))
    out = bt.tables()
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

    def conform(self, L: int, widths: tuple, cap1: int):
        """Adopt a geometry shared with other states: the sharded build runs
        one round per shard per step on one set of shapes."""
        assert L >= self.L and cap1 >= self.cap1
        if L > self.L:
            self.counts = np.concatenate([self.counts, np.zeros(L - self.L, np.int64)])
        self.L, self.widths, self.cap1 = int(L), tuple(widths), int(cap1)

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
    ``pairs`` is a list of ``(vector, id)`` tuples or an ``(X, ids)`` pair.
    On the card every round runs through the build's round programs
    (``program.round_programs``: captured CUDA graphs); on the CPU through
    the eager ``round_step``. ``hnsw._round_stats`` counts the rounds, the
    rounds replayed, the program keys, the captures, the keys run uncaptured
    because their captures would take the pool past its budget, and the
    bytes of the programs' pool; the profiler's ``build.*`` counters sum the
    rounds and the summable ones over builds. The spans: ``build.insert``
    over the call, ``build.setup``, ``build.plan`` and ``build.round`` (with
    ``build.part.<kind>`` inside) for each round, ``build.flush``,
    ``build.repair`` (``utils/profiling.py``).

    On the card each key's first round measures its pieces' peaks by
    resetting the card's CUDA peak memory statistics
    (``torch.cuda.reset_peak_memory_stats``), so ``torch.cuda``'s peak read
    across a build is the build's last piece's: ``program.peak_memory`` (a
    window started with ``program.reset_peak_memory``) gives the larger of the
    caller's peak and the build's."""
    with PROFILER.span("build.insert"):
        _device_parallel_insert(hnsw, pairs, batch_size, expand, build_max_iters)


# the build's summable counters (``BuildPrograms.stats``; ``build.rounds``
# is counted for both forms of the round)
SUMMED_STATS = ("rounds_replayed", "first_runs", "captures", "capture_s", "chunk_graphs",
                "widen_replays", "keep_replays")


def _device_parallel_insert(hnsw, pairs, batch_size, expand, build_max_iters):
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
    from . import program

    dev = hnsw.device
    with PROFILER.span("build.setup"):
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
        progs = program.round_programs(dev)
        if progs is not None:
            bt = BuildTensors(vectors, sqnorms, levels_t, tables, vectors_lo, indeg0)
    while st.remaining:
        with PROFILER.span("build.plan"):
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
            if progs is None:
                round_step(vectors, sqnorms, levels_t, tables,
                           torch.as_tensor(bidx, device=dev), entry,
                           vectors_lo, indeg0, cfg=cfg)
            else:
                progs.round(bt, cfg, bidx, entry)
        PROFILER.add("build.rounds")
        if st.cursor % 50_000 < Br:  # reference prints every 50k (src/hnsw.rs:524-526)
            init_logging().info("device insert: %d points indexed", st.cursor)
    with PROFILER.span("build.flush"):
        st.flush([(i.cpu().numpy(), d.cpu().numpy()) for i, d in tables])
        if progs is not None:  # before the snapshot and the search programs take memory
            for k in SUMMED_STATS:
                PROFILER.add(f"build.{k}", progs.stats[k])
            hnsw._round_stats = progs.report()
            progs.clear()
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
