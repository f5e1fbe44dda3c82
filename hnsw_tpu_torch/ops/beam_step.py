"""The bookkeeping of a beam iteration: the selection of the entries to
expand, the history ring's write, the revisit suppression and the merge
(``ops/beam_search.py``'s steps 1, 3 and 4).

On CPU tensors each function runs its plain version, built from the library
sorts the JAX package uses (``smallest``, ``_member``,
``_first_occurrence_dups``, ``_merge_beam``). On CUDA tensors it launches
``csrc/beam_step.cu`` (one block a query, a hash set and a merge by rank in
shared memory, no sort) or raises; it never falls back. The kernels read
ids and f32 distances only, so one build serves every metric and table
dtype, and every output is a copy or a comparison of an input: the two
routes agree bit for bit.

Two launches an iteration: ``select`` (entry ``fused``: the selection, the
ring write and the suppression of the selected entries' neighbours, read
from the link table) and ``merge`` (entry ``merge``), counted in
``kernel_lib.LAUNCHES["beam_step"]`` and by entry ``beam_step.<entry>``. The
neighbours always come from the link table: a codec's id rows, where it has
them, are the same table's rows (``BeamCodec.build``). The threads and the
shared memory of a launch follow the shapes alone (``select_plan``,
``merge_plan``); a shape past a block's shared memory raises with its sizes
before any launch.
"""

from __future__ import annotations

import torch

from . import kernel_lib

INF = float("inf")
# a block's shared memory on the H100 (227 KB) less the kernels' static arrays
SMEM_MAX = 232448 - 1024
MAX_THREADS = 512


def smallest(x, k: int):
    """(values, positions) of the ``k`` smallest entries per row, ascending;
    ties keep the lower position (``lax.top_k`` on the negated scores)."""
    v, i = torch.sort(x, dim=1, stable=True)
    return v[:, :k], i[:, :k]


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


def select_plain(beam_ids, beam_d, hist, done, *, slot: int, E: int, term_slack: float,
                 cap1: int, tbl_ids):
    """Plain version of ``select``."""
    B = beam_ids.shape[0]
    beam_exp = _member(beam_ids, hist)
    cand_d = torch.where(beam_exp | (beam_ids < 0), INF, beam_d)
    sel_d, pos = smallest(cand_d, E)
    nearest_d = sel_d[:, 0]
    worst = beam_d[:, -1]
    if term_slack == 1.0:
        thresh = worst
    else:
        thresh = torch.where(torch.isfinite(worst),
                             worst + (term_slack - 1.0) * worst.abs(), INF)
    step_done = done | (nearest_d == INF) | (nearest_d > thresh)
    sel_ok = ~step_done[:, None] & (sel_d < INF)
    src = torch.gather(beam_ids, 1, pos)
    hist[:, slot:slot + E] = torch.where(sel_ok, src, -2)
    src_c = torch.clamp(src, 0, cap1 - 1)
    nbr = tbl_ids[src_c.long()].reshape(B, -1)
    K = nbr.shape[1]
    valid = sel_ok[:, :, None].expand(B, E, K // E).reshape(B, K) & (nbr >= 0)
    in_beam = _member(nbr, beam_ids)
    in_hist = _member(nbr, hist)
    dup = _first_occurrence_dups(nbr, valid)
    valid = valid & ~in_beam & ~in_hist & ~dup
    return step_done, src_c, torch.where(valid, nbr, -1)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _threads(K: int) -> int:
    """A launch's threads: a quarter of K's next power of two, 128 to 512."""
    return min(MAX_THREADS, max(128, _pow2(K) // 4))


def select_plan(W: int, H: int, K: int, E: int):
    """(threads, log2 of the hash table's slots, shared memory bytes) of a
    ``select`` launch: a beam of W, a ring of H, K candidates, E selected.
    The table holds the ring outside the written slot, the beam and the
    candidates, at most 5/6 full. Raises where the bytes pass ``SMEM_MAX``."""
    n_keys = (H - E) + W + K
    log_t = 1
    while 5 * (1 << log_t) < 6 * n_keys:
        log_t += 1
    nbytes = 8 * W + 8 * (1 << log_t) + 4 * K + 12 * E
    if nbytes > SMEM_MAX:
        raise ValueError(f"beam_step.fused: a beam of {W}, a ring of {H}, {K} candidates "
                         f"and {E} selected need {nbytes} bytes of shared memory a query, "
                         f"past the {SMEM_MAX} a block has")
    return _threads(K), log_t, nbytes


def merge_plan(W: int, K: int):
    """(threads, padded candidate count, shared memory bytes) of a ``merge``
    launch of a beam of W and K candidates. Raises past ``SMEM_MAX``."""
    n_pad = _pow2(K)
    nbytes = 8 * n_pad + 4 * W
    if nbytes > SMEM_MAX:
        raise ValueError(f"beam_step.merge: a beam of {W} and {K} candidates need {nbytes} "
                         f"bytes of shared memory a query, past the {SMEM_MAX} a block has")
    return _threads(K), n_pad, nbytes


def _int32(x, what):
    if x.dtype != torch.int32:
        raise ValueError(f"beam_step: {what} must be int32, got {x.dtype}")
    return x.contiguous()


def select(beam_ids, beam_d, hist, done, *, slot: int, E: int, term_slack: float, cap1: int,
           tbl_ids):
    """The E nearest unexpanded entries of each beam (``beam_ids``,
    ``beam_d`` [B, W], ascending; expanded = in the ring ``hist`` [B, H]) and
    the termination test (``done`` [B], slack ``term_slack``); the selected
    ids, or -2 where nothing is selected, written into the ring at columns
    ``slot:slot + E``; and the selected entries' neighbours (``tbl_ids``
    [cap1, M]) with every one that is not kept set to -1: kept = its entry
    was selected, its id is >= 0, in neither the beam nor the ring, and at no
    lower position among the valid candidates. Returns (step_done [B] bool,
    src_c [B, E] int32: the selected ids clamped into the table, new_ids
    [B, E*M] int32)."""
    if beam_ids.device.type != "cuda":
        return select_plain(beam_ids, beam_d, hist, done, slot=slot, E=E,
                            term_slack=term_slack, cap1=cap1, tbl_ids=tbl_ids)
    return _launch_select(beam_ids, beam_d, hist, done, slot=slot, E=E, term_slack=term_slack,
                          cap1=cap1, tbl_ids=tbl_ids)


def _launch_select(beam_ids, beam_d, hist, done, *, slot, E, term_slack, cap1, tbl_ids):
    B, W = beam_ids.shape
    H = hist.shape[1]
    if hist.dtype != torch.int32 or not hist.is_contiguous():
        raise ValueError("beam_step: the ring must be a contiguous int32 tensor "
                         "(it is written in place)")
    if tbl_ids.dtype != torch.int32 or tbl_ids.stride(1) != 1:
        raise ValueError("beam_step: the link table must be int32 rows of unit stride")
    beam_ids = _int32(beam_ids, "beam ids")
    beam_d = beam_d.to(torch.float32).contiguous()
    M, ld = tbl_ids.shape[1], tbl_ids.stride(0)
    K = E * M
    threads, log_t, _ = select_plan(W, H, K, E)
    dev = beam_ids.device
    done = done.to(torch.bool).contiguous()
    step_done = torch.empty((B,), dtype=torch.bool, device=dev)
    src_c = torch.empty((B, E), dtype=torch.int32, device=dev)
    new_ids = torch.empty((B, K), dtype=torch.int32, device=dev)
    lib = kernel_lib.load("beam_step")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel_lib.launch(
            "beam_step", "fused", lib.beam_step_launch,
            beam_ids.data_ptr(), beam_d.data_ptr(), B, W, hist.data_ptr(), H, slot, E,
            done.data_ptr(), step_done.data_ptr(), src_c.data_ptr(), float(term_slack - 1.0),
            int(term_slack == 1.0), cap1, tbl_ids.data_ptr(), ld, M, new_ids.data_ptr(), K,
            threads, log_t, stream, card=dev.index)
    return step_done, src_c, new_ids


def merge(beam_ids, beam_d, new_ids, new_d, ef: int):
    """The best ``ef`` of a beam (``beam_ids``, ``beam_d`` [B, W], ascending)
    and candidates (``new_ids``, ``new_d`` [B, K]), ascending; ties in stable
    order (the beam first, then by position), NaN last."""
    if beam_ids.device.type != "cuda":
        return _merge_beam(beam_ids, beam_d, new_ids, new_d, ef)
    return _launch_merge(beam_ids, beam_d, new_ids, new_d, ef)


def _launch_merge(beam_ids, beam_d, new_ids, new_d, ef: int):
    B, W = beam_ids.shape
    K = new_ids.shape[1]
    if not 1 <= ef <= W + K:
        raise ValueError(f"beam_step.merge: ef {ef} outside 1..{W + K}")
    threads, n_pad, _ = merge_plan(W, K)
    beam_ids, new_ids = _int32(beam_ids, "beam ids"), _int32(new_ids, "candidate ids")
    beam_d = beam_d.to(torch.float32).contiguous()
    new_d = new_d.to(torch.float32).contiguous()
    dev = beam_ids.device
    out_ids = torch.empty((B, ef), dtype=torch.int32, device=dev)
    out_d = torch.empty((B, ef), dtype=torch.float32, device=dev)
    lib = kernel_lib.load("beam_step")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel_lib.launch("beam_step", "merge", lib.beam_step_merge_launch,
                          beam_ids.data_ptr(), beam_d.data_ptr(), B, W, new_ids.data_ptr(),
                          new_d.data_ptr(), K, ef, threads, n_pad, out_ids.data_ptr(),
                          out_d.data_ptr(), stream, card=dev.index)
    return out_ids, out_d
