"""Where a beam iteration's time goes, part by part, on a real-scale table:
the counterpart of the root ``tools/exp_iter.py`` (the JAX package's).

    python -m hnsw_tpu_torch.tools.exp_iter [--device cpu]

Each part of ``ops/beam_search.py``'s iteration is chained ``REPS`` times
with data dependence (the next call's input depends on this call's output,
so nothing can be left out) inside one program: a ``CallProgram`` (one CUDA
graph on the card, as the reference chains each part inside one jit; the
function itself on the CPU), timed as the best of three replays over
``REPS``:

  score       ``codec_scores`` on an [N, M0 + id_rows, d] int8 table whose id
              rows hold a random [N, M0] link table (kernel B1, entry
              ``bulk`` at the defaults): scores and neighbour ids
  merge       ``_merge_beam`` at [B, ef + K] (K = E * M0): one key-value sort
  masks       the revisit masks: ``_member`` against the beam and a history
              of width K, and ``_first_occurrence_dups``
  tbl_gather  the link table's [B, E] rows of M0 int32
  topk_E      the E smallest of [B, ef] (``smallest``: a stable sort)
  body        one whole ``beam_step`` (all of the above, the selection and
              the history ring) on the same table through the codec
  bookkeeping ``ops/beam_step.py``'s ``select`` (with the link table: the
              selection, the ring write and the suppression, one kernel
              launch on the card) and ``merge``, and their plain versions
              (the library sorts), at the serving cells' shape (ef 128, E 4,
              M0 96, a ring of 34 slots, B 10,000) and the build's (ef 800,
              E 8, M0 96, 216 slots, B 16,384), B capped at IB; each beside
              its bytes' bound at 3.35 TB/s

The JSON line on stdout holds each part's ``ms`` (and the score's GB/s),
``bookkeeping`` (per shape: ``select_ms``, ``merge_ms``, ``plain_select_ms``,
``plain_merge_ms``, ``bound_select_ms``, ``bound_merge_ms``),
``parts_ms`` (the five parts' sum), ``sort_parts_ms`` (merge + masks + topk_E,
the parts built on sorts) and its share of the parts and of ``body``, the
knobs and the device (the card's name and power limit). The parts are timed
alone at the reference's shapes (the masks against a history of width K), so
they need not sum to ``body``, whose history ring is ``REPS`` slots wide and
which reads its neighbour ids from the codec rather than the table. Needs one
CUDA card unless ``--device cpu``.

Env knobs, as the reference's: IB (batch, 16384), IE (expand, 4), IM0 (56),
ID (128), IN (1_000_001), IEF (80), REPS (20). Left out, as TPU-only: IQT and
ISLOTS (the Pallas kernel's query tile and DMA slots; the CUDA kernel sizes
its own ring) and the jax compilation cache.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..bench import device_info, log
from ..ops import beam_step as bstep
from ..ops.beam_search import beam_setup, beam_step
from ..ops.beam_step import _first_occurrence_dups, _member, _merge_beam, smallest
from ..ops.codec_scores import codec_scores
from ..ops.graph_arrays import BeamCodec
from ..ops.program import CallProgram
from ..utils.device import resolve_device


def knobs() -> dict:
    env = os.environ.get
    return dict(B=int(env("IB", 16384)), E=int(env("IE", 4)), M0=int(env("IM0", 56)),
                d=int(env("ID", 128)), N=int(env("IN", 1_000_001)), ef=int(env("IEF", 80)),
                REPS=int(env("REPS", 20)))


def id_rows(M0: int, d: int) -> int:
    """The codec's id rows: enough for M0 int32, ``M0 + rows`` a multiple
    of 8 (``BeamCodec``'s layout)."""
    r = max(1, -(-4 * M0 // d))
    return r + (-(M0 + r)) % 8


def make_table(N: int, M0: int, d: int, device, seed: int = 7):
    """(blocks [N, M0 + id_rows, d] int8, tbl [N, M0] int32): random int8
    vector rows, and id rows holding ``tbl`` (random links in [0, N - 1))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rid = id_rows(M0, d)
    blocks = torch.randint(-127, 128, (N, M0 + rid, d), generator=gen, dtype=torch.int8,
                           device=device)
    tbl = torch.randint(0, N - 1, (N, M0), generator=gen, dtype=torch.int32, device=device)
    idp = torch.full((N, rid * d // 4), -1, dtype=torch.int32, device=device)
    idp[:, :M0] = tbl
    blocks[:, M0:] = idp.view(torch.int8).reshape(N, rid, d)
    return blocks, tbl


def timed(device, prog, xs, outer: int = 3) -> float:
    """Seconds of the best of ``outer`` runs of ``prog`` (after one that
    warms), each ended by a synchronize on the card."""
    prog.run(*xs)
    best = float("inf")
    for _ in range(outer):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        prog.run(*xs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


HBM_BYTES_PER_S = 3.35e12
# (B, ef, E, M0, ring slots): the serving cells' iteration and the build's
BOOK_SHAPES = {"serving": (10_000, 128, 4, 96, 34), "build": (16_384, 800, 8, 96, 216)}


def bookkeeping(device, N: int, B_cap: int, REPS: int) -> dict:
    """``select`` (with the link table) and ``merge`` chained ``REPS`` times
    at each of ``BOOK_SHAPES``, through the route the device takes and
    through the plain versions: ms a call, and the bytes' bound (a query's
    beam, ring, links and ids read and written once)."""
    out = {}
    for name, (B, ef, E, M0, slots) in BOOK_SHAPES.items():
        B = min(B, B_cap)
        H, K = E * slots, E * M0
        gen = torch.Generator(device=device).manual_seed(11)
        bd = torch.rand((B, ef), generator=gen, device=device)
        bd[:, ef * 3 // 4:] = float("inf")
        bd = torch.sort(bd, 1).values
        bi = torch.randint(0, N - 1, (B, ef), generator=gen, dtype=torch.int32, device=device)
        bi = torch.where(bd < float("inf"), bi, -1)
        ring0 = torch.full((B, H), -2, dtype=torch.int32, device=device)
        tbl = torch.randint(0, N - 1, (N, M0), generator=gen, dtype=torch.int32,
                            device=device)
        done = torch.zeros((B,), dtype=torch.bool, device=device)
        new = bstep.select_plain(bi, bd, ring0.clone(), done, slot=0, E=E, term_slack=1.0,
                                 cap1=N, tbl_ids=tbl)[2]
        new_d = torch.where(new >= 0, torch.rand((B, K), generator=gen, device=device),
                            float("inf"))
        row = {}
        for label, sel, mrg in (("", bstep.select, bstep.merge),
                                ("plain_", bstep.select_plain, _merge_beam)):

            def chain_select(ring, sel=sel):
                for r in range(REPS):  # each call reads the ring the last one wrote
                    sel(bi, bd, ring, done, slot=(r % slots) * E, E=E, term_slack=1.0,
                        cap1=N, tbl_ids=tbl)
                return (ring,)

            def chain_merge(ids, d, mrg=mrg):
                for _ in range(REPS):
                    ids, d = mrg(ids, d, new, new_d, ef)
                return ids, d

            for part, fn, xs in (("select", chain_select, [ring0]),
                                 ("merge", chain_merge, [bi, bd])):
                prog = CallProgram(fn, [(tuple(x.shape), x.dtype) for x in xs], device)
                row[f"{label}{part}_ms"] = timed(device, prog, xs) / REPS * 1e3
        sel_bytes = B * (8 * ef + 4 * H + 8 * K + 8 * E + 2)
        merge_bytes = B * (8 * ef + 8 * K + 8 * ef)
        row.update(B=B, ef=ef, E=E, M0=M0, H=H, K=K,
                   bound_select_ms=sel_bytes / HBM_BYTES_PER_S * 1e3,
                   bound_merge_ms=merge_bytes / HBM_BYTES_PER_S * 1e3)
        out[name] = row
        log(f"[iter] bookkeeping {name}: {json.dumps(row)}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    kn = knobs()
    B, E, M0, d, N, ef, REPS = (kn[k] for k in ("B", "E", "M0", "d", "N", "ef", "REPS"))
    K, H = E * M0, E * M0  # the history width of the reference's knob
    gen = torch.Generator(device=device).manual_seed(7)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, dtype=torch.int32, device=device)

    blocks, tbl = make_table(N, M0, d, device)
    rid = blocks.shape[1] - M0
    q = rand(B, d)
    qsn = (q * q).sum(-1, keepdim=True)
    scale = torch.tensor(0.01, device=device)
    src0 = ints(N - 2, B, E)
    results: dict = {}

    def part(name, fn, xs, nbytes=None):
        prog = CallProgram(fn, [(tuple(x.shape), x.dtype) for x in xs], device)
        ms = timed(device, prog, xs) / REPS * 1e3
        row = {"ms": ms}
        if nbytes:
            row["gbps"] = nbytes / ms / 1e6
        results[name] = row
        log(f"[iter] {name}: {json.dumps(row)}")

    # ---- score: kernel B1 (scores and ids), chained through its ids ----
    def chain_score(src):
        acc = torch.zeros((), device=device)
        for _ in range(REPS):
            sc, nbr = codec_scores(src, q, qsn, scale, blocks, M0, "l2")
            src = (src + (sc[:, :E] > 0).int() + (nbr[:, :E] & 1)) % (N - 1)
            acc = acc + sc[0, 0]
        return src, acc

    part("score", chain_score, [src0], nbytes=B * E * (M0 + rid) * d)

    # ---- merge: the beam merge's key-value sort at [B, ef + K] ----
    bd0 = torch.sort(rand(B, ef), 1).values
    bi0 = ints(N - 2, B, ef)
    nd0, ni0 = rand(B, K), ints(N - 2, B, K)

    def chain_merge(bi, bd):
        for _ in range(REPS):
            bi, bd = _merge_beam(bi, bd, ni0, nd0 + bd[:, :1], ef)
        return bi, bd

    part("merge", chain_merge, [bi0, bd0])

    # ---- masks: beam and history membership, intra-step duplicates ----
    hist0 = ints(N - 2, B, H)

    def chain_masks(nbr):
        for _ in range(REPS):
            valid = nbr >= 0
            valid = (valid & ~_member(nbr, bi0) & ~_member(nbr, hist0)
                     & ~_first_occurrence_dups(nbr, valid))
            nbr = nbr + valid.int()
        return (nbr,)

    part("masks", chain_masks, [ni0])

    # ---- tbl_gather: the link table's rows of the expanded nodes ----
    def chain_tbl(src):
        for _ in range(REPS):
            nbr = tbl[torch.clamp(src, 0, N - 1).long()].reshape(B, K)
            src = (src + (nbr[:, :E] > 0).int()) % (N - 1)
        return (src,)

    part("tbl_gather", chain_tbl, [src0])

    # ---- topk_E: the E nearest of the beam ----
    def chain_topk(bd):
        for _ in range(REPS):
            v, _ = smallest(bd, E)
            bd = bd + v[:, :1] * 1e-6
        return (bd,)

    part("topk_E", chain_topk, [bd0])

    # ---- body: one whole beam iteration through the codec ----
    codec = BeamCodec(blocks=blocks, blocks_sq=torch.rand((N, M0), generator=gen,
                                                         device=device),
                      scale=scale, M0=M0, dim=d, metric_name="L2", id_rows=rid)

    def chain_body(start, start_d):
        st = beam_setup("L2", None, None, tbl, q, start, start_d, ef=ef, expand=E,
                        max_iters=max(REPS, 1), codec=codec)
        for it in range(REPS):
            beam_step(st, it)
        return st.beam_ids, st.beam_d

    part("body", chain_body, [src0[:, 0].contiguous(), rand(B).abs()])

    book = bookkeeping(device, N, B, REPS)
    sorts = sum(results[p]["ms"] for p in ("merge", "masks", "topk_E"))
    parts = sorts + results["score"]["ms"] + results["tbl_gather"]["ms"]
    out = {"tool": "exp_iter", **kn, "K": K, "id_rows": rid, **results,
           "parts_ms": parts, "sort_parts_ms": sorts,
           "sort_parts_share_of_parts": sorts / parts,
           "sort_parts_share_of_body": sorts / results["body"]["ms"],
           "bookkeeping": book,
           "device": device_info(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
