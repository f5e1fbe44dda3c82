#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hnsw_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # all phases, exits 0 only if all pass

Phases, each printing one JSON line. Path 1 (build and serve):

  env      card name and power limit (nvidia-smi), torch/CUDA versions, the
           kernel build time (nvcc, one process per source, in parallel) and
           ptxas's registers and spilled bytes of every kernel entry
  kernels  B2 and B5 against their plain versions: the scan outputs themselves
           (B2: loc bits, decoded distances; B5: f32 values, row ids) through
           the tensor-core entry at 200k x 128 with B=2048 and at a ragged
           shape, through the f32-FMA entry on a small f32 case; then the ids
           and distances after the refine
  build    Hnsw(M=24, efC=400, L2) with level scale 0.5 and kept pruned
           links, ``parallel_insert(mode="device", batch_size=16384,
           build_max_iters=96)`` on the 200k x 128 gauss corpus of bench.py
  gt       BruteForceIndex (kernel B2) top-64 pool + fp64 host refine over
           4096 queries; exact-scan recall@10
  serve    device_search_stream (batch 16384, expand 4, int8 codec, pivots)
           at ef 32/64/96, k=10: recall@10 scored in fp64, streamed QPS

Path 2 (dump, reload, recall-critical serving), on the index path 1 built:

  persist  ``save_native`` -> ``load_native`` (h2) and ``file_dump`` ->
           ``HnswIo.load_hnsw`` (h3), both onto the card; origin ids, levels,
           entry, vectors and every layer's ids, dists, counts and width must
           equal the built index's (h2 array for array; h3, stored in layer
           order, through ``check_graph_equality`` and the row-sorted tables);
           file sizes and the seconds of the four steps
  serve2   on h2: (a) k=100 through the pool reservoir (ef 192, expand 8,
           pool 256): ids identical to the built index's, recall@100 in fp64;
           (b) ef=256, k=10 with ``allow_fused=False`` (kernel B4) and
           ``True`` (B1): recall@10 of each, B4 launches per batch; (c) exact
           k=100 over 4096 queries with ``packed=False`` (kernel B5) against
           ``packed=True`` (B2): id sets, recall@100; streamed QPS of each

  kernels  B1, B3 and B4 against their plain versions on the codec the serve
           phases read (its M0 and id rows), B=16384, L2/Dot/Cosine: B1 and
           B3 at E=4 and at E=8 (the k=100 run's width), B4 at E=4, each
           through the entry the paths take ("bulk", "stream") and through
           the "rows" entry, timed in turns (``ms`` and ``was_ms``); then a
           ragged group (d = 48, 40, 16, 128, 256, 1024; M0 = 5 to 100; one
           to four id rows or none; E = 1 to 3; B = 5; the table's last block
           among the nodes) through every entry that takes the shape

Path 3 (``metrics``; every other metric, built and served on the card):

  (a) Hamming on 200k 256-bit codes (the sign bits of a fixed random 128 ->
      256 projection of the path-1 corpus: ann-benchmarks' sift-256-hamming
      construction), built as path 1 (M=24, efC=400, batch 16384), served by
      ``device_search_stream`` at ef 64 and 128 on 4096 query codes; recall@10
      against exact counts from XOR + popcount of the packed codes on the card
  (b) Jaccard, Hellinger, Jeffreys, JensenShannon and L1 on 20k x 64 softmax
      rows, Levenshtein on 20k misspellings (one or two edits) of 2k random
      zero-padded words of 3-12 letters, and a
      ``UserMetric`` (weighted L2, both torch forms) on 20k x 16; each built
      with M=16, efC=100, batch 4096, searched at ef 64 over 1024 queries;
      recall@10 against a top-64 pool of the metric's torch scores refined by
      its fp64 numpy oracle; the torch scores against the oracle on 64 x 256

Path 4 (``ivf``; bench.py's 1M x 128 clustered corpus): ground truth from a
chunked f32 matmul on the card refined in fp64 (no engine under test);
``BruteForceIndex`` (kernel B2) scored against it; ``IvfFlatIndex("L2")`` at its
defaults (build seconds, lists, cap, padding share; recall@10 and QPS at
nprobe 16/32/64; ``search_stream`` with f16 ingest at nprobe 32, whose ids
must equal ``search_batch``'s on the same f16-rounded queries);
``AutoIndex("L2")`` must choose the scan, launch B2 (every launch of its
search through the tensor-core entry) and answer as ``BruteForceIndex``;
``AutoIndex("Cosine")`` must choose IVF (recall@10 at nprobe 32 against exact
cosine). After path 4's counts are read, B2 against its plain version at the
exact engine's shape there (the shuffled 1M corpus in bf16, B=2048) and where
the exact scan's misses come from: the engine's recall through the kernel,
the plain version, an f32 scan and a wider overfetch.

Each kernels line carries median CUDA-event times of the kernel, its plain
version and a one-call PyTorch yardstick, and the bound the card allows for
the same work; the two scans also the bound of their epilogue (CUDA-core
instruction rate), the achieved TFLOP/s, the kernel entry that ran, and their time
when 20 launches are queued back to back (``ms`` is timed in turns with the
yardstick, whose 1.6 GB product evicts the corpus from L2 in between).
``--profile`` then traces one served batch per operating point, one
2048-query batch of the exact engine (packed k=10, unpacked k=100)
and a second build with torch.profiler (device time by kernel, the device's
idle share of the window); a window whose kernel time exceeds its wall time
fails the run.

The launch counters are set to 0 just before each path and read just after
it: B1 and B2 must have run on path 1, B4, B5 (and B1, B2) on path 2, B2 on
path 4 (path 3 runs no kernel of the repo's: its metrics have no TPU kernel), the two
scans through their tensor-core entry, B1 through "bulk" and B4 through
"stream" on every launch, and the comparison launches fall outside both
windows. The kernels line
(``{"kernels": [...]}``, all five kernels; ``launches`` is the count on the
first path that runs the kernel, ``launches_by_path`` all four) and the card line
come before the last line, which is ``{"ok": true, "device": {...}}`` when
every phase passed. Without CUDA, or without the package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Card peaks used for bounds (NVIDIA H100 SXM data sheet, dense).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# CUDA-core instruction rate, thread instructions a second: the f32 peak
# counts one FMA (2 flops) per lane and clock.
CUDA_CORE_INSTR_PER_S = F32_FLOPS / 2
# keep-2 update per (query, row) in the tensor-core scans' epilogues. B2: add
# (|x|^2 + |q|^2), fma (- 2 q.x), max (clamp at 0), and-or (clear the low bits,
# put loc), max, min, min. B5: fma, two compares, select, byte permute, max,
# min, min, and the id word's shared-memory load and predicated store.
B2_EPILOGUE_INSTR = 7
B5_EPILOGUE_INSTR = 10

B1_RTOL, B1_ATOL = 1e-5, 1e-4  # f32 summation order differs from the plain sum
B2_SET_EQUAL = 0.999
B2_RTOL = 1e-5
# packed scan, decoded: the value keeps all but its low LB mantissa bits, so
# it moves in steps of one quantum (2^LB ulp of the value), and the two sides
# sum the f32 products of bf16 inputs in different orders, which differ on the
# scale of the terms |q|^2 + |x|^2 + 2 |q.x| (as B5's below), not on that of
# d2, which cancels to near 0 in a tight cluster at large norms (the 1M
# clustered corpus: terms near 1e4, d2 near 1). A cell's first and second
# values are order statistics of the truncated row values, so each side's is
# within one quantum plus that summation error of the other's, whichever row
# either side kept. A bf16 accumulation misses this by two orders.
B2_TERM_RTOL = 1e-6
# a cell whose two best candidates tie within the summation-order error may
# keep either one: loc bits must agree on all but such cells
B2_LOC_EQUAL = 0.999
# unpacked scan: full f32 values of v = |x|^2 - 2 q.x. Both sides sum the same
# exact f32 products of bf16 inputs, the tensor cores in another order than a
# chain of FMAs, so they differ by a few f32 roundings (2^-24 relative each) at
# the magnitude of the partial sums, which is that of the terms |x|^2 and 2
# |q.x| (about 128 each on this corpus) and not that of v, which cancels to
# near 0: the error is held against |x|^2 + 2 |q.x|. A near-tie may swap a
# cell's pick.
B5_TERM_RTOL = 1e-6
B5_ID_EQUAL = 0.999
RECALL_EF96 = 0.97
RECALL_EXACT = 0.999
RECALL_K100 = 0.95          # k=100 through the pool reservoir, ef=192
RECALL_EF256 = 0.995        # unfused; path 1 reads 0.9955 at ef=96
FUSED_UNFUSED_GAP = 0.002   # recall@10 of the two codec routes at ef=256
MAX_ITERS_EF256 = 66        # max(8, 256 // 4 + 2) beam iterations
CODEC_EXPANDS = (4, 8)      # beam widths the two paths give B1: [B, E] src rows


def emit(obj):
    print(json.dumps(obj), flush=True)


def make_dataset(kind, rng, n, nq, d, intrinsic):
    """bench.py's ``make_dataset``: a low-intrinsic-dimension corpus through a
    fixed random linear map, corpus and queries on forked streams so X depends
    on (seed, n, d, intrinsic) only. "gauss": gaussian codes. "clustered":
    max(64, n // 4000) clusters with lognormal weights and scales, Student-t
    offsets, rows in cluster order, a tenth of the queries from the
    background."""
    xrng = np.random.default_rng(rng.integers(2**63))
    qrng = np.random.default_rng(rng.integers(2**63))
    A = (rng.standard_normal((intrinsic, d)).astype(np.float32)
         / np.float32(np.sqrt(intrinsic)))  # f32 under NumPy 1 and 2 alike
    if kind == "gauss":
        Z = xrng.standard_normal((n, intrinsic), dtype=np.float32)
        Zq = qrng.standard_normal((nq, intrinsic), dtype=np.float32)
    elif kind == "clustered":
        C = max(64, n // 4000)
        w = rng.lognormal(0.0, 1.2, C)
        w /= w.sum()
        centers = 4.0 * rng.standard_normal((C, intrinsic))
        sig = rng.lognormal(-0.4, 0.6, C)

        def draw(g, m, counts):
            Z = np.empty((m, intrinsic), np.float32)
            ofs = 0
            for c in range(C):
                k = int(counts[c])
                Z[ofs:ofs + k] = centers[c] + sig[c] * g.standard_t(4, (k, intrinsic))
                ofs += k
            return Z

        Z = draw(xrng, n, xrng.multinomial(n, w))  # cluster-ordered on purpose
        nq_bg = nq // 10
        Zq = np.concatenate([draw(qrng, nq - nq_bg, qrng.multinomial(nq - nq_bg, w)),
                             4.0 * qrng.standard_normal((nq_bg, intrinsic))
                             .astype(np.float32)])
        Zq = Zq[qrng.permutation(nq)]
    else:
        raise ValueError(f"unknown dataset {kind!r}")
    X = np.matmul(Z.astype(np.float32), A)
    for s in range(0, n, 65536):
        e = min(s + 65536, n)
        X[s:e] += 0.02 * xrng.standard_normal((e - s, d), dtype=np.float32)
    Q = np.matmul(Zq.astype(np.float32), A)
    Q += 0.02 * qrng.standard_normal((nq, d), dtype=np.float32)
    return X, Q


def cuda_ms_turns(torch, fns, rounds=5, warmup=1):
    """Median milliseconds of each of ``fns`` over ``rounds`` CUDA-event timed
    calls, taken in turns (a, b, a, b, ...) so that all see the same card
    state."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            t.append(s.elapsed_time(e))
    return [float(np.median(t)) for t in times]


def cuda_ms(torch, fn, warmup=2, iters=7):
    """Median milliseconds of ``fn`` over ``iters`` CUDA-event timed calls."""
    return cuda_ms_turns(torch, [fn], rounds=iters, warmup=warmup)[0]


def bound_ms(nbytes, flops, peak_flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def close(a, b, rtol, atol):
    return bool((a - b).abs().le(atol + rtol * b.abs()).all())


def phase_env(torch, kernel_lib):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card, flush=True)
    t0 = time.time()
    kernel_lib.build_all()
    build_s = time.time() - t0
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "kernel_build_s": build_s, "ptxas": kernel_lib.ptxas_report()})
    return card


def codec_rows(torch, Q, seed, codec=None, n=None):
    """B1 and B3 against their plain version on the card. With ``codec`` (the
    built index's BeamCodec) the check runs on the table the serve phase
    reads, at its M0 and id rows; without, on a random table of that shape
    (M0=56, 8 id rows, the 200k build's). Each is checked and timed at every
    beam width the paths give it (``CODEC_EXPANDS``: src [16384, 4] and
    [16384, 8])."""
    from hnsw_tpu_torch.ops import codec_scores as cs

    dev = torch.device("cuda")
    rows, failures = [], []
    B, d = 16384, Q.shape[1]
    g = torch.Generator(device=dev).manual_seed(seed)
    if codec is not None:
        M0, blocks, scale = codec.M0, codec.blocks, codec.scale
    else:
        M0, RID, n = 56, 8, 200_000
        cap1 = n + 1
        vec = torch.randint(-127, 128, (cap1, M0, d), generator=g, device=dev,
                            dtype=torch.int8)
        ids_tbl = torch.randint(-1, cap1, (cap1, RID * d // 4), generator=g,
                                device=dev, dtype=torch.int32)
        blocks = torch.cat([vec, ids_tbl.view(torch.int8).reshape(cap1, RID, d)], 1)
        scale = torch.tensor(0.0123, dtype=torch.float32, device=dev)
        del vec, ids_tbl
    q = torch.as_tensor(Q[:B], device=dev)
    qsq = (q * q).sum(1, keepdim=True)

    def at_width(name, blk, E):
        """One kernel at one beam width: the three forms against the plain
        version through the entry the paths take and through "rows", then the
        L2 times of both (in turns) and the bound of this shape."""
        src = torch.randint(0, n, (B, E), generator=g, device=dev, dtype=torch.int32)
        rid = blk.shape[1] - M0
        entry = cs.codec_entry(d, M0, rid)
        err = 0.0
        for form in ("l2", "dot", "cosine"):
            qsn = qsq if form == "l2" else torch.sqrt(qsq)
            sp, ip_ = cs.codec_scores_plain(src, q, qsn, scale, blk, M0, form)
            for ent in dict.fromkeys((entry, "rows")):
                sk, ik = cs.codec_scores(src, q, qsn, scale, blk, M0, form, entry=ent)
                torch.cuda.synchronize()
                if ent == entry:
                    err = max(err, float((sk - sp).abs().max()))
                if not close(sk, sp, B1_RTOL, B1_ATOL):
                    failures.append(f"{name} E={E} {form} {ent}: scores beyond tolerance")
                if (ik is None) != (ip_ is None) or (ik is not None and not torch.equal(ik, ip_)):
                    failures.append(f"{name} E={E} {form} {ent}: ids differ")
                del sk, ik
            del sp, ip_
        ms, was_ms = cuda_ms_turns(
            torch, [lambda: cs.codec_scores(src, q, qsq, scale, blk, M0, "l2"),
                    lambda: cs.codec_scores(src, q, qsq, scale, blk, M0, "l2", entry="rows")],
            rounds=7, warmup=2)
        plain_ms = cuda_ms(torch, lambda: cs.codec_scores_plain(src, q, qsq, scale, blk, M0, "l2"))

        def library():
            cv = blk[src.long()][:, :, :M0].reshape(B, E * M0, d).to(torch.float32)
            return torch.einsum("bd,bkd->bk", q, cv) * scale
        lib_ms = cuda_ms(torch, library)
        # gathered: M0 int8 vector rows per node, and M0 int32 ids when the
        # block carries them (the kernel reads no other id byte)
        gathered = B * E * (M0 * d + (4 * M0 if rid else 0))
        nbytes = (gathered + B * d * 4 + B * 4 + B * E * 4
                  + B * E * M0 * 4 * (2 if rid else 1))
        flops = 4 * B * E * M0 * d  # ip and |c|^2 FMAs, f32 outside tensor cores
        bms, by = bound_ms(nbytes, flops, F32_FLOPS)
        return {"entry": entry, "max_abs_err": err, "ms": ms, "was_ms": was_ms,
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": lib_ms}

    for name in ("B1", "B3"):
        blk = blocks if name == "B1" else blocks[:, :M0].contiguous()
        # both widths the paths give the kernel: expand=4 (path 1, ef=256)
        # and expand=8 (path 2, k=100); the row's own numbers are expand=4's
        by_E = {E: at_width(name, blk, E) for E in CODEC_EXPANDS}
        rows.append({"name": name, "route": "cuda",
                     "source": "hnsw_tpu_torch/csrc/codec_scores.cu",
                     "replaces": ("hnsw_tpu/ops/pallas_scores.py:154" if name == "B1"
                                  else "hnsw_tpu/ops/pallas_scores.py:93"),
                     "counter": "codec_scores_ids" if name == "B1" else "codec_scores",
                     **by_E[CODEC_EXPANDS[0]],
                     "shape": {"B": B, "E": CODEC_EXPANDS[0], "M0": M0,
                               "id_rows": blk.shape[1] - M0, "d": d,
                               "table": "built index" if codec is not None
                               else "random"},
                     "shapes_checked": {"E": list(CODEC_EXPANDS)},
                     **{f"E{E}": by_E[E] for E in CODEC_EXPANDS[1:]}})
        del blk
    rows[0]["ragged_checked"] = codec_ragged(torch, cs, failures)
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "rows": rows, "failures": failures})
    return rows, failures


# (d, M0, id rows, E): d=48 is three 16-byte words (two lanes per row, two words
# in one of them), d=1024 two words in each of 32 lanes, d=16 one lane per
# row, d=40 no whole word ("rows" only); M0=12 and 5 need 48 and 20 id bytes
# (a multiple of 16 and not), M0=10 needs 40, rounded up to the 48 the id row
# holds; M0=100 at d=128 takes two passes of the block's warps, the second
# partly idle; 0 id rows is B3.
RAGGED_CODECS = ((48, 12, 1, 1), (48, 10, 1, 3), (48, 12, 0, 3), (40, 12, 2, 1),
                 (40, 12, 0, 3), (16, 12, 3, 3), (1024, 5, 1, 1), (1024, 5, 0, 3),
                 (128, 100, 4, 2), (256, 20, 1, 2))
RAGGED_GATHERED = ((48, 7), (40, 7), (16, 33), (1024, 37))  # (d, K)


def codec_ragged(torch, cs, failures):
    """B1, B3 and B4 at ragged shapes (B=5 queries, a 37-block table whose last
    block is among the nodes) against their plain versions, the three forms,
    through every entry that takes the shape; an entry named for a shape it
    does not take must raise. Returns the cases checked."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    B, cap1, checked = 5, 37, []
    scale = torch.tensor(0.05, dtype=torch.float32, device=dev)

    def forms(q):
        qsq = (q * q).sum(1, keepdim=True)
        return (("l2", qsq), ("dot", qsq), ("cosine", torch.sqrt(qsq)))

    for d, M0, rid, E in RAGGED_CODECS:
        blocks = torch.as_tensor(rng.integers(-127, 128, (cap1, M0 + rid, d)).astype(np.int8),
                                 device=dev)
        q = torch.as_tensor(rng.standard_normal((B, d)).astype(np.float32), device=dev)
        src_np = rng.integers(0, cap1, (B, E)).astype(np.int32)
        src_np[0, 0] = cap1 - 1
        src = torch.as_tensor(src_np, device=dev)
        label = f"d={d} M0={M0} id_rows={rid} E={E}"
        entries = list(dict.fromkeys((cs.codec_entry(d, M0, rid), "rows")))
        for form, qsn in forms(q):
            sp, ip_ = cs.codec_scores_plain(src, q, qsn, scale, blocks, M0, form)
            for ent in entries:
                sk, ik = cs.codec_scores(src, q, qsn, scale, blocks, M0, form, entry=ent)
                torch.cuda.synchronize()
                if not close(sk, sp, B1_RTOL, B1_ATOL):
                    failures.append(f"ragged {label} {form} {ent}: scores beyond tolerance")
                if (ik is None) != (ip_ is None) or (ik is not None and not torch.equal(ik, ip_)):
                    failures.append(f"ragged {label} {form} {ent}: ids differ")
        if "bulk" not in entries:
            try:
                cs.codec_scores(src, q, forms(q)[0][1], scale, blocks, M0, "l2", entry="bulk")
                failures.append(f"ragged {label}: the bulk entry took a shape it cannot")
            except RuntimeError:
                pass
        checked.append({"kernel": "B1" if rid else "B3", "d": d, "M0": M0, "id_rows": rid,
                        "E": E, "B": B, "entries": entries})
    for d, K in RAGGED_GATHERED:
        q = torch.as_tensor(rng.standard_normal((B, d)).astype(np.float32), device=dev)
        blk = torch.as_tensor(rng.integers(-127, 128, (B, K * d)).astype(np.int8), device=dev)
        csq = (blk.reshape(B, K, d).float() ** 2).sum(-1) * (scale * scale)
        entries = list(dict.fromkeys((cs.gathered_entry(d), "rows")))
        for form, qsn in forms(q):
            sp = cs.codec_scores_gathered_plain(q, blk, csq, qsn, scale, form)
            for ent in entries:
                sk = cs.codec_scores_gathered(q, blk, csq, qsn, scale, form, entry=ent)
                torch.cuda.synchronize()
                if not close(sk, sp, B1_RTOL, B1_ATOL):
                    failures.append(f"ragged B4 d={d} K={K} {form} {ent}: scores beyond tolerance")
        checked.append({"kernel": "B4", "d": d, "K": K, "B": B, "entries": entries})
    return checked


def gathered_rows(torch, Q, seed, codec, n):
    """B4 against its plain version on the card, on blocks and ``blocks_sq``
    gathered from the built codec as ``scores_codec(allow_fused=False)``
    gathers them: B=16384, K = E * M0."""
    from hnsw_tpu_torch.ops import codec_scores as cs

    dev = torch.device("cuda")
    failures = []
    B, E, d, M0 = 16384, 4, Q.shape[1], codec.M0
    K = E * M0
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    src = torch.randint(0, n, (B, E), generator=g, device=dev).long()
    q = torch.as_tensor(Q[:B], device=dev)
    qsq = (q * q).sum(1, keepdim=True)

    def gather():
        return (codec.blocks[src, :M0].reshape(B, K * d),
                codec.blocks_sq[src].reshape(B, K))
    blk, csq = gather()
    entry = cs.gathered_entry(d)
    err = 0.0
    for form in ("l2", "dot", "cosine"):
        qsn = qsq if form == "l2" else torch.sqrt(qsq)
        sp = cs.codec_scores_gathered_plain(q, blk, csq, qsn, codec.scale, form)
        for ent in dict.fromkeys((entry, "rows")):
            sk = cs.codec_scores_gathered(q, blk, csq, qsn, codec.scale, form, entry=ent)
            torch.cuda.synchronize()
            if ent == entry:
                err = max(err, float((sk - sp).abs().max()))
            if not close(sk, sp, B1_RTOL, B1_ATOL):
                failures.append(f"B4 {form} {ent}: scores beyond tolerance")
    ms, was_ms = cuda_ms_turns(
        torch, [lambda: cs.codec_scores_gathered(q, blk, csq, qsq, codec.scale, "l2"),
                lambda: cs.codec_scores_gathered(q, blk, csq, qsq, codec.scale, "l2",
                                                 entry="rows")], rounds=7, warmup=2)
    plain_ms = cuda_ms(torch, lambda: cs.codec_scores_gathered_plain(
        q, blk, csq, qsq, codec.scale, "l2"))

    def library():
        ip = torch.einsum("bd,bkd->bk", q, blk.reshape(B, K, d).float()) * codec.scale
        return torch.sqrt(torch.clamp_min(qsq - 2.0 * ip + csq, 0.0))
    lib_ms = cuda_ms(torch, library)
    gather_ms = cuda_ms(torch, gather)
    nbytes = B * K * d + 2 * B * K * 4 + B * d * 4 + B * 4
    bms, by = bound_ms(nbytes, 2 * B * K * d, F32_FLOPS)
    row = {"name": "B4", "route": "cuda",
           "source": "hnsw_tpu_torch/csrc/codec_scores_gathered.cu",
           "replaces": "hnsw_tpu/ops/pallas_scores.py:28",
           "counter": "codec_scores_gathered", "entry": entry,
           "max_abs_err": err, "ms": ms, "was_ms": was_ms, "plain_ms": plain_ms,
           "bound_ms": bms,
           "bound_by": by, "library_ms": lib_ms, "torch_gather_ms": gather_ms,
           "shape": {"B": B, "K": K, "d": d, "table": "built index"}}
    del blk, csq
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "rows": [row], "failures": failures})
    return [row], failures


def cuda_ms_queued(torch, fn, n=20):
    """Milliseconds per call of ``n`` calls queued back to back between two
    CUDA events: the card never waits for the host, and the inputs stay in L2
    as far as they fit."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def compare_scans(torch, st, kernel_lib, qs, Xs, xsq, acc, label, want_entry, failures):
    """Both scans' raw outputs against their plain versions on one input:
    B2's loc bits and decoded distances (against one quantum of the packed
    value plus the magnitude of the terms, ``B2_TERM_RTOL``), B5's values
    (against the terms, ``B5_TERM_RTOL``) and row ids, and which kernel entry
    ran."""
    tn, grp = st.SCAN_TN, st.SCAN_GROUP
    before = dict(kernel_lib.LAUNCHES)
    pk = st.scan_packed(qs, Xs, xsq, tn, grp, acc)
    uk, jk = st.scan_unpacked(qs, Xs, xsq, tn, grp, acc)
    torch.cuda.synchronize()
    ran = sorted(k for k, v in kernel_lib.LAUNCHES.items() if "." in k and v > before[k])
    if ran != [f"scan_topk.{want_entry}", f"scan_topk_unpacked.{want_entry}"]:
        failures.append(f"{label}: entries {ran}, expected {want_entry} for both scans")
    pp = st.scan_packed_plain(qs, Xs, xsq, tn, grp, acc)
    LB = st._geometry(Xs.shape[0], tn, grp, acc)[4]
    mask = (1 << LB) - 1
    loc_equal = float(((pk & mask) == (pp & mask)).float().mean())
    # padding rows (|x|^2 = 3e38) must stay finite and sort last on both sides
    pad = (pp & ~mask).view(torch.float32) >= 1e37
    if not torch.equal(pk[pad], pp[pad]):
        failures.append(f"{label}: B2 padding or empty cells differ")
    dvk = (pk & ~mask).view(torch.float32)
    dvp = (pp & ~mask).view(torch.float32)
    # the terms of the plain side's pick: its row from the cell and loc bits
    G, acc_eff = tn // grp, st._geometry(Xs.shape[0], tn, grp, acc)[2]
    loc = (pp & mask).to(torch.int64)
    blk = torch.arange(pp.shape[0], device=pp.device)[:, None, None]
    lane = (torch.arange(2 * G, device=pp.device) % G)[None, None, :]
    row = ((blk * acc_eff + loc // grp) * tn + (loc % grp) * G + lane).clamp_max(Xs.shape[0] - 1)
    qq = (qs.float() ** 2).sum(1)[None, :, None]
    xs_row = xsq[row]
    terms = qq + xs_row + (qq + xs_row - dvp).abs()
    # one quantum at the larger value: 2^(exponent - 150 + LB) for an f32
    e = (torch.maximum(dvk, dvp).view(torch.int32) >> 23) & 0xFF
    quantum = torch.pow(2.0, (e - 150 + LB).to(torch.float32))
    err = (dvk - dvp).abs()
    bound = quantum + B2_TERM_RTOL * terms
    scan_err = float(err[~pad].max()) if err.numel() else 0.0
    over = float((err / bound)[~pad].max()) if err.numel() else 0.0
    if over > 1.0:
        failures.append(f"{label}: B2 decoded distances off by {over:.3g} of one quantum "
                        f"plus {B2_TERM_RTOL} of their terms")
    if loc_equal < B2_LOC_EQUAL:
        failures.append(f"{label}: B2 loc bits equal on {loc_equal:.6f} of cells")
    del pk, pp, dvk, dvp, pad, loc, row, xs_row, terms, e, quantum, err, bound
    up, jp = st.scan_unpacked_plain(qs, Xs, xsq, tn, grp, acc)
    # v = |x|^2 - 2 q.x: the error's scale is that of the two terms, read off
    # the plain side's pick (2 q.x = |x|^2 - v)
    xs_pick = xsq[jp.long()]
    terms = xs_pick + (xs_pick - up).abs()
    err = (uk - up).abs()
    u_err = float(err.max())
    u_ratio = float((err / terms).max())
    if u_ratio > B5_TERM_RTOL:
        failures.append(f"{label}: B5 values off by {u_ratio:.3g} of their terms "
                        f"(> {B5_TERM_RTOL})")
    id_equal = float((jk == jp).float().mean())
    if id_equal < B5_ID_EQUAL:
        failures.append(f"{label}: B5 ids equal on {id_equal:.6f} of cells")
    return {"shape": label, "entry": want_entry, "b2_loc_equal_frac": loc_equal,
            "b2_max_abs_err": scan_err, "b2_max_err_over_bound": over,
            "b5_max_abs_err": u_err,
            "b5_max_err_over_terms": u_ratio, "b5_id_equal_frac": id_equal}


def scan_rows(torch, X, Q):
    """B2 and B5 against their plain versions on the card. The tensor-core
    entries at the path's shape (200k x 128, B=2048, bf16) and at a ragged one
    (B=2000, a 30000-row corpus whose last span is one tile short, d=64); the
    f32-FMA entry on a small f32 case with d=40. At the path's shape also the
    ids and distances after the overfetch and f32 refine, and the times, each
    kernel in turns with its one-call PyTorch yardstick."""
    from hnsw_tpu_torch.ops import kernel_lib
    from hnsw_tpu_torch.ops import scan_topk as st

    dev = torch.device("cuda")
    failures = []
    d = X.shape[1]
    Xp, xsq_np, perm = st.pad_corpus(X, tn=st.SCAN_TN)
    Xd = torch.as_tensor(Xp, device=dev)
    xsq = torch.as_tensor(xsq_np, device=dev)
    Xs = Xd.to(torch.bfloat16)
    acc = st.scan_acc(Xp.shape[0])
    Bq, k = 2048, 10
    qb = torch.as_tensor(Q[:Bq], device=dev)
    qs = qb.to(torch.bfloat16)
    tn, grp = st.SCAN_TN, st.SCAN_GROUP
    Np = Xp.shape[0]
    n_blocks = -(-(Np // tn) // acc)
    checks = [compare_scans(torch, st, kernel_lib, qs, Xs, xsq, acc,
                            f"path B={Bq} N={Np} d={d} bf16 acc={acc}", "wgmma", failures)]
    # ragged: B not a multiple of 128, 15 tiles in spans of 4 (the last holds
    # 3), d one TMA box, 720 padding rows
    rng = np.random.default_rng(7)
    Xr, xr, _ = st.pad_corpus(rng.standard_normal((30000, 64)).astype(np.float32))
    Qr = torch.as_tensor(rng.standard_normal((2000, 64)).astype(np.float32), device=dev)
    checks.append(compare_scans(
        torch, st, kernel_lib, Qr.to(torch.bfloat16),
        torch.as_tensor(Xr, device=dev).to(torch.bfloat16), torch.as_tensor(xr, device=dev),
        4, "ragged B=2000 N=30720 d=64 bf16 acc=4", "wgmma", failures))
    # f32 (full-precision contract) and a d the tensor path does not take
    Xf, xf, _ = st.pad_corpus(rng.standard_normal((9000, 40)).astype(np.float32))
    Qf = torch.as_tensor(rng.standard_normal((100, 40)).astype(np.float32), device=dev)
    checks.append(compare_scans(
        torch, st, kernel_lib, Qf, torch.as_tensor(Xf, device=dev),
        torch.as_tensor(xf, device=dev), 2, "f32 B=100 N=10240 d=40 acc=2", "simt", failures))
    del Xr, xr, Qr, Xf, xf, Qf
    at_path = checks[0]
    # after decode, overfetch and refine, as the exact engine serves
    dk, ik = st.l2_topk(qb, Xd, xsq, k, Xscan=Xs, acc=acc)
    dp, ipl = st.l2_topk(qb, Xd, xsq, k, Xscan=Xs, acc=acc, plain=True)
    torch.cuda.synchronize()
    same = (torch.sort(ik, 1).values == torch.sort(ipl, 1).values).all(1)
    frac = float(same.float().mean())
    if frac < B2_SET_EQUAL:
        failures.append(f"B2 ids set-equal on {frac:.4f} of queries")
    if not close(dk, dp, B2_RTOL, 0.0):
        failures.append("B2 distances beyond tolerance")

    def library():
        gq = torch.matmul(qs, Xs.T)
        return torch.topk(xsq[None, :] - 2.0 * gq.float(), k + 8, dim=1,
                          largest=False)
    ms, lib_ms = cuda_ms_turns(
        torch, [lambda: st.scan_packed(qs, Xs, xsq, tn, grp, acc), library])
    plain_ms = cuda_ms(torch, lambda: st.scan_packed_plain(qs, Xs, xsq, tn, grp, acc))
    flops = 2 * Bq * Np * d
    nbytes = Np * d * 2 + Np * 4 + Bq * d * 2 + n_blocks * Bq * 256 * 4
    bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
    if ms > lib_ms:
        failures.append(f"B2 {ms:.3f} ms is slower than its library call {lib_ms:.3f} ms")
    row = {"name": "B2", "route": "cuda",
           "source": "hnsw_tpu_torch/csrc/scan_topk.cu",
           "replaces": "hnsw_tpu/ops/pallas_topk.py:106",
           "counter": "scan_topk", "entry": at_path["entry"],
           "max_abs_err": at_path["b2_max_abs_err"], "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "epilogue_bound_ms": Bq * Np * B2_EPILOGUE_INSTR / CUDA_CORE_INSTR_PER_S * 1e3,
           "tflops": flops / ms / 1e9,
           "ms_back_to_back": cuda_ms_queued(
               torch, lambda: st.scan_packed(qs, Xs, xsq, tn, grp, acc)),
           "library_ms": lib_ms, "loc_equal_frac": at_path["b2_loc_equal_frac"],
           "refined_max_abs_err": float((dk - dp).abs().max()),
           "set_equal_frac": frac, "shapes_checked": checks}
    rows = [row]
    # ---- B5: the unpacked scan on the same inputs
    du, iu = st.l2_topk(qb, Xd, xsq, k, Xscan=Xs, acc=acc, packed=False)
    dup, iup = st.l2_topk(qb, Xd, xsq, k, Xscan=Xs, acc=acc, packed=False, plain=True)
    torch.cuda.synchronize()
    u_frac = float((torch.sort(iu, 1).values == torch.sort(iup, 1).values).all(1)
                   .float().mean())
    if u_frac < B2_SET_EQUAL:
        failures.append(f"B5 ids set-equal on {u_frac:.4f} of queries")
    if not close(du, dup, B2_RTOL, 0.0):
        failures.append("B5 distances beyond tolerance")
    vs_packed = float((torch.sort(iu, 1).values == torch.sort(ik, 1).values).all(1)
                      .float().mean())
    u_ms, u_lib_ms = cuda_ms_turns(
        torch, [lambda: st.scan_unpacked(qs, Xs, xsq, tn, grp, acc), library])
    u_plain_ms = cuda_ms(torch, lambda: st.scan_unpacked_plain(qs, Xs, xsq, tn, grp, acc),
                         warmup=1, iters=3)
    u_bytes = Np * d * 2 + Np * 4 + Bq * d * 2 + 2 * n_blocks * Bq * 256 * 4
    u_bms, u_by = bound_ms(u_bytes, flops, BF16_FLOPS)
    if u_ms > u_lib_ms:
        failures.append(f"B5 {u_ms:.3f} ms is slower than its library call {u_lib_ms:.3f} ms")
    rows.append({"name": "B5", "route": "cuda",
                 "source": "hnsw_tpu_torch/csrc/scan_topk_unpacked.cu",
                 "replaces": "hnsw_tpu/ops/pallas_topk.py:38",
                 "counter": "scan_topk_unpacked", "entry": at_path["entry"],
                 "max_abs_err": at_path["b5_max_abs_err"],
                 "max_err_over_terms": at_path["b5_max_err_over_terms"],
                 "ms": u_ms, "plain_ms": u_plain_ms,
                 "bound_ms": u_bms, "bound_by": u_by,
                 "epilogue_bound_ms": Bq * Np * B5_EPILOGUE_INSTR / CUDA_CORE_INSTR_PER_S * 1e3,
                 "tflops": flops / u_ms / 1e9,
                 "ms_back_to_back": cuda_ms_queued(
                     torch, lambda: st.scan_unpacked(qs, Xs, xsq, tn, grp, acc)),
                 "library_ms": u_lib_ms, "id_equal_frac": at_path["b5_id_equal_frac"],
                 "refined_max_abs_err": float((du - dup).abs().max()),
                 "set_equal_frac": u_frac, "set_equal_packed_frac": vs_packed})
    emit({"phase": "kernels", "rows": rows, "failures": failures})
    return rows, failures


def recall_fp64(X, Q, kth, origin_ids, k=10):
    """bench.py's recall scoring: the returned candidates' distances are
    recomputed in fp64 and compared with the fp64 k-th distance, with a
    relative 1e-6 margin for the two evaluation orders."""
    nq = len(kth)
    ok = origin_ids[:nq] >= 0
    safe = np.clip(origin_ids[:nq], 0, len(X) - 1)
    hits = 0
    for b in range(nq):
        dv = X[safe[b]].astype(np.float64) - Q[b].astype(np.float64)
        d64 = np.sqrt((dv * dv).sum(-1))
        hits += int((ok[b] & (d64 <= kth[b] * (1.0 + 1e-6) + 1e-12)).sum())
    return hits / (nq * k)


def phase_build(torch, X):
    from hnsw_tpu_torch import Hnsw, PROFILER

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PROFILER.reset()
    t0 = time.time()
    h = Hnsw(max_nb_connection=24, max_elements=len(X), ef_construction=400,
             dist="L2", device="cuda")
    h.set_keeping_pruned(True)
    h.modify_level_scale(0.5)
    h.parallel_insert(X, mode="device", batch_size=16384, build_max_iters=96)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    emit({"phase": "build", "n": len(X), "d": X.shape[1], "build_s": build_s,
          "points_per_s": len(X) / build_s, "repair": h._repair_stats,
          "layer0_width": int(h._layers[0].width),
          "max_level": h.get_max_level_observed(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "spans": PROFILER.report()})
    return h


def kth_fp64(bf, X, Q, nq, k, pool):
    """fp64 k-th neighbour distance of the first ``nq`` queries: a top-``pool``
    candidate set from the exact engine, refined on the host."""
    pool_ids, _ = bf.search_batch(Q[:nq], pool)
    kth = np.empty(nq)
    for b in range(nq):
        dv = X[pool_ids[b]].astype(np.float64) - Q[b].astype(np.float64)
        kth[b] = np.sqrt(np.partition((dv * dv).sum(-1), k - 1)[k - 1])
    return kth


def phase_gt(torch, X, Q, k=10):
    from hnsw_tpu_torch import BruteForceIndex

    nq_gt, pool = min(len(Q), 4096), max(64, 4 * k)
    bf = BruteForceIndex(dist="L2", device="cuda")
    bf.parallel_insert(X)
    if not bf._use_scan():
        raise RuntimeError("the exact engine must take the scan (kernel B2) here")
    t0 = time.time()
    kth = kth_fp64(bf, X, Q, nq_gt, k, pool)
    gt_s = time.time() - t0
    ids_bf, _ = bf.search_batch(Q, k)  # all queries; recall scores the first nq_gt
    torch.cuda.synchronize()
    t0 = time.time()
    bf.search_batch(Q, k)
    scan_s = time.time() - t0
    recall = recall_fp64(X, Q, kth, ids_bf, k)
    emit({"phase": "gt", "nq": nq_gt, "pool": pool, "pool_s": gt_s,
          "exact_recall_at_10": recall, "exact_qps": len(Q) / scan_s,
          "exact_queries": len(Q)})
    return kth, recall, bf


def phase_serve(torch, h, X, Q, kth, k=10):
    from hnsw_tpu_torch.ops import kernel_lib
    from hnsw_tpu_torch.ops.beam_search import device_search_stream

    codec = h.device_codec()
    g = h.device_graph()
    if codec is None or codec.id_rows == 0 or g.pivot_ids is None:
        raise RuntimeError("the 200k index must serve through the int8 id-row codec "
                           "(kernel B1) from the pivot entry")
    out = {}
    Qs = np.concatenate([Q, Q])
    for ef in (32, 64, 96):
        b1_before = kernel_lib.LAUNCHES["codec_scores_ids"]
        ids, _ = device_search_stream(h, Q, k, ef, batch=16384, expand=4)
        b1_batch = kernel_lib.LAUNCHES["codec_scores_ids"] - b1_before
        oid = np.where(ids >= 0, h._origin[np.clip(ids, 0, h._nb_point - 1)], -1)
        r = recall_fp64(X, Q, kth, oid, k)
        torch.cuda.synchronize()
        t0 = time.time()
        device_search_stream(h, Qs, k, ef, batch=16384, expand=4)
        qps = len(Qs) / (time.time() - t0)
        out[ef] = {"recall_at_10": r, "qps": qps, "b1_launches_per_batch": b1_batch}
    emit({"phase": "serve", "batch": 16384, "expand": 4, "codec_M0": codec.M0,
          "codec_id_rows": codec.id_rows, "pivots": int(g.pivot_ids.numel()),
          "stream_queries": len(Qs), "by_ef": out})
    return out


def index_differences(h, r, layer_order: bool):
    """What differs between the built index ``h`` and a reload ``r``: origin
    ids, levels, ranks, entry, vectors, and every layer's width, counts, ids
    and dists. An ``.npz`` reload keeps the rows where they were and compares
    array for array. A reference-format reload stores points in layer order
    (``layer_order``): row k of ``r`` is row ``order[k]`` of ``h``; there the
    per-point tables compare through ``order``, each layer's dists as sorted
    rows, and ``check_graph_equality`` pairs every neighbour id with its
    distance through the points' (layer, rank) names."""
    n = h._nb_point
    if r._nb_point != n:
        return [f"{r._nb_point} points != {n}"]
    order = h._iteration_order() if layer_order else np.arange(n)
    bad = [name for name in ("_origin", "_level", "_rank_in_layer")
           if not np.array_equal(getattr(r, name)[:n], getattr(h, name)[order])]
    if not np.array_equal(np.asarray(r._data[:n]), h._data[order]):
        bad.append("vectors")
    live = {l for l, t in h._layers.items() if t.counts[:n].any()}
    if live != {l for l, t in r._layers.items() if t.counts[:n].any()}:
        return bad + ["layers"]
    for l in sorted(live):
        a, b = h._layers[l], r._layers[l]
        if a.width != b.width:
            bad.append(f"layer {l} width {b.width} != {a.width}")
            continue
        tables = [("counts", a.counts[order], b.counts[:n]),
                  ("dists", np.sort(a.dists[order], 1), np.sort(b.dists[:n], 1))]
        if not layer_order:
            tables += [("ids", a.ids[:n], b.ids[:n]), ("dists in place", a.dists[:n], b.dists[:n])]
        bad += [f"layer {l} {what}" for what, x, y in tables if not np.array_equal(x, y)]
    if layer_order:
        if not h.check_graph_equality(r):
            bad.append("graph (check_graph_equality)")
    elif r._entry != h._entry:
        bad.append("entry")
    return bad


def phase_persist(torch, h):
    """Dump the built index both ways and reload both onto the card."""
    from hnsw_tpu_torch import HnswIo, load_native

    failures = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        npz = os.path.join(tmp, "smoke.npz")
        t = [time.time()]
        h.save_native(npz)
        t.append(time.time())
        h2 = load_native(npz)
        t.append(time.time())
        base = h.file_dump(tmp, "smoke")
        t.append(time.time())
        h3 = HnswIo(tmp, base).load_hnsw()
        t.append(time.time())
        sizes = {os.path.basename(p): os.path.getsize(p)
                 for p in (npz, os.path.join(tmp, base + ".hnsw.graph"),
                           os.path.join(tmp, base + ".hnsw.data"))}
    t.append(time.time())
    for name, r, layer_order in (("load_native", h2, False), ("load_hnsw", h3, True)):
        if r.device.type != "cuda":
            failures.append(f"{name}: reloaded onto {r.device}, not the card")
        failures += [f"{name}: {d} differs from the built index"
                     for d in index_differences(h, r, layer_order)]
    compare_s = time.time() - t[5]
    emit({"phase": "persist", "n": h._nb_point,
          "layer0_width": {"built": int(h._layers[0].width),
                           "npz": int(h2._layers[0].width),
                           "dump": int(h3._layers[0].width)},
          "save_native_s": t[1] - t[0], "load_native_s": t[2] - t[1],
          "file_dump_s": t[3] - t[2], "load_hnsw_s": t[4] - t[3],
          "compare_s": compare_s,
          "bytes": sizes, "failures": failures})
    return h2, h3, failures


def phase_serve2(torch, h, h2, bf, X, Q, kth10):
    """Recall-critical serving from the reloaded index ``h2``."""
    from hnsw_tpu_torch.ops import kernel_lib
    from hnsw_tpu_torch.ops.beam_search import device_search_stream
    from hnsw_tpu_torch.ops.scan_topk import SCAN_GROUP, SCAN_TN, l2_topk_stream

    failures = []
    Qs = np.concatenate([Q, Q])
    nq_gt = len(kth10)

    def oids(hh, ids):
        return np.where(ids >= 0, hh._origin[np.clip(ids, 0, hh._nb_point - 1)], -1)

    def stream_qps(hh, k, ef, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        device_search_stream(hh, Qs, k, ef, batch=16384, **kw)
        return len(Qs) / (time.time() - t0)

    # (a) k=100 through the pool reservoir
    kth100 = kth_fp64(bf, X, Q, nq_gt, 100, 400)
    kw = dict(expand=8, pool=256)
    ids_h, _ = device_search_stream(h, Q, 100, 192, batch=16384, **kw)
    ids_h2, _ = device_search_stream(h2, Q, 100, 192, batch=16384, **kw)
    if not np.array_equal(ids_h, ids_h2):
        failures.append("k=100: the reloaded index answers differently from the built one")
    r100 = recall_fp64(X, Q, kth100, oids(h2, ids_h2), 100)
    if r100 < RECALL_K100:
        failures.append(f"recall@100 at ef=192 pool=256 {r100:.4f} < {RECALL_K100}")
    out = {"k100": {"ef": 192, "expand": 8, "pool": 256, "recall_at_100": r100,
                    "ids_equal_built": bool(np.array_equal(ids_h, ids_h2)),
                    "qps": stream_qps(h2, 100, 192, **kw)}}
    # (b) ef=256 through the unfused (B4) and the fused (B1) codec scores
    for name, fused, counter in (("unfused", False, "codec_scores_gathered"),
                                 ("fused", True, "codec_scores_ids")):
        before = kernel_lib.LAUNCHES[counter]
        torch.cuda.synchronize()
        t0 = time.time()
        ids, _ = device_search_stream(h2, Q, 10, 256, batch=16384, expand=4,
                                      allow_fused=fused)
        batch_ms = (time.time() - t0) * 1e3
        iters = kernel_lib.LAUNCHES[counter] - before
        out[name] = {"ef": 256, "expand": 4,
                     "recall_at_10": recall_fp64(X, Q, kth10, oids(h2, ids), 10),
                     "launches_per_batch": iters, "batch_ms": batch_ms,
                     "ms_per_iteration": batch_ms / max(iters, 1),
                     "qps": stream_qps(h2, 10, 256, expand=4, allow_fused=fused)}
    if out["unfused"]["recall_at_10"] < RECALL_EF256:
        failures.append(f"unfused recall@10 at ef=256 {out['unfused']['recall_at_10']:.4f} "
                        f"< {RECALL_EF256}")
    if abs(out["unfused"]["recall_at_10"] - out["fused"]["recall_at_10"]) > FUSED_UNFUSED_GAP:
        failures.append("fused and unfused recall@10 at ef=256 differ by more than "
                        f"{FUSED_UNFUSED_GAP}")
    if not 0 < out["unfused"]["launches_per_batch"] <= MAX_ITERS_EF256:
        failures.append(f"B4 launches per batch {out['unfused']['launches_per_batch']} "
                        f"outside (0, {MAX_ITERS_EF256}]")
    # (c) exact k=100, unpacked (B5) against packed (B2), on the exact
    # engine's padded corpus
    Xd, xsq, Xscan, perm, acc = bf._scan_device()
    nq = 4096
    exact = {}
    for name, packed in (("unpacked", False), ("packed", True)):
        kw = dict(tn=SCAN_TN, group=SCAN_GROUP, Xscan=Xscan, acc=acc,
                  overfetch=bf.SCAN_OVERFETCH, batch=2048, packed=packed)
        _, idx = l2_topk_stream(Q[:nq], Xd, xsq, 100, **kw)
        torch.cuda.synchronize()
        t0 = time.time()
        l2_topk_stream(Q[:nq], Xd, xsq, 100, **kw)
        qps = nq / (time.time() - t0)
        exact[name] = (idx, qps)
    same = float((np.sort(exact["unpacked"][0], 1) == np.sort(exact["packed"][0], 1))
                 .all(1).mean())
    r_exact = recall_fp64(X, Q, kth100, bf._ids[perm[exact["unpacked"][0]]], 100)
    if same < B2_SET_EQUAL:
        failures.append(f"exact k=100: unpacked and packed ids set-equal on {same:.4f}")
    if r_exact < RECALL_EXACT:
        failures.append(f"exact k=100 unpacked recall@100 {r_exact:.4f} < {RECALL_EXACT}")
    out["exact_k100"] = {"queries": nq, "set_equal_frac": same,
                         "unpacked_recall_at_100": r_exact,
                         "unpacked_qps": exact["unpacked"][1],
                         "packed_qps": exact["packed"][1]}
    emit({"phase": "serve2", "batch": 16384, "stream_queries": len(Qs), **out,
          "failures": failures})
    return out, failures


# ------------------------------------------------------------------ path 3 ----

RECALL_HAMMING_EF128 = 0.90  # 200k x 256-bit codes, recall@10 at ef=128
RECALL_SMALL_EF64 = 0.95     # each 20k metric, recall@10 at ef=64
SCORES_RTOL = 1e-3           # f32 torch scores against the fp64 oracle (64 x 256)
HAMMING_BITS = 256
PROJ_SEED = 0x5EED           # the fixed 128 -> 256 sign projection


def hamming_codes(X, Q):
    """ann-benchmarks' sift-256-hamming construction: the sign bits of a fixed
    random projection of the corpus to 256 dimensions, as 0/1 uint8 codes."""
    P = np.random.default_rng(PROJ_SEED).standard_normal(
        (X.shape[1], HAMMING_BITS)).astype(np.float32)
    return (X @ P > 0).astype(np.uint8), (Q @ P > 0).astype(np.uint8)


def packed_words(codes):
    """0/1 codes -> int64 words holding 32 bits each (nonnegative, so the
    shifts of ``popcount_words`` never see a sign bit)."""
    return np.packbits(codes, axis=1).view(np.uint32).astype(np.int64)


def popcount_words(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_truth(torch, xw, qw, ids, k=10, chunk=64):
    """Exact bit counts by XOR + popcount of the packed codes on the card
    (independent of ``scores_hamming``): each query's k-th count over the
    whole corpus, and the counts of the returned ids (-1: no answer)."""
    X = torch.as_tensor(xw, device="cuda")
    Qw = torch.as_tensor(qw, device="cuda")
    kth = []
    for s in range(0, len(qw), chunk):
        cnt = popcount_words(torch.bitwise_xor(Qw[s:s + chunk, None, :], X[None])).sum(-1)
        kth.append(torch.kthvalue(cnt, k, dim=1).values)
    kth = torch.cat(kth)
    it = torch.as_tensor(np.clip(ids, 0, len(xw) - 1), device="cuda")
    got = popcount_words(torch.bitwise_xor(Qw[:, None, :], X[it])).sum(-1)
    return kth.cpu().numpy(), got.cpu().numpy()


def stream_timed(torch, h, Q, k, ef, batch, **kw):
    """(ids as origin ids, QPS of a second identical call)."""
    from hnsw_tpu_torch.ops.beam_search import device_search_stream

    ids, _ = device_search_stream(h, Q, k, ef, batch=batch, **kw)
    torch.cuda.synchronize()
    t0 = time.time()
    device_search_stream(h, Q, k, ef, batch=batch, **kw)
    qps = len(Q) / (time.time() - t0)
    return np.where(ids >= 0, h._origin[np.clip(ids, 0, h._nb_point - 1)], -1), qps


def phase_hamming(torch, X, Q, failures, nq=4096, k=10):
    """Hamming at full size: 200k 256-bit codes, built and served on the card."""
    from hnsw_tpu_torch import Hnsw, get_metric

    codes, qcodes = hamming_codes(X, Q[:nq])
    torch.cuda.synchronize()
    t0 = time.time()
    h = Hnsw(max_nb_connection=24, max_elements=len(codes), ef_construction=400,
             dist="Hamming", dtype=np.uint8, device="cuda")
    h.set_keeping_pruned(True)
    h.modify_level_scale(0.5)
    h.parallel_insert(codes, mode="device", batch_size=16384, build_max_iters=96)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    if h.device.type != "cuda" or h.device_codec() is not None:
        failures.append("hamming: the index must serve on the card without the codec")
    xw, qw = packed_words(codes), packed_words(qcodes)
    by_ef = {}
    for ef in (64, 128):
        oid, qps = stream_timed(torch, h, qcodes, k, ef, batch=nq)
        kth, got = hamming_truth(torch, xw, qw, oid, k)
        recall = float(((oid >= 0) & (got <= kth[:, None])).sum() / (nq * k))
        by_ef[ef] = {"recall_at_10": recall, "qps": qps}
    if by_ef[128]["recall_at_10"] < RECALL_HAMMING_EF128:
        failures.append(f"hamming recall@10 at ef=128 {by_ef[128]['recall_at_10']:.4f} "
                        f"< {RECALL_HAMMING_EF128}")
    m = get_metric("Hamming")
    got = m.scores(torch.as_tensor(qcodes[:64].astype(np.float32), device="cuda"),
                   torch.as_tensor(codes[:256].astype(np.float32),
                                   device="cuda")[None].expand(64, 256, -1))
    exact = bool(np.array_equal(got.cpu().numpy(), m.np_batch(qcodes[:64], codes[:256])))
    if not exact:
        failures.append("hamming: scores on the card differ from the numpy oracle")
    return {"n": len(codes), "bits": HAMMING_BITS, "queries": nq, "build_s": build_s,
            "repair": h._repair_stats, "by_ef": by_ef, "scores_equal_oracle": exact}, h, qcodes


def _softmax(A):
    e = np.exp(A - A.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


def _words(rng, m, width=12):
    """Zero-padded uint16 words of 3-12 letters from a-z."""
    L = rng.integers(3, width + 1, m)
    letters = rng.integers(ord("a"), ord("z") + 1, (m, width)).astype(np.uint16)
    return np.where(np.arange(width)[None] < L[:, None], letters, 0).astype(np.uint16)


def _misspellings(rng, base, m, width=12):
    """``m`` misspellings of random words of ``base``: one or two random
    edits (substitute, insert or delete a letter), lengths kept in 3-12, as a
    spelling corrector's index holds them. Uniform random strings are all
    about equally far apart, which gives a graph little to route by: the JAX
    package's build of such a set answers with the port's ids
    (``tests/test_torch_levenshtein_recall.py``), below the gate at 20k."""
    out = np.zeros((m, width), np.uint16)
    for r, b in enumerate(rng.integers(0, len(base), m)):
        w = list(base[b][base[b] != 0])
        for _ in range(int(rng.integers(1, 3))):
            op = int(rng.integers(0, 3))
            op = 0 if (op == 1 and len(w) == width) or (op == 2 and len(w) == 3) else op
            pos = int(rng.integers(0, len(w) + (op == 1)))
            c = int(rng.integers(ord("a"), ord("z") + 1))
            if op == 0:
                w[min(pos, len(w) - 1)] = c
            elif op == 1:
                w.insert(pos, c)
            else:
                del w[min(pos, len(w) - 1)]
        out[r, :len(w)] = w
    return out


_W16 = (1.0 + np.arange(16, dtype=np.float32) / 16)


def _wl2_pair(a, b):
    diff = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float((_W16 * diff * diff).sum())


def _wl2_scores(q, C):
    import torch
    w = torch.as_tensor(_W16, device=q.device)
    diff = q[:, None, :].float() - C.float()
    return (w * diff * diff).sum(-1)


def _wl2_matmul(q, X, x_sqnorms=None):
    import torch
    w = torch.as_tensor(_W16, device=q.device)
    qf, Xf = q.float(), X.float()
    g = qf @ (w * Xf).T
    return torch.clamp_min((w * qf * qf).sum(-1)[:, None] - 2.0 * g
                           + (w * Xf * Xf).sum(-1)[None, :], 0.0)


def small_sets(X, Q, seed, n=20000, nq=1024):
    """(metric, corpus, queries) of path 3's small metrics."""
    from hnsw_tpu_torch import UserMetric

    P, PQ = _softmax(X[:n, :64]), _softmax(Q[:nq, :64])
    rng = np.random.default_rng(seed + 7)
    user = UserMetric(_wl2_pair, name="WeightedL2", scores=_wl2_scores,
                      matmul_scores=_wl2_matmul)
    sets = [(name, P, PQ) for name in ("Jaccard", "Hellinger", "Jeffreys",
                                        "JensenShannon", "L1")]
    base = _words(rng, n // 10)
    sets.append(("Levenshtein", _misspellings(rng, base, n), _misspellings(rng, base, nq)))
    sets.append((user, np.ascontiguousarray(X[:n, :16]), np.ascontiguousarray(Q[:nq, :16])))
    return sets


def exact_kth(torch, m, Xs, Qs, k=10, pool=64):
    """fp64 k-th distance per query: a top-``pool`` set from the metric's torch
    scores over the whole corpus (query chunks on the card), refined by the
    numpy oracle on the host."""
    Xd = torch.as_tensor(Xs.astype(np.float32), device="cuda")
    N, d = Xd.shape
    step = max(1, (1 << 26) // (N * d))
    pools = []
    for s in range(0, len(Qs), step):
        q = torch.as_tensor(Qs[s:s + step].astype(np.float32), device="cuda")
        sc = m.scores(q, Xd[None].expand(q.shape[0], N, d))
        pools.append(torch.topk(sc, pool, dim=1, largest=False).indices.cpu().numpy())
    pools = np.concatenate(pools)
    return np.array([np.sort(m.np_batch(Qs[b], Xs[pools[b]]))[k - 1]
                     for b in range(len(Qs))])


def recall_oracle(m, Xs, Qs, kth, oid, k=10):
    hits = 0
    for b in range(len(Qs)):
        ok = oid[b] >= 0
        d64 = m.np_batch(Qs[b], Xs[np.clip(oid[b], 0, len(Xs) - 1)])
        hits += int((ok & (d64 <= kth[b] * (1.0 + 1e-6) + 1e-12)).sum())
    return hits / (len(Qs) * k)


def phase_small_metrics(torch, X, Q, seed, failures, k=10):
    from hnsw_tpu_torch import Hnsw, get_metric

    out = {}
    for dist, Xs, Qs in small_sets(X, Q, seed):
        m = get_metric(dist)
        torch.cuda.synchronize()
        t0 = time.time()
        h = Hnsw(max_nb_connection=16, max_elements=len(Xs), ef_construction=100,
                 dist=m, dtype=Xs.dtype, device="cuda")
        h.parallel_insert(Xs, mode="device", batch_size=4096)
        torch.cuda.synchronize()
        build_s = time.time() - t0
        oid, qps = stream_timed(torch, h, Qs, k, 64, batch=len(Qs))
        kth = exact_kth(torch, m, Xs, Qs, k)
        recall = recall_oracle(m, Xs, Qs, kth, oid, k)
        oid64, qps64 = stream_timed(torch, h, Qs, k, 64, batch=len(Qs), max_iters=64)
        recall64 = recall_oracle(m, Xs, Qs, kth, oid64, k)
        got = m.scores(torch.as_tensor(Qs[:64].astype(np.float32), device="cuda"),
                       torch.as_tensor(Xs[:256].astype(np.float32),
                                       device="cuda")[None].expand(64, 256, -1))
        want = m.np_batch(Qs[:64], Xs[:256])
        got = got.cpu().numpy().astype(np.float64)
        rel = float((np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max())
        row = {"n": len(Xs), "d": Xs.shape[1], "build_s": build_s, "qps": qps,
               "recall_at_10": recall, "iters64": {"recall_at_10": recall64, "qps": qps64},
               "repair": h._repair_stats,
               "scores_max_rel_err": rel}
        if m.name == "Levenshtein":
            row["scores_equal_oracle"] = bool(np.array_equal(got, want))
            if not row["scores_equal_oracle"]:
                failures.append("Levenshtein: scores on the card differ from the oracle")
        elif rel > SCORES_RTOL:
            failures.append(f"{m.name}: scores max relative error {rel:.2e} > {SCORES_RTOL}")
        if recall < RECALL_SMALL_EF64:
            failures.append(f"{m.name}: recall@10 at ef=64 {recall:.4f} < {RECALL_SMALL_EF64}")
        if h.device.type != "cuda":
            failures.append(f"{m.name}: the index is not on the card")
        out[m.name] = row
    return out


def phase_metrics(torch, X, Q, seed):
    """Path 3. Returns (failures, the Hamming index, its query codes)."""
    failures = []
    ham, h, qcodes = phase_hamming(torch, X, Q, failures)
    small = phase_small_metrics(torch, X, Q, seed, failures)
    emit({"phase": "metrics", "hamming": ham, "small": small, "failures": failures})
    return failures, h, qcodes


# ------------------------------------------------------------------ path 4 ----

RECALL_IVF_NP64 = 0.97
RECALL_AUTO_COSINE = 0.95


def matmul_kth(torch, X, Q, k=10, cosine=False, pool=64, chunk=512):
    """fp64 k-th L2 (or cosine) distance per query, independent of the
    engines under test: a top-``pool`` set from a chunked f32 matmul on the
    card (TF32 off), refined on the host."""
    Xd = torch.as_tensor(X, device="cuda")
    if cosine:
        Xd = torch.nn.functional.normalize(Xd, dim=1)
    xsq = (Xd * Xd).sum(-1)
    pools = []
    for s in range(0, len(Q), chunk):
        q = torch.as_tensor(Q[s:s + chunk], device="cuda")
        if cosine:
            sc = -(torch.nn.functional.normalize(q, dim=1) @ Xd.T)
        else:
            sc = xsq[None, :] - 2.0 * (q @ Xd.T)
        pools.append(torch.topk(sc, pool, dim=1, largest=False).indices.cpu().numpy())
    pools = np.concatenate(pools)
    dist = cosine64 if cosine else l2_64
    return np.array([np.sort(dist(Q[b], X[pools[b]]))[k - 1] for b in range(len(Q))])


def l2_64(q, Xr):
    dv = Xr.astype(np.float64) - q.astype(np.float64)
    return np.sqrt((dv * dv).sum(-1))


def cosine64(q, Xr):
    q = q.astype(np.float64)
    Xr = Xr.astype(np.float64)
    return 1.0 - (Xr @ q) / (np.linalg.norm(Xr, axis=1) * np.linalg.norm(q))


def phase_ivf(torch, seed, n=1_000_000, nq=4096, k=10):
    """Path 4: IVF-Flat and AutoIndex on the 1M x 128 clustered corpus,
    scored against an fp64-refined f32 matmul. Returns (failures, (the IVF
    index, the queries), (the exact engine, corpus, queries, k-th distances))."""
    from hnsw_tpu_torch import AutoIndex, BruteForceIndex, IvfFlatIndex
    from hnsw_tpu_torch.ops import kernel_lib

    failures = []
    t0 = time.time()
    X, Q = make_dataset("clustered", np.random.default_rng(seed), n, nq, 128, 16)
    data_s = time.time() - t0
    # the truth takes no engine under test: kernel B2 is scored against it
    kth = matmul_kth(torch, X, Q, k)
    bf = BruteForceIndex(dist="L2", device="cuda")
    bf.parallel_insert(X)
    if not bf._use_scan():
        raise RuntimeError("the 1M exact engine must take the scan (kernel B2)")
    ids_bf, _ = bf.search_batch(Q, k)
    exact_recall = recall_fp64(X, Q, kth, ids_bf, k)
    # the IVF engine at its defaults
    ix = IvfFlatIndex("L2", device="cuda")
    ix.parallel_insert(X)
    torch.cuda.synchronize()
    t0 = time.time()
    ix.build()
    torch.cuda.synchronize()
    build_s = time.time() - t0
    L, cap = ix.n_lists, ix._built[6]
    by_np = {}
    for nprobe in (16, 32, 64):
        ids, _ = ix.search_batch(Q, k, nprobe=nprobe)
        torch.cuda.synchronize()
        t0 = time.time()
        ix.search_batch(Q, k, nprobe=nprobe)
        by_np[nprobe] = {"recall_at_10": recall_fp64(X, Q, kth, ids, k),
                         "qps": nq / (time.time() - t0)}
    r = [by_np[p]["recall_at_10"] for p in (16, 32, 64)]
    if not r[0] <= r[1] <= r[2]:
        failures.append(f"ivf recall@10 decreases with nprobe: {r}")
    if r[2] < RECALL_IVF_NP64:
        failures.append(f"ivf recall@10 at nprobe=64 {r[2]:.4f} < {RECALL_IVF_NP64}")
    # the pipelined stream (f16 ingest) against search_batch on the same
    # f16-rounded queries in batches of the same size
    ids_s, _ = ix.search_stream(Q, k, nprobe=32, batch=8192)
    torch.cuda.synchronize()
    t0 = time.time()
    ix.search_stream(Q, k, nprobe=32, batch=8192)
    stream_qps = nq / (time.time() - t0)
    q16 = Q.astype(np.float16).astype(np.float32)
    ids_b16, _ = ix.search_batch(q16, k, nprobe=32, chunk=8192)
    stream_equal = bool(np.array_equal(ids_s, ids_b16))
    if not stream_equal:
        failures.append("ivf search_stream ids differ from search_batch's")
    # AutoIndex: clustered L2 inside IVF_BUDGET -> the exact scan (kernel B2)
    a = AutoIndex("L2", device="cuda")
    t0 = time.time()
    a.parallel_insert(zip(X, range(n)))
    eng_l2 = a.choose_engine()
    a.build()
    auto_l2_s = time.time() - t0
    before = dict(kernel_lib.LAUNCHES)
    ids_a, _ = a.search_batch(Q, k)
    auto_b2 = {e: kernel_lib.LAUNCHES[e] - before[e] for e in ("scan_topk", "scan_topk.wgmma")}
    if auto_b2["scan_topk"] == 0 or auto_b2["scan_topk.wgmma"] != auto_b2["scan_topk"]:
        failures.append(f"AutoIndex('L2')'s search did not go through B2's wgmma entry: {auto_b2}")
    if eng_l2 != "scan" or a.engine_name != "scan":
        failures.append(f"AutoIndex('L2') chose {eng_l2!r}, not 'scan'")
    if not np.array_equal(ids_a, ids_bf):
        failures.append("AutoIndex('L2') ids differ from BruteForceIndex's")
    # AutoIndex: clustered Cosine -> IVF
    c = AutoIndex("Cosine", device="cuda")
    t0 = time.time()
    c.parallel_insert(zip(X, range(n)))
    eng_cos = c.choose_engine()
    c.build()
    auto_cos_s = time.time() - t0
    ids_c, _ = c.engine.search_batch(Q, k, nprobe=32)
    kth_c = matmul_kth(torch, X, Q, k, cosine=True)
    hits = sum(int(((ids_c[b] >= 0) & (cosine64(Q[b], X[np.clip(ids_c[b], 0, n - 1)])
                                       <= kth_c[b] * (1.0 + 1e-6) + 1e-12)).sum())
               for b in range(nq))
    r_cos = hits / (nq * k)
    if eng_cos != "ivf" or c.engine_name != "ivf":
        failures.append(f"AutoIndex('Cosine') chose {eng_cos!r}, not 'ivf'")
    if r_cos < RECALL_AUTO_COSINE:
        failures.append(f"AutoIndex('Cosine') recall@10 at nprobe=32 {r_cos:.4f} "
                        f"< {RECALL_AUTO_COSINE}")
    for name, eng in (("ivf", ix), ("auto L2", a.engine), ("auto Cosine", c.engine)):
        if eng.device.type != "cuda":
            failures.append(f"{name}: the engine is not on the card")
    emit({"phase": "ivf", "n": n, "d": 128, "queries": nq, "data_s": data_s,
          "truth": "f32 matmul top-64 on the card, refined in fp64",
          "exact_recall_at_10": exact_recall,
          "ivf": {"build_s": build_s, "lists": L, "cap": cap,
                  "padding_share": 1.0 - n / (L * cap), "by_nprobe": by_np,
                  "stream": {"nprobe": 32, "batch": 8192, "qps": stream_qps,
                             "ids_equal_search_batch": stream_equal,
                             "ids_equal_f32_batch_frac": float(
                                 (ids_s == ix.search_batch(Q, k, nprobe=32)[0]).all(1).mean())}},
          "auto_l2": {"engine": eng_l2, "insert_build_s": auto_l2_s, "b2_launches": auto_b2,
                      "ids_equal_bruteforce": bool(np.array_equal(ids_a, ids_bf))},
          "auto_cosine": {"engine": eng_cos, "insert_build_s": auto_cos_s,
                          "lists": c.engine.n_lists, "recall_at_10_nprobe32": r_cos},
          "failures": failures})
    return failures, (ix, Q), (bf, X, Q, kth)


def scan_on_clustered(torch, bf, X, Q, kth, k=10):
    """B2 against its plain version on path 4's corpus and queries at the
    shape ``BruteForceIndex`` gives it (the shuffled, padded 1M corpus in bf16,
    2048-query batches), and where the exact scan's misses come from: the
    engine's answers through the kernel and through the plain version, an f32
    scan (B2's simt entry), and a wider overfetch, each scored against the
    matmul truth. Runs after path 4's counts are read: these are comparisons.
    Returns (the raw-output check, failures)."""
    from hnsw_tpu_torch.ops import kernel_lib
    from hnsw_tpu_torch.ops import scan_topk as st

    failures = []
    Xd, xsq, Xs, perm, acc = bf._scan_device()
    Bq = 2048
    qs = torch.as_tensor(Q[:Bq], device="cuda").to(torch.bfloat16)
    check = compare_scans(torch, st, kernel_lib, qs, Xs, xsq, acc,
                          f"path 4 clustered B={Bq} N={Xd.shape[0]} d={Xd.shape[1]} "
                          f"bf16 acc={acc}", "wgmma", failures)
    del qs

    def answers(**kw):
        out = []
        for s in range(0, len(Q), Bq):
            q = torch.as_tensor(Q[s:s + Bq], device="cuda")
            out.append(st.l2_topk(q, Xd, xsq, k, acc=acc, **kw)[1].cpu().numpy())
            torch.cuda.empty_cache()
        return perm[np.clip(np.concatenate(out), 0, len(perm) - 1)]

    of = bf.SCAN_OVERFETCH
    variants = {"kernel": dict(Xscan=Xs, overfetch=of),
                "plain": dict(Xscan=Xs, overfetch=of, plain=True),
                "f32_scan": dict(Xscan=None, overfetch=of),
                "overfetch_54": dict(Xscan=Xs, overfetch=54)}
    ids = {name: answers(**kw) for name, kw in variants.items()}
    recall = {name: recall_fp64(X, Q, kth, i, k) for name, i in ids.items()}
    same = float((np.sort(ids["kernel"], 1) == np.sort(ids["plain"], 1)).all(1).mean())
    if same < B2_SET_EQUAL:
        failures.append(f"path 4: B2's answers set-equal to its plain version's on "
                        f"{same:.4f} of queries")
    emit({"phase": "ivf_scan", "check": check, "recall_at_10": recall,
          "kernel_set_equal_plain_frac": same, "overfetch": of, "failures": failures})
    return check, failures


def profiled(torch, label, fn, top=12):
    """Run ``fn`` under torch.profiler; emit device busy time by kernel and
    the device's idle share of the window's wall time. Returns a failure
    when the kernels' summed time exceeds the wall time (a double count)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # kernel-level events only: op-level rows repeat their kernels' time
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0
          and e.device_type == torch.autograd.DeviceType.CUDA]
    ev.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    emit({"phase": "profile", "window": label, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
          "top": [{"name": e.key[:80], "calls": e.count,
                   "device_ms": e.self_device_time_total / 1e3} for e in ev[:top]]})
    if busy_ms > wall_ms:
        return f"profile {label}: device busy {busy_ms:.1f} ms > wall {wall_ms:.1f} ms"
    return None


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="env,kernels,build,gt,serve,persist,serve2,metrics,ivf")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--profile", action="store_true",
                    help="after the phases, trace one served batch per operating "
                         "point and a second build with torch.profiler")
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from hnsw_tpu_torch import enable_profiling
    from hnsw_tpu_torch.ops import kernel_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    enable_profiling()
    failures = []
    card = phase_env(torch, kernel_lib)
    d, nq = 128, 16384
    X, Q = make_dataset("gauss", np.random.default_rng(args.seed), 200_000, nq, d, 16)
    rows = []
    if "kernels" in phases:
        rows, f = scan_rows(torch, X, Q)
        failures += f
    # ---- path 1: counts run from zero over build, gt and serve ----
    kernel_lib.reset_launch_counts()
    h = phase_build(torch, X) if "build" in phases else None
    kth = bf = None
    if "gt" in phases:
        kth, exact, bf = phase_gt(torch, X, Q)
        if exact < RECALL_EXACT:
            failures.append(f"exact-scan recall@10 {exact:.4f} < {RECALL_EXACT}")
    if h is not None and kth is not None and "serve" in phases:
        by_ef = phase_serve(torch, h, X, Q, kth)
        if by_ef[96]["recall_at_10"] < RECALL_EF96:
            failures.append(f"recall@10 at ef=96 {by_ef[96]['recall_at_10']:.4f} "
                            f"< {RECALL_EF96}")
    path1 = dict(kernel_lib.LAUNCHES)
    # ---- path 2: counts run from zero over persist and serve2 ----
    kernel_lib.reset_launch_counts()
    h2 = None
    if h is not None and "persist" in phases:
        h2, _, f = phase_persist(torch, h)
        failures += f
    if h2 is not None and kth is not None and "serve2" in phases:
        _, f = phase_serve2(torch, h, h2, bf, X, Q, kth)
        failures += f
    path2 = dict(kernel_lib.LAUNCHES)
    if "kernels" in phases:
        # after the paths, on the codec the serve phases read
        codec = h.device_codec() if h is not None else None
        r, f = codec_rows(torch, Q, args.seed, codec,
                          h._nb_point if h is not None else None)
        rows = r + rows
        failures += f
        if codec is not None:
            r, f = gathered_rows(torch, Q, args.seed, codec, h._nb_point)
            rows += r
            failures += f
    h2 = bf = None
    torch.cuda.empty_cache()
    # ---- path 3: every other metric, counts from zero ----
    kernel_lib.reset_launch_counts()
    ham = ivf = None
    if "metrics" in phases:
        f, *ham = phase_metrics(torch, X, Q, args.seed)
        failures += f
    path3 = dict(kernel_lib.LAUNCHES)
    torch.cuda.empty_cache()
    # ---- path 4: IVF-Flat and AutoIndex on the 1M clustered corpus ----
    kernel_lib.reset_launch_counts()
    scan4 = None
    if "ivf" in phases:
        f, ivf, scan4 = phase_ivf(torch, args.seed)
        failures += f
    path4 = dict(kernel_lib.LAUNCHES)
    if scan4 is not None:
        check, f = scan_on_clustered(torch, *scan4)
        failures += f
        for r in rows:
            if r["name"] == "B2":
                r["shapes_checked"].append(check)
    scan4 = None
    torch.cuda.empty_cache()
    if args.profile and h is not None:
        from hnsw_tpu_torch.ops.beam_search import device_search_stream
        windows = [(f"serve ef={ef} batch=16384",
                    lambda ef=ef: device_search_stream(h, Q, 10, ef, batch=16384,
                                                       expand=4))
                   for ef in (32, 64, 96)]
        windows += [(f"serve ef=256 allow_fused={fused} batch=16384",
                     lambda fused=fused: device_search_stream(
                         h, Q, 10, 256, batch=16384, expand=4, allow_fused=fused))
                    for fused in (True, False)]
        windows.append(("serve k=100 ef=192 expand=8 pool=256 batch=16384",
                        lambda: device_search_stream(h, Q, 100, 192, batch=16384,
                                                     expand=8, pool=256)))
        if "gt" in phases:
            from hnsw_tpu_torch import BruteForceIndex
            from hnsw_tpu_torch.ops.scan_topk import SCAN_GROUP, SCAN_TN, l2_topk_stream
            bf = BruteForceIndex(dist="L2", device="cuda")
            bf.parallel_insert(X)
            Xd, xsq, Xscan, _, acc = bf._scan_device()
            windows.append(("exact k=10 packed, one 2048-query batch",
                            lambda: bf.search_batch(Q[:2048], 10)))
            windows.append(("exact k=100 unpacked, one 2048-query batch",
                            lambda: l2_topk_stream(
                                Q[:2048], Xd, xsq, 100, tn=SCAN_TN, group=SCAN_GROUP,
                                Xscan=Xscan, acc=acc, overfetch=bf.SCAN_OVERFETCH,
                                batch=2048, packed=False)))
        if ham:
            hh, qc = ham
            windows.append(("hamming serve ef=128, one 4096-query batch",
                            lambda: device_search_stream(hh, qc, 10, 128, batch=len(qc))))
        if ivf:
            ix, Qc = ivf
            windows.append(("ivf search_batch nprobe=32, 4096 queries in chunks of 512",
                            lambda: ix.search_batch(Qc, 10, nprobe=32)))
            windows.append(("ivf search_stream nprobe=32, 4096 queries, f16 ingest",
                            lambda: ix.search_stream(Qc, 10, nprobe=32, batch=8192)))
        windows.append(("build (a second, traced build of the same index)",
                        lambda: phase_build(torch, X)))
        for label, fn in windows:
            f = profiled(torch, label, fn)
            if f:
                failures.append(f)
    # a kernel's launches are read on the path that drives it: B1 and B2 on
    # path 1 (and again on path 2), B4 and B5 on path 2, B2 on path 4 (the
    # AutoIndex scan and BruteForceIndex's answers); B3 is on none, path 3 on none
    ran1 = all(p in phases for p in ("build", "gt", "serve"))
    ran2 = ran1 and all(p in phases for p in ("persist", "serve2"))
    ran4 = "ivf" in phases
    paths = {"path1": path1, "path2": path2, "path3": path3, "path4": path4}
    # (ran, counts, must launch there)
    needed = {"B1": [(ran1, path1, True), (ran2, path2, False)],
              "B2": [(ran1, path1, True), (ran4, path4, True)],
              "B4": [(ran2, path2, True)], "B5": [(ran2, path2, True)]}
    for r in rows:
        c = r.pop("counter")
        r["launches_by_path"] = {p: cnt[c] for p, cnt in paths.items()}
        r["launches"] = path1[c] or path2[c] or path4[c]
        # every launch of the paths by the entry the comparison went through:
        # wgmma for the scans, bulk for B1, stream for B4
        e = f"{c}.{r['entry']}"
        r["launches_by_entry"] = {
            p: {k.split(".")[1]: v for k, v in cnt.items() if k.startswith(c + ".")}
            for p, cnt in paths.items()}
        for ran, counts, must in needed.get(r["name"], []):
            if not ran:
                continue
            if counts[c] == 0:
                if must:
                    failures.append(f"kernel {r['name']} never launched on its path")
            elif counts[e] != counts[c]:
                failures.append(f"kernel {r['name']} did not run its path through the "
                                f"{r['entry']} entry ({counts[e]} of {counts[c]} launches)")
    if ran2 and (path2["codec_scores_ids"] == 0 or path2["scan_topk"] == 0):
        failures.append("path 2 did not run B1 and B2")
    print(card, flush=True)
    emit({"kernels": rows})
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
