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
it: B1 and B2 must have run on path 1, B4, B5 (and B1, B2) on path 2, the two
scans through their tensor-core entry, B1 through "bulk" and B4 through
"stream" on every launch, and the comparison launches fall outside both
windows. The kernels line
(``{"kernels": [...]}``, all five kernels; ``launches`` is the count on the
first path that runs the kernel, ``launches_by_path`` both) and the card line
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
# packed scan, decoded: the value drops its low LB mantissa bits (2^LB ulp,
# 1.5e-5 relative at LB=7) and the two sides sum the f32 products of bf16
# inputs in different orders; the atol covers d2 near 0, where |x|^2 + |q|^2
# - 2 q.x cancels. A bf16 accumulation misses this by two orders.
B2_SCAN_RTOL, B2_SCAN_ATOL = 1e-4, 1e-4
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
    """bench.py's ``make_dataset`` ("gauss" corpus): a low-intrinsic-dimension
    gaussian through a fixed random linear map, corpus and queries on forked
    streams so X depends on (seed, n, d, intrinsic) only."""
    xrng = np.random.default_rng(rng.integers(2**63))
    qrng = np.random.default_rng(rng.integers(2**63))
    A = (rng.standard_normal((intrinsic, d)).astype(np.float32)
         / np.float32(np.sqrt(intrinsic)))  # f32 under NumPy 1 and 2 alike
    if kind != "gauss":
        raise ValueError(f"unknown dataset {kind!r}")
    Z = xrng.standard_normal((n, intrinsic), dtype=np.float32)
    Zq = qrng.standard_normal((nq, intrinsic), dtype=np.float32)
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
    B2's loc bits and decoded distances, B5's values (against the magnitude of
    the terms, ``B5_TERM_RTOL``) and row ids, and which kernel entry ran."""
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
    dvk = (pk & ~mask).view(torch.float32)[~pad]
    dvp = (pp & ~mask).view(torch.float32)[~pad]
    scan_err = float((dvk - dvp).abs().max()) if dvk.numel() else 0.0
    if not close(dvk, dvp, B2_SCAN_RTOL, B2_SCAN_ATOL):
        failures.append(f"{label}: B2 decoded distances beyond tolerance")
    if loc_equal < B2_LOC_EQUAL:
        failures.append(f"{label}: B2 loc bits equal on {loc_equal:.6f} of cells")
    del pk, pp, dvk, dvp, pad
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
            "b2_max_abs_err": scan_err, "b5_max_abs_err": u_err,
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
    ap.add_argument("--phases", default="env,kernels,build,gt,serve,persist,serve2")
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
        if bf is not None:
            from hnsw_tpu_torch.ops.scan_topk import SCAN_GROUP, SCAN_TN, l2_topk_stream
            Xd, xsq, Xscan, _, acc = bf._scan_device()
            windows.append(("exact k=10 packed, one 2048-query batch",
                            lambda: bf.search_batch(Q[:2048], 10)))
            windows.append(("exact k=100 unpacked, one 2048-query batch",
                            lambda: l2_topk_stream(
                                Q[:2048], Xd, xsq, 100, tn=SCAN_TN, group=SCAN_GROUP,
                                Xscan=Xscan, acc=acc, overfetch=bf.SCAN_OVERFETCH,
                                batch=2048, packed=False)))
        windows.append(("build (a second, traced build of the same index)",
                        lambda: phase_build(torch, X)))
        for label, fn in windows:
            f = profiled(torch, label, fn)
            if f:
                failures.append(f)
    # a kernel's launches are read on the path that drives it: B1 and B2 on
    # path 1 (and again on path 2), B4 and B5 on path 2; B3 is on neither
    ran1 = all(p in phases for p in ("build", "gt", "serve"))
    ran2 = ran1 and all(p in phases for p in ("persist", "serve2"))
    needed = {"B1": [(ran1, path1), (ran2, path2)], "B2": [(ran1, path1)],
              "B4": [(ran2, path2)], "B5": [(ran2, path2)]}
    for r in rows:
        c = r.pop("counter")
        r["launches_by_path"] = {"path1": path1[c], "path2": path2[c]}
        r["launches"] = path1[c] or path2[c]
        # every launch of the paths by the entry the comparison went through:
        # wgmma for the scans, bulk for B1, stream for B4
        e = f"{c}.{r['entry']}"
        r["launches_by_entry"] = {
            "path1": {k.split(".")[1]: v for k, v in path1.items() if k.startswith(c + ".")},
            "path2": {k.split(".")[1]: v for k, v in path2.items() if k.startswith(c + ".")}}
        for which, (ran, counts) in enumerate(needed.get(r["name"], [])):
            if not ran:
                continue
            if counts[c] == 0:
                if which == 0:
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
