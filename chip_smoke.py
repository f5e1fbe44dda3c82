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
           shape; then the ids and distances after the refine. On f32 inputs
           (the full-precision scan, entry tf32x3) at the same 200k x 128
           shape, at d = 40, 128, 784, 960 and 1536 and at a ragged shape, and
           the rows "B2 f32" and "B5 f32" there (their launches read on
           ``highd_mnist_f32``; the plain versions' f32 products with TF32
           off, as the script sets it)
  build    First the ``build_extend`` line: the widen pass
           (``set_extend_candidates(True)``) on 20k of the rows, M=8, batch
           2048, at efC 16 (every round widens) and 48 (steady rounds
           keep): each program build bit-equal to its eager build, and the
           captured widen (16) or keep (48) piece replayed (these small
           builds also take the process's first use of the card off the
           timed ones). Then Hnsw(M=24, efC=400, L2) with level scale 0.5
           and kept pruned links, ``parallel_insert(mode="device", batch_size=16384,
           build_max_iters=96)`` on the 200k x 128 gauss corpus of bench.py
           (``hnsw_tpu_torch.bench.make_dataset``, rounded to float32),
           every round through the round programs (``BuildPrograms``): the
           line holds their counts (rounds, rounds replayed, keys, captures,
           chunk graphs, capture seconds, pool bytes by part), peak device
           memory, each round's ms between synchronizes and round 20 in one
           profiler window (device busy, idle share); ``build_s`` leaves out
           the profiler's own start and stop. Gate: a round replayed, no part
           uncaptured outside the first sighting of its key. Then the
           ``build_program`` line: the eager build (``round_step``) of the
           same corpus, timed and traced the same way, its tables and
           in-degrees bit-equal to the program build's on every real row
  gt       BruteForceIndex (kernel B2) top-64 pool + fp64 host refine over
           4096 queries; exact-scan recall@10
  exact_program  the exact engine as a captured program (``ScanProgram``,
           ``ops/program.py``) on gt's BruteForceIndex, batch 2048: the k=10
           replay bit-equal to a direct ``l2_topk`` call and one B2 launch
           ("wgmma") a replay; one 2048-query batch through ``search_batch``
           against the eager form (the same pipeline with ``l2_topk`` called
           op by op): wall median of 3 in turns, device busy from one profiler
           window each, and the same for the program alone on a resident
           batch; 65,536 f32 queries streamed through ``search_batch``, both
           forms, median QPS over 3 blocks and spread; a filtered search (the
           even ids) equal to the eager one, every id passing; below the scan
           (20k rows, L2 and Cosine) the matmul route's program (``TopkProgram``)
           equal to its direct call; the pools
  codec    (with serve) the traversal codec built in row chunks: its build's
           own peak device memory against a one-shot gather's, and its blocks
           byte-equal to that gather's
  serve    device_search_stream (batch 16384, expand 4, int8 codec, pivots)
           at ef 32/64/96, k=10: recall@10 scored in fp64, streamed QPS; B1
           launches a batch read on a warmed call (the first call for a
           program key runs a warm-up before its replay)
  program  the search as one device program (``ops/program.py``, CUDA
           graphs) at ef 32/64/96 on one 16384-query batch: the replay must
           equal a direct call of the same pieces and the eager search bit for
           bit, and launch B1 once a beam iteration (10 / 18 / 26), all
           "bulk"; wall (host clock) and device busy (torch.profiler) of both
           forms in turns, and the bytes the programs' pools hold
  bench    the port's benchmark (``hnsw_tpu_torch.bench``) on the same
           index, queries and truth: its ef sweep, the exact engine and the
           chosen ef timed in 3 blocks of 0.5 s, the device-resident rate over
           4 sub-batches; its record on a line ``{"bench": {...}}`` must hold
           every key of its JSON line, recall@10 >= 0.98 (graph) and >= 0.999
           (exact), and every B1 launch through "bulk", every B2 launch
           through "wgmma"

Path 2 (dump, reload, recall-critical serving), on the index path 1 built:

  persist  ``save_native`` -> ``load_native`` (h2) and ``file_dump`` ->
           ``HnswIo.load_hnsw`` (h3), both onto the card, the dump and reload
           through the native C++ tier (``ROUTES``); origin ids, levels,
           entry, vectors and every layer's ids, dists, counts and width must
           equal the built index's (h2 array for array; h3, stored in layer
           order, through ``check_graph_equality`` and the row-sorted tables);
           a second dump by the Python route must be byte-equal; file sizes
           and the seconds of every step; then (``persist_more``) the dump's
           data file through ``DataMap`` byte-equal to the index's rows, and a
           Light dump reloaded with every layer's table equal to the Full
           reload's
  serve2   on h2: (a) k=100 through the pool reservoir (ef 192, expand 8,
           pool 256): ids identical to the built index's, recall@100 in fp64;
           (b) ef=256, k=10 with ``allow_fused=False`` (kernel B4) and
           ``True`` (B1): recall@10 of each, B4 launches per batch (on a
           warmed call); each search's program replay equal to a direct call
           of its pieces on one batch; (c) exact
           k=100 over 4096 queries with ``packed=False`` (kernel B5) against
           ``packed=True`` (B2): id sets, recall@100; streamed QPS of each;
           each one's scan program replayed against the direct call, one
           launch of its kernel ("wgmma") a replay

  kernels  B1, B3 and B4 against their plain versions on the codec the serve
           phases read (its M0 and id rows), B=16384, L2/Dot/Cosine: B1 and
           B3 at E=4 and at E=8 (the k=100 run's width), B4 at E=4, each
           through the entry the paths take ("bulk", "stream") and through
           the "rows" entry, timed in turns (``ms`` and ``was_ms``); then a
           ragged group (d = 48, 40, 16, 128, 256, 1024; M0 = 5 to 100; one
           to four id rows or none; E = 1 to 3; B = 5; the table's last block
           among the nodes) through every entry that takes the shape

  native   (after path 2's counts are read; host threads) ``NativeHnsw.from_hnsw``
           of the built index: ``parallel_search`` of 4096 queries at ef 64,
           recall@10 against path 1's truth, host QPS; ``to_hnsw()`` served
           on the card at ef 64 must answer path 1's ids on every query; a
           native build of the first 20,000 rows (M=16, efC=100) handed to the
           card and served at ef 64, recall@10 against an exact truth

Path 3 (``metrics``; every other metric, built and served on the card):

  (a) Hamming on 100k 256-bit codes (the sign bits of a fixed random 128 ->
      256 projection of the path-1 corpus: ann-benchmarks' sift-256-hamming
      construction), built as path 1 (M=24, efC=400, batch 16384), served by
      ``device_search_stream`` at ef 64 and 128 on 4096 query codes; recall@10
      against exact counts from XOR + popcount of the packed codes on the card
  (b) Jaccard, Hellinger, Jeffreys, JensenShannon and L1 on 10k x 64 softmax
      rows, Levenshtein on 10k misspellings (one or two edits) of 1k random
      zero-padded words of 3-12 letters, and a
      ``UserMetric`` (weighted L2, both torch forms) on 10k x 16; each built
      with M=16, efC=100, batch 4096, searched at ef 64 over 1024 queries;
      recall@10 against a top-64 pool of the metric's torch scores refined by
      its fp64 numpy oracle; the torch scores against the oracle on 64 x 256;
      each metric's program replay equal to a direct call of its pieces

Path 4 (``ivf``; bench.py's 1M x 128 clustered corpus): ground truth from a
chunked f32 matmul on the card refined in fp64 (no engine under test);
``BruteForceIndex`` (kernel B2) scored against it; ``IvfFlatIndex("L2")`` at its
defaults (build seconds, lists, cap, padding share; recall@10 and QPS at
nprobe 16/32/64; ``search_stream`` with f16 ingest at nprobe 32, whose ids
must equal ``search_batch``'s on the same f16-rounded queries);
``AutoIndex("L2")`` must choose the scan, launch B2 (every launch of its
search through the tensor-core entry) and answer as ``BruteForceIndex``;
``AutoIndex("Cosine")`` must choose IVF (recall@10 at nprobe 32 against exact
cosine). The IVF build's k-means steps replay ``KmeansProgram``s (one replay at
the full chunk shape held against its direct call: assignments and alternates
equal, partial sums within 1e-5 of their largest, float atomics). The IVF
search and the scan replay captured programs (``IvfProgram``,
``ScanProgram``): at nprobe 16/32/64 the 512-query program's replay must equal
a direct call of its pieces, launch one ``id_scores`` (the refine), and
``search_batch``'s ids and recall the eager form's; one 4096-query batch at nprobe 32, program against eager (wall and
busy); a filtered search equal to the eager one; ``AutoIndex("L2")``'s scan
program replay equal to its direct call, one B2 a replay; every engine's
pools, released before the next path. After path 4's counts are read, B2
against its plain version at the exact engine's shape there (the shuffled 1M
corpus in bf16, B=2048) and where
the exact scan's misses come from: the engine's recall through the kernel,
the plain version, an f32 scan and a wider overfetch.

Path 5 (``sharded``; ``ShardedHnsw`` on one card): four shards of path 1's
200k x 128 corpus on ``cuda:0`` with path 1's graph settings on every shard,
built with ``mode="mesh"`` through every shard's round programs (a round
replayed on every shard; before it, the same build of 4 x 5k rows at batch 512
held bit-equal to an eager mesh build); ``search_stream`` with the per-shard int8 codec (no
id rows: kernel B3) at ef 64 and 96 (k=10, batch 16384), ``search_batch`` on
2048 queries (ids equal to the stream's), ``exact_search_batch`` in ``auto`` mode
(the packed scan, kernel B2, on every shard) against path 1's exact engine and
in ``tiled`` mode (each shard's scan a captured program: its replay equal to
a direct call, one B2 a replay in the packed mode, B2 once a shard on a warmed
call), and the manifest dump reloaded onto the card (equal ids);
one warmed batch at ef 96 through the per-shard programs (chunked: B3
launches, wall ms, each shard's replay equal to a direct call of its pieces).
After path 5's counts are read, B3 against its plain version on shard 0's
codec at path 5's shape.

The high-d path (``highd``; it runs right after ``kernels``, before path 1,
while the card holds nothing else), five lines each with its launch counts from
zero: ``highd_mnist``, 70k x 784 rows (ann-mnist-784-euclidean's shape,
bench.py's gauss generator from the seed): ``AutoIndex("L2")`` must choose the
scan (d >= HIGH_D); ``search_batch`` of 16,384 f32 queries, recall@10 >= 0.999
against ``matmul_kth`` (a chunked f32 matmul refined in fp64), QPS median of 3
and spread; ``l2_topk_stream`` at k=100 packed (B2) and unpacked (B5),
set-equal; ``highd_graph``, the same corpus through the graph at the
reference's mnist settings (M=24, efC=400, level scale 0.5, the int8 codec: at
d=784 without id rows, the JAX codec's layout, so B3 and not B1), ef swept
until recall@10 reaches 0.999 (>= 0.98 required), streamed QPS beside the
exact engine's; ``highd_gist``, 1M x 960 rows (gist-960-euclidean's shape):
``AutoIndex("L2")`` must choose the scan, recall@10 >= 0.999 over 4096
queries, QPS. Every B2 and B5 launch takes "wgmma" (the K-looped layout at
these depths), every B1 and B3 launch "bulk". ``highd_mnist_f32`` and
``highd_gist_f32``: the same two corpora through ``BruteForceIndex`` with
``SCAN_DTYPE = None``, the full-precision first stage (at 784 k=10 over the
16,384 queries and ``l2_topk_stream`` at k=100 packed and unpacked, set-equal;
at 960 k=10 over 4096 queries): recall@10 >= 0.999 against the same fp64
truth, QPS and spread, every B2 and B5 launch through "tf32x3" (none
"simt"). With ``kernels``, after each line's counts are read, B2 and B5 at
(B=2048, 71,680 x 784) and B2 at (B=2048, 1,001,472 x 960) against their
plain versions (at 960 on 256 queries), timed as the d=128 rows, with the
f32-FMA entry's time on the same shape where its shared memory fits
("was"), in bf16 and in f32 ("B2 f32", "B5 f32": also failing where slower
than their library call, an f32 matmul with TF32 off + topk, or than the
f32-FMA entry): six more rows on the kernels line, each with its ``line``.

The later lines, each with its launch counts from zero (``launches_by_path``):

  filters       (after path 2's counts are read) path 1's index with the even
                ids and with the middle half of the ids: ``device_search_stream``
                over 4096 queries and ``Hnsw.search_filter`` over 64 at ef 96,
                no id failing the filter, recall@10 >= 0.95 against
                ``BruteForceIndex`` under the same filter, the same stream on a
                CPU copy agreeing on 99% of 256 queries (B1, B2)
  graft         ``hnsw_tpu_torch/graft_entry.py``: ``entry()``'s program replayed
                equal to the direct call (and with the int8 codec bound in: B3
                at the reference's d = 32), ``dryrun_multichip(8)`` on cuda:0 x 8
                passing every assertion, ``dryrun_multichip(4)`` stopping where
                the reference's body stops at 4 devices (B3, B2)
  build_budget  a 20k x 128 build at batch 2048 through the round programs at
                the default share, at a share between the parts' measured
                peaks (some keys captured, some not) and below every peak (none
                captured): each bit-equal to the eager build, none raising
  user_pivots   the weighted-L2 ``UserMetric`` at 40k x 16 (above
                ``PIVOT_MIN_POINTS``): entry pivots set, recall@10 >= 0.95 at ef
                64, its ``matmul_scores`` captured in the program, the replay
                equal to the direct call
  topk_gathered ``BruteForceIndex("Hellinger")`` (no matmul form: ``_bf_topk``'s
                gathered loop in a ``TopkProgram``) on 20k x 64: the replay
                equal to the direct call, recall@10 >= 0.999 against the fp64
                oracle
  bench_knobs   ``hnsw_tpu_torch.bench.main`` at 20k x 128, 4096 queries, with
                ``BENCH_BUILD=native`` and with ``BENCH_GT=host``: every key,
                recall at its floor; the host oracle's k-th distances equal to
                the pool's within 1e-6 relative (B2)

The ``cards`` phase (not in the default list: ``--phases
env,gt,sharded,graft,cards`` on a machine with four cards; asked for where
fewer than two cards are visible, the script exits 2 before any phase and
says why): ``ShardedHnsw`` with its four shards dealt over the visible cards
(``default_devices``: one a card on four, two a card on two). Its first line
(``"part": "equality"``) builds path 5's index (200k x 128, M=24, efC 400,
int8 codec) twice in one process, on cuda:0 x 4 and over the cards, and holds
bit for bit every shard's tables, in-degrees, codec blocks, squared norms and
scale, ``search_batch`` of 16384 queries at ef 64 and 96, the 65,536-query
stream at ef 96 (f16 ingest, batches of 16384), a filtered search (the even
ids), ``exact_search_batch`` at k=10 and k=100, the manifest dumps' bytes and
each dump reloaded onto the other placement; B3 and B2 must launch on every
card (``kernel_lib.CARD_LAUNCHES``, all ``bulk`` and ``wgmma``); build
seconds, stream QPS, each card's peak and one traced batch of each form. Its
second line (``"part": "scale"``) builds 4 x 1M rows of bench.py's gauss
corpus one shard a card at bench run b's settings (batch 16384): set-up,
rounds, flush, every round's wall and a steady round traced (each card's busy
time against the wall), each card's peak; streamed recall@10 and QPS at ef 64
/ 96 / 128 (f16 ingest, one 16384-query batch, median of 3) and the exact
search against a 4M fp64 truth (gates 0.97 at ef 96 and 0.999); one search
batch traced; then shard 0's 1M rows built and served alone on cuda:0 the
same way, and the ratios of the two. Every line names each card and its
power limit. ``--cards-parts equality`` (or ``scale``) runs one line alone.

Each kernels line carries median CUDA-event times of the kernel, its plain
version and a one-call PyTorch yardstick, and the bound the card allows for
the same work; the two scans also the bound of their epilogue (CUDA-core
instruction rate), the achieved TFLOP/s, the kernel entry and layout that ran
(with ptxas's registers and spills), the same shape through the f32-FMA entry
(``was_ms``) and, at d=128, through the K-looped layout (``kloop_ms``); the f32
rows their bound as three tf32 products at the TF32 rate (495 TFLOP/s) with one
pass of f32 FMAs beside it (``fma_floor_ms``), ``bound_share`` and the ring's
stages; and
their time when 20 launches are queued back to back (``ms`` is timed in turns
with the yardstick, whose 1.6 GB product evicts the corpus from L2 in between).
``--profile`` then traces one served batch per operating point, one
2048-query batch of the exact engine (packed k=10, unpacked k=100)
and a second build with torch.profiler (device time by kernel, the device's
idle share of the window); a window whose kernel time exceeds its wall time
fails the run.

The B2 and B5 rows also carry ``launches_per_replay``: the launches one replay
of each exact program counted, by path (one scan launch each, or the run fails). The launch counters are set to 0 just
before each path and read just after it: B1 and B2 must have run on path 1,
B4, B5 (and B1, B2) on path 2, B2 on path 4 (path 3 runs no kernel of the
repo's: its metrics have no TPU kernel), B3 and B2 and no other kernel on
path 5, the two scans through their
tensor-core entry, B1 and B3 through "bulk" and B4 through "stream" on every
launch, and the comparison launches fall outside the windows. The kernels line
(``{"kernels": [...]}``, all five kernels; ``launches`` is the count on the
first path that runs the kernel, ``launches_by_path`` all five) and the card line
come before the last line, which is ``{"ok": true, "device": {...}}`` when
every phase passed. Without CUDA, or without the package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from hnsw_tpu_torch.bench import f32_dataset, recall_fp64

HERE = os.path.dirname(os.path.abspath(__file__))

# Card peaks used for bounds (NVIDIA H100 SXM data sheet, dense).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
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
RECALL_BENCH = 0.98         # bench.py's floor, at the ef its sweep chooses
RECALL_K100 = 0.95          # k=100 through the pool reservoir, ef=192
RECALL_EF256 = 0.995        # unfused; path 1 reads 0.9955 at ef=96
FUSED_UNFUSED_GAP = 0.002   # recall@10 of the two codec routes at ef=256
MAX_ITERS_EF256 = 66        # max(8, 256 // 4 + 2) beam iterations
CODEC_EXPANDS = (4, 8)      # beam widths the two paths give B1: [B, E] src rows
# id_scores' line: a 10,000-query beam on path 1's index (M = 24, layer-0 width
# 56) without its codec, at expand 8 (448 candidates an iteration), its first
# 384: sift1m's K at M = 48, expand 4
ID_SCORES_B, ID_SCORES_E, ID_SCORES_EF, ID_SCORES_K = 10_000, 8, 128, 384
# id_scores against its plain version: both sum the same exact f32 products
# (bf16 x bf16 is exact in f32) in different orders, so they differ by a few
# f32 roundings at the magnitude of the terms, not of the score, which may
# cancel to near 0 (L2 of a near neighbour, Dot of unnormalised rows): the
# difference is held against |q| |x| (Dot), (|q| + |x|)^2 for the squared L2
# distance, and 1 for Cosine, whose terms are normalised
ID_SCORES_TERM_RTOL = 1e-6
# beam_step's lines: a real iteration of each cell's beam on an index at
# sift1m's settings (M = 48, kept pruned links: a layer-0 table 104 wide): a
# 10,000-query serve at ef 128, E 4 (serve_static's 34 iterations, a ring of
# 136 ids) and a build round at efC 800, E 8 (a ring of 1,728)
BEAM_STEP_SERVE_B, BEAM_STEP_SERVE_EF, BEAM_STEP_SERVE_E = 10_000, 128, 4


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms_turns(torch, fns, rounds=5, warmup=1, before=None):
    """Median milliseconds of each of ``fns`` over ``rounds`` CUDA-event timed
    calls, taken in turns (a, b, a, b, ...) so that all see the same card
    state; ``before``, where given, runs ahead of each call, outside the
    timed span (to restore what a call writes in place)."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            if before is not None:
                before()
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
    from concurrent.futures import ThreadPoolExecutor

    from hnsw_tpu_torch.ffi import native_lib

    def timed(fn):
        t0 = time.time()
        fn()
        return time.time() - t0

    # the native tier's g++ build runs beside the kernels' nvcc builds and
    # the phases up to its first use (``native_ready``)
    ex = ThreadPoolExecutor(1)
    NATIVE_BUILD.append(ex.submit(timed, native_lib))
    ex.shutdown(wait=False)
    build_s = timed(kernel_lib.build_all)
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "cpu_count": os.cpu_count(), "kernel_build_s": build_s,
          "ptxas": kernel_lib.ptxas_report()})
    return card


NATIVE_BUILD = []           # the g++ build of the native tier, started by env


def native_ready():
    """Wait for the native tier's g++ build (before the phases that dump,
    reload or search through it) and print its seconds once."""
    if NATIVE_BUILD:
        emit({"phase": "native_build", "native_build_s": NATIVE_BUILD.pop().result()})


def codec_rows(torch, Q, seed, codec=None, n=None, names=("B1", "B3"), b3=None):
    """B1 and B3 (``names``) against their plain version on the card. With
    ``codec`` (the built index's BeamCodec) the check runs on the table the
    serve phase reads, at its M0 and id rows; without, on a random table of
    that shape (M0=56, 8 id rows, the 200k build's). B3 runs on the vector rows
    of that table, or with ``b3`` = (blocks, scale, rows) on path 5's shard-0
    codec, whose blocks have no id rows. Each is checked and timed at every
    beam width the paths give it (``CODEC_EXPANDS``: src [16384, 4] and
    [16384, 8])."""
    from hnsw_tpu_torch.ops import codec_scores as cs

    dev = torch.device("cuda")
    rows, failures = [], []
    B, d = 16384, Q.shape[1]
    g = torch.Generator(device=dev).manual_seed(seed)
    if b3 is not None and names == ("B3",):
        blocks, scale, n = b3
        M0 = blocks.shape[1]
    elif codec is not None:
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

    table = ("path 5 shard 0" if b3 is not None and names == ("B3",)
             else "built index" if codec is not None else "random")
    for name in names:
        blk = blocks if name == "B1" else blocks[:, :M0].contiguous()
        # both widths the paths give the kernel: expand=4 (paths 1 and 5) and
        # expand=8 (path 2, k=100); the row's own numbers are expand=4's
        by_E = {E: at_width(name, blk, E) for E in CODEC_EXPANDS}
        rows.append({"name": name, "route": "cuda",
                     "source": "hnsw_tpu_torch/csrc/codec_scores.cu",
                     "replaces": ("hnsw_tpu/ops/pallas_scores.py:154" if name == "B1"
                                  else "hnsw_tpu/ops/pallas_scores.py:93"),
                     "counter": "codec_scores_ids" if name == "B1" else "codec_scores",
                     **by_E[CODEC_EXPANDS[0]],
                     "shape": {"B": B, "E": CODEC_EXPANDS[0], "M0": M0,
                               "id_rows": blk.shape[1] - M0, "d": d,
                               "table": table},
                     "shapes_checked": {"E": list(CODEC_EXPANDS)},
                     **{f"E{E}": by_E[E] for E in CODEC_EXPANDS[1:]}})
        del blk
    if "B1" in names:
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


def id_scores_err(torch, metric, got, want, q, sqnorms, ids):
    """The largest difference of ``id_scores`` from its plain version over
    the valid ids, each held against its terms (``ID_SCORES_TERM_RTOL``)."""
    ok = ids >= 0
    qn = torch.linalg.norm(q.float(), dim=1, keepdim=True)
    xn = torch.sqrt(sqnorms[ids.clamp_min(0).long()])
    if metric == "L2":
        err = (got * got - want * want).abs() / (qn + xn) ** 2
    elif metric == "Dot":
        err = (got - want).abs() / (qn * xn).clamp_min(1e-30)
    else:
        err = (got - want).abs()
    return float(err[ok].max()) if bool(ok.any()) else 0.0


def beam_ids(torch, h, Q):
    """The ids an iteration of a codec-free beam over ``h`` hands to
    ``id_scores`` (-1 where a candidate is not scored), the first
    ``ID_SCORES_K`` of each query's: the iteration whose share of valid ids is
    the median of the search's. Returns (queries, ids, each iteration's
    share)."""
    from hnsw_tpu_torch.ops import beam_search as bs

    seen, real = [], bs.id_scores

    def record(metric, q, vectors, sqnorms, ids):
        seen.append(ids.clone())
        return real(metric, q, vectors, sqnorms, ids)
    g = h.device_graph()
    q = torch.as_tensor(Q[:ID_SCORES_B], device=g.vectors.device)
    s = bs.search_begin(g, q, None, ef=ID_SCORES_EF, knbn=10, expand=ID_SCORES_E,
                        use_mask=False, codec=None)
    bs.id_scores = record  # the beam's iterations alone
    try:
        bs.beam_run(s.beam)
    finally:
        bs.id_scores = real
    shares = [float((x >= 0).float().mean()) for x in seen]
    mid = sorted(range(len(seen)), key=shares.__getitem__)[len(seen) // 2]
    return q, seen[mid][:, :ID_SCORES_K].contiguous(), shares


def sift_settings_index(torch, X, n0, batch):
    """An index of ``X``'s first ``n0`` rows at sift1m's settings (M = 48,
    efC 800, level scale 0.5, kept pruned links), built in rounds of
    ``batch``, with room for one more round."""
    from hnsw_tpu_torch import Hnsw

    h = Hnsw(max_nb_connection=48, max_elements=n0 + batch, ef_construction=800,
             dist="L2", device="cuda")
    h.set_keeping_pruned(True)
    h.modify_level_scale(0.5)
    h.parallel_insert(X[:n0], mode="device", batch_size=batch)
    return h


def build_round_ids(torch, X, n0=49_152, batch=16_384):
    """The ids the beam of one build round at sift1m's settings (M = 48, efC
    800, level scale 0.5, kept pruned links, batch 16,384) hands to
    ``id_scores`` on the build's bf16 traversal rows: an index of ``X``'s
    first ``n0`` rows, then one eager round of the next ``batch``, and of its
    beam iterations (the calls of the widest K) the one whose share of valid
    ids is the median. Returns (queries, bf16 rows, squared norms, ids, each
    iteration's share)."""
    from hnsw_tpu_torch.ops import beam_search as bs

    h = sift_settings_index(torch, X, n0, batch)
    seen, real = [], bs.id_scores

    def record(metric, q, vectors, sqnorms, ids):
        if vectors.dtype == torch.bfloat16 and ids.shape[0] == batch:
            seen.append((float((ids >= 0).float().mean()), ids.clone(), q, vectors, sqnorms))
        return real(metric, q, vectors, sqnorms, ids)
    bs.id_scores = record
    try:
        with eager_rounds():
            h.parallel_insert(X[n0:n0 + batch], mode="device", batch_size=batch)
    finally:
        bs.id_scores = real
    kmax = max(x[1].shape[1] for x in seen)
    seen = [x for x in seen if x[1].shape[1] == kmax]
    shares = [x[0] for x in seen]
    _, ids, q, V, sq = sorted(seen, key=lambda x: x[0])[len(seen) // 2]
    return q.clone(), V, sq, ids, shares


def id_scores_rows(torch, h, X, Q):
    """``id_scores`` at the search's shape on f32 rows (B = 10,000, K = 384,
    d = 128: a real beam iteration's ids on path 1's index) and at the
    build's on bf16 rows (a real beam iteration of a build round at sift1m's
    settings, ``build_round_ids``): the three forms against the plain version
    (gather + ``scores_gathered``), then the kernel's time, back to back, its
    bound (the distinct valid rows' bytes and norms, the ids, the queries and
    the scores at 3.35 TB/s: an id named twice may come from L2) and the
    same with every valid id's row read once, the plain version's time, the share of valid ids, path 1's launches by entry and
    the ``id_scores.plain`` calls counted so far."""
    from hnsw_tpu_torch.ops import id_scores as isc
    from hnsw_tpu_torch.utils.profiling import PROFILER

    failures, rows = [], []
    plain_calls = PROFILER.report().get("counters", {}).get("id_scores.plain", 0)
    g = h.device_graph()
    q, ids, shares = beam_ids(torch, h, Q)
    shapes = [(q, g.vectors, g.sqnorms, ids, shares,
               "path 1's index, a beam iteration's ids")]
    del q, ids
    shapes.append((*build_round_ids(torch, X),
                   "a build round at sift1m's settings (M = 48, efC 800, batch 16384) "
                   "on path 1's first 65,536 rows, a beam iteration's ids"))
    for q, V, sq, ids, shares, table in shapes:
        B, K = ids.shape
        N, d = V.shape
        entry = isc.id_scores_entry("L2", V.dtype)
        valid = int((ids >= 0).sum())
        distinct = int(torch.unique(ids[ids >= 0]).numel())
        err = 0.0
        for metric in ("L2", "Dot", "Cosine"):
            got = isc.id_scores(metric, q, V, sq, ids)
            want = isc.id_scores_plain(metric, q, V, sq, ids)
            torch.cuda.synchronize()
            if not torch.equal(torch.isinf(got), ids < 0):
                failures.append(f"id_scores {entry} {metric}: +INF not exactly at the -1 ids")
            e = id_scores_err(torch, metric, got, want, q, sq, ids)
            err = max(err, e)
            if e > ID_SCORES_TERM_RTOL:
                failures.append(f"id_scores {entry} {metric}: {e:.3g} of the terms")
            del got, want
        ms, plain_ms = cuda_ms_turns(
            torch, [lambda: isc.id_scores("L2", q, V, sq, ids),
                    lambda: isc.id_scores_plain("L2", q, V, sq, ids)],
            rounds=7, warmup=2)
        row_bytes = d * V.element_size()
        rest = 2 * B * K * 4 + B * d * 4  # ids, scores, queries
        bms, by = bound_ms(distinct * (row_bytes + 4) + rest, 2 * valid * d, F32_FLOPS)
        every_ms, _ = bound_ms(valid * (row_bytes + 4) + rest, 2 * valid * d, F32_FLOPS)
        rows.append({"name": f"id_scores {entry}", "route": "cuda",
                     "source": "hnsw_tpu_torch/csrc/id_scores.cu", "replaces": "none",
                     "counter": f"id_scores.{entry}", "line": "path1", "entry": entry,
                     "max_err_over_terms": err, "ms": ms,
                     "ms_back_to_back": cuda_ms_queued(
                         torch, lambda: isc.id_scores("L2", q, V, sq, ids)),
                     "bound_ms": bms, "bound_by": by,
                     "bound_every_valid_row_ms": every_ms, "plain_ms": plain_ms,
                     "valid_share": valid / (B * K), "distinct_valid_rows": distinct,
                     "valid_share_by_iteration": shares,
                     "id_scores_plain_calls": plain_calls,
                     "shape": {"B": B, "K": K, "d": d, "N": N, "metric": "L2",
                               "table": table}})
    shapes = q = V = sq = ids = None
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "rows": rows, "failures": failures})
    return rows, failures


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


class StepRecorder:
    """Copies of the inputs of one real iteration's ``beam_step.select`` and
    of the beam's ``merge`` that follows it, in the loops of ``B`` queries
    whose ring is ``H`` ids wide: the last iteration whose number is a power
    of two (so at least half-way through its loop) that went on to a merge.
    In its scope both functions are wrapped; they run as they would."""

    def __init__(self, torch, B, H):
        from hnsw_tpu_torch.ops import beam_step as bstep

        self.bstep, self.shape = bstep, (B, H)
        self.it, self.hist_ptr, self.pending, self.step = 0, None, None, None

    def __enter__(self):
        real_select, real_merge = self.real = self.bstep.select, self.bstep.merge

        def select(beam_ids, beam_d, hist, done, **kw):
            if tuple(hist.shape) == self.shape:
                if hist.data_ptr() != self.hist_ptr:  # a new loop
                    self.it, self.hist_ptr = 0, hist.data_ptr()
                it, self.it = self.it, self.it + 1
                self.pending = None
                if it and not it & (it - 1):
                    self.pending = dict(it=it, beam_ids=beam_ids.clone(), beam_d=beam_d.clone(),
                                        hist=hist.clone(), done=done.clone(),
                                        kw={**kw, "tbl_ids": kw["tbl_ids"].clone()})
            return real_select(beam_ids, beam_d, hist, done, **kw)

        def merge(beam_ids, beam_d, new_ids, new_d, ef):
            if self.pending is not None:  # the beam's merge comes first
                self.step = self.pending, dict(beam_ids=beam_ids.clone(),
                                               beam_d=beam_d.clone(), new_ids=new_ids.clone(),
                                               new_d=new_d.clone(), ef=ef)
                self.pending = None
            return real_merge(beam_ids, beam_d, new_ids, new_d, ef)

        self.bstep.select, self.bstep.merge = select, merge
        return self

    def __exit__(self, *exc):
        self.bstep.select, self.bstep.merge = self.real


def beam_step_rows(torch, X, Q, n0=49_152, batch=16_384):
    """``beam_step``'s two kernels on the inputs of real iterations
    (``StepRecorder``) on an index of ``X``'s first ``n0 + batch`` rows at
    sift1m's settings: an eager build round of its last ``batch`` rows (efC
    800, E 8, a ring of 1,728) and a codec-free eager serve of 10,000 of
    ``Q`` (ef 128, E 4, 34 iterations, a ring of 136). Each kernel against
    its plain version on the same inputs (``torch.equal`` on every output and
    on the ring it writes), its median CUDA-event time beside the plain
    version's (``library_ms``: the library sorts), and its bytes' bound at
    3.35 TB/s (a query's inputs read and outputs written once)."""
    from hnsw_tpu_torch.ops import beam_search as bs
    from hnsw_tpu_torch.ops import beam_step as bstep

    failures, rows = [], []
    h = sift_settings_index(torch, X, n0, batch)
    E_build = 8  # device_parallel_insert's expand
    with eager_rounds(), StepRecorder(torch, batch, E_build * min(
            bs.beam_iters(800, E_build), 2 * 800 // E_build + 16)) as rec:
        h.parallel_insert(X[n0:n0 + batch], mode="device", batch_size=batch)
    steps = [("build", rec.step, "a layer-0 build round at sift1m's settings (M = 48, efC "
                                 "800, batch 16384) over X's first 65,536 rows")]
    g = h.device_graph()
    q = torch.as_tensor(Q[:BEAM_STEP_SERVE_B], device=g.vectors.device)
    static = bs.serve_static(None, ef=BEAM_STEP_SERVE_EF, knbn=10, expand=BEAM_STEP_SERVE_E)
    s = bs.search_begin(g, q, None, ef=static["ef"], knbn=10, expand=static["expand"],
                        use_mask=False, max_iters=static["max_iters"], codec=None)
    with StepRecorder(torch, len(q), s.beam.hist.shape[1]) as rec:
        bs.beam_run(s.beam)
    steps.append(("serve", rec.step, "a codec-free serve of 10,000 queries at ef 128 on "
                                     "the same index"))
    for label, step, table in steps:
        if step is None:
            failures.append(f"beam_step {label}: no iteration reached a merge")
            continue
        sel, mrg = step
        ids, d, hist0, done, kw = (sel[k] for k in ("beam_ids", "beam_d", "hist", "done", "kw"))
        B, W = ids.shape
        H, E = hist0.shape[1], kw["E"]
        K = E * kw["tbl_ids"].shape[1]
        h_k, h_p = hist0.clone(), hist0.clone()
        got = bstep.select(ids, d, h_k, done, **kw)
        want = bstep.select_plain(ids, d, h_p, done, **kw)
        torch.cuda.synchronize()
        sel_equal = torch.equal(h_k, h_p) and all(torch.equal(a, b) for a, b in zip(got, want))
        mi, md, ni, nd, ef = (mrg[k] for k in ("beam_ids", "beam_d", "new_ids", "new_d", "ef"))
        merge_equal = all(torch.equal(a, b) for a, b in zip(
            bstep.merge(mi, md, ni, nd, ef), bstep._merge_beam(mi, md, ni, nd, ef)))
        ring = hist0.clone()
        sel_ms, sel_plain_ms = cuda_ms_turns(
            torch, [lambda: bstep.select(ids, d, ring, done, **kw),
                    lambda: bstep.select_plain(ids, d, ring, done, **kw)],
            rounds=7, warmup=2, before=lambda: ring.copy_(hist0))
        merge_ms, merge_plain_ms = cuda_ms_turns(
            torch, [lambda: bstep.merge(mi, md, ni, nd, ef),
                    lambda: bstep._merge_beam(mi, md, ni, nd, ef)], rounds=7, warmup=2)
        shape = {"B": B, "W": W, "H": H, "E": E, "K": K, "ef_out": ef,
                 "iteration": sel["it"], "table": table,
                 "kept_candidates": int((want[2] >= 0).sum()),
                 "done_before": int(done.sum())}
        # select: beam ids and distances, ring, done and the K links read; the
        # ring's E ids, src, done and K ids written. merge: beam and
        # candidates read, ef ids and distances written
        for entry, ok, ms, plain_ms, nbytes in (
                ("fused", sel_equal, sel_ms, sel_plain_ms,
                 B * (8 * W + 4 * H + 1 + 4 * K + 8 * E + 1 + 4 * K)),
                ("merge", merge_equal, merge_ms, merge_plain_ms, B * (8 * W + 8 * K + 8 * ef))):
            if not ok:
                failures.append(f"beam_step {entry} ({label}): not equal to its plain version")
            bms, by = bound_ms(nbytes, 0, F32_FLOPS)
            rows.append({"name": f"beam_step {entry}", "route": "cuda",
                         "source": "hnsw_tpu_torch/csrc/beam_step.cu", "replaces": "none",
                         "counter": "beam_step", "entry": entry, "shape_of": label,
                         "equal": ok, "ms": ms, "library_ms": plain_ms, "bound_ms": bms,
                         "bound_by": by, "shape": shape})
    h = g = q = s = steps = None
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "rows": rows, "failures": failures})
    return rows, failures


F32_SMALL = (9000, 300, 2)  # (rows, queries, tiles per span) of the f32 checks


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
    entries at the path's shape (200k x 128, B=2048, bf16), at a ragged one
    (B=2000, a 30000-row corpus whose last span is one tile short, d=64), at d
    = 1536 (the K-looped layout) and at d = 100 (copies padded to 112 columns);
    the f32-FMA entry on a small f32 case with d=40. At the path's shape also the
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
    # the K-looped layout at d = 1536 (24 boxes), and a d that is not a multiple
    # of 16 (100: the bf16 copies padded to 112 columns, the resident layout)
    for dd in (1536, 100):
        Xh, xh, _ = st.pad_corpus(rng.standard_normal((9000, dd)).astype(np.float32))
        Qh = torch.as_tensor(rng.standard_normal((300, dd)).astype(np.float32), device=dev)
        Xhs = st.scan_copy(torch.as_tensor(Xh, device=dev))
        checks.append(compare_scans(
            torch, st, kernel_lib, st.scan_copy(Qh), Xhs, torch.as_tensor(xh, device=dev), 2,
            f"B=300 N=10240 d={dd} bf16 acc=2 ({st.scan_layout(dd)})", "wgmma", failures))
    del Xh, xh, Qh, Xhs
    # f32 (full-precision contract): the tf32x3 entry, K-looped in 32-column
    # boxes, at d = 40 (a last box of 8 columns), 128, 784 (the last box half
    # full), 960 and 1536; and a ragged shape (B=1000, 15 tiles in spans of 4,
    # d=100: a last wgmma step half past d, read from the tensor map's zero fill)
    f32_checks = [compare_scans(torch, st, kernel_lib, qb, Xd, xsq, acc,
                                f"path B={Bq} N={Np} d={d} f32 acc={acc}", "tf32x3", failures)]
    for dd, (n, B, acc_f) in [(40, F32_SMALL), (128, F32_SMALL), (784, F32_SMALL),
                              (960, F32_SMALL), (1536, F32_SMALL), (100, (30000, 1000, 4))]:
        Xf, xf, _ = st.pad_corpus(rng.standard_normal((n, dd)).astype(np.float32))
        Qf = torch.as_tensor(rng.standard_normal((B, dd)).astype(np.float32), device=dev)
        f32_checks.append(compare_scans(
            torch, st, kernel_lib, Qf, torch.as_tensor(Xf, device=dev),
            torch.as_tensor(xf, device=dev), acc_f,
            f"f32 B={B} N={Xf.shape[0]} d={dd} acc={acc_f}", "tf32x3", failures))
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
    # in turns with the library call: the same shape through the K-looped
    # layout and through the f32-FMA entry (bf16 in, not through the wrapper)
    ms, lib_ms, kloop_ms, was_ms = cuda_ms_turns(
        torch, [lambda: st.scan_packed(qs, Xs, xsq, tn, grp, acc), library,
                scan_launcher(torch, st, kernel_lib, True, "wgmma", "kloop", qs, Xs, xsq, acc),
                scan_launcher(torch, st, kernel_lib, True, "simt", "resident", qs, Xs, xsq,
                              acc)])
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
           "layout": st.scan_layout(d, True), "kloop_ms": kloop_ms, "was_ms": was_ms,
           "was_entry": "simt", "ptxas": kernel_ptxas(kernel_lib, "scan_topk", "resident"),
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
    u_ms, u_lib_ms, u_kloop_ms, u_was_ms = cuda_ms_turns(
        torch, [lambda: st.scan_unpacked(qs, Xs, xsq, tn, grp, acc), library,
                scan_launcher(torch, st, kernel_lib, False, "wgmma", "kloop", qs, Xs, xsq,
                              acc),
                scan_launcher(torch, st, kernel_lib, False, "simt", "resident", qs, Xs, xsq,
                              acc)])
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
                 "layout": st.scan_layout(d, False), "kloop_ms": u_kloop_ms,
                 "was_ms": u_was_ms, "was_entry": "simt",
                 "ptxas": kernel_ptxas(kernel_lib, "scan_topk_unpacked", "resident"),
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
    # ---- B2 and B5 on f32 inputs (the tf32x3 entry) at the path's shape; their
    # launches are read on the high-d path's f32 line, which drives the entry
    f32_rows = [scan_row(torch, st, kernel_lib, name, qb, Xd, xsq, acc, f32_checks[0],
                         "highd_mnist_f32", failures=failures) for name in ("B2 f32", "B5 f32")]
    f32_rows[0]["shapes_checked"] = f32_checks
    rows += f32_rows
    emit({"phase": "kernels", "rows": rows, "failures": failures})
    return rows, failures


def build_path1(torch, X, batch=16384):
    """Path 1's build of ``X`` (M=24, efC=400, level scale 0.5, kept pruned
    links, batch 16384, cap 96): (index, seconds to a synchronize, peak
    device memory of the build in GB, allocated and reserved)."""
    from hnsw_tpu_torch import Hnsw, PROFILER
    from hnsw_tpu_torch.ops import program

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    program.reset_peak_memory()
    PROFILER.reset()
    t0 = time.time()
    h = Hnsw(max_nb_connection=24, max_elements=len(X), ef_construction=400,
             dist="L2", device="cuda")
    h.set_keeping_pruned(True)
    h.modify_level_scale(0.5)
    h.parallel_insert(X, mode="device", batch_size=batch, build_max_iters=96)
    torch.cuda.synchronize()
    peak, reserved = program.peak_memory()
    return h, time.time() - t0, {"peak_mem_gb": peak / 1e9, "peak_reserved_gb": reserved / 1e9}


def round_faults(label, stats):
    """The build's round programs must have replayed at least one round and
    run no part uncaptured outside the first sighting of its key."""
    if stats["rounds_replayed"] < 1 or stats["first_runs"] != stats["keys"]:
        return [f"{label}: round programs {stats}: a round must replay, and no part may "
                "run uncaptured outside the first sighting of its key"]
    return []


def phase_build(torch, X):
    """Path 1's build, through the round programs: each round between two
    synchronizes, round BUILD_TRACE_ROUND in one profiler window (device
    activity only), the device tables held for ``phase_build_program``.
    Returns (index, seconds less the profiler's own, failures, tables)."""
    from hnsw_tpu_torch import PROFILER
    from hnsw_tpu_torch.ops import program

    with watched_rounds(torch, program.BuildPrograms, "round", BUILD_TRACE_ROUND,
                        lambda args, out: (args[1].tables(), args[1].indeg0)) as rec:
        h, build_s, peaks = build_path1(torch, X)
    line = round_form(torch, rec, build_s, peaks, h._round_stats)
    emit({"phase": "build", "n": len(X), "d": X.shape[1],
          "points_per_s": len(X) / line["build_s"], "repair": h._repair_stats,
          "layer0_width": int(h._layers[0].width),
          "max_level": h.get_max_level_observed(), **line, "spans": PROFILER.report()})
    return h, line["build_s"], round_faults("build", h._round_stats), rec["held"]


BUILD_TRACE_ROUND = 20      # a steady round of path 1's build: B=16384, every key replayed
STEADY_FROM = 13            # rounds 11 and 12 are the first two at B=16384


@contextlib.contextmanager
def watched_rounds(torch, owner, name, trace_at, keep):
    """Patch the round function ``owner.name`` for one build: each call runs
    between two synchronizes and is timed on the host clock, call
    ``trace_at`` (from 0) runs inside one profiler window, and ``keep(args,
    result)`` gives what the build holds after the call (its tables)."""
    real = getattr(owner, name)
    rec = {"walls_ms": [], "trace": None, "held": None}

    def watched(*args, **kwargs):
        out = []
        torch.cuda.synchronize()
        t0 = time.time()
        if len(rec["walls_ms"]) == trace_at:
            rec["trace"] = trace_window(torch, lambda: out.append(real(*args, **kwargs)),
                                        host_ops=False)
        else:
            out.append(real(*args, **kwargs))
        torch.cuda.synchronize()
        rec["walls_ms"].append((time.time() - t0) * 1e3)
        rec["held"] = keep(args, out[0])
        return out[0]

    setattr(owner, name, watched)
    try:
        yield rec
    finally:
        setattr(owner, name, real)


@contextlib.contextmanager
def eager_rounds():
    """Builds in this scope run the eager ``round_step`` on the card (the
    reference the round programs are held to)."""
    from hnsw_tpu_torch.ops import program

    real = program.round_programs
    program.round_programs = lambda device, share=program.POOL_SHARE: None
    try:
        yield
    finally:
        program.round_programs = real


def tables_equal(torch, a, b, n):
    """Every layer's ids and dists and the layer-0 in-degree of two builds'
    device state (``(tables, indeg0)``), bit for bit on rows [0, n) (the
    sink row takes repeated writes in both): (equal, the first difference)."""
    (ta, ia), (tb, ib) = a, b
    if len(ta) != len(tb):
        return False, f"{len(ta)} layers against {len(tb)}"
    for l, ((xi, xd), (yi, yd)) in enumerate(zip(ta, tb)):
        if not (torch.equal(xi[:n], yi[:n]) and torch.equal(xd[:n], yd[:n])):
            rows = int(((xi[:n] != yi[:n]).any(1) | (xd[:n] != yd[:n]).any(1)).sum())
            return False, f"layer {l}: {rows} rows differ"
    if not torch.equal(ia[:n], ib[:n]):
        return False, f"indeg0: {int((ia[:n] != ib[:n]).sum())} rows differ"
    return True, None


def round_form(torch, rec, build_s, peaks, stats):
    """One build's line for ``phase_build`` and ``phase_build_program``: its
    seconds less the profiler's own (the start and stop around round
    BUILD_TRACE_ROUND's window, which no build does), each round's ms
    (between synchronizes), the steady rounds and the traced round."""
    tr = rec["trace"]
    profiler_s = rec["walls_ms"][BUILD_TRACE_ROUND] / 1e3 - tr["wall_ms"] / 1e3
    steady = [ms for r, ms in enumerate(rec["walls_ms"]) if r >= STEADY_FROM
              and r != BUILD_TRACE_ROUND]
    return {"build_s": build_s - profiler_s, "build_s_with_profiler": build_s,
            "profiler_s": profiler_s, **peaks, "rounds": len(rec["walls_ms"]),
            "round_ms": rec["walls_ms"], "steady_round_ms_median": float(np.median(steady)),
            "rounds_s_less_profiler": sum(rec["walls_ms"]) / 1e3 - profiler_s,
            "traced_round": {"round": BUILD_TRACE_ROUND, "wall_ms": tr["wall_ms"],
                             "device_busy_ms": tr["device_busy_ms"],
                             "idle_share": tr["idle_share"], "top": tr["top"][:6]},
            "round_programs": stats}


def phase_build_program(torch, X, program_tables, program_build_s):
    """Path 1's build through the round programs (its device tables
    ``program_tables``, its seconds ``program_build_s``) against the eager
    build (``round_step``, one host read per beam iteration and descent hop)
    of the same corpus with the same parameters, in this process: every
    layer's ids and dists and ``indeg0`` bit-equal on every real row; the
    eager build's seconds, rounds and traced round as the program build's
    line has them. Returns the failures."""
    from hnsw_tpu_torch import PROFILER
    from hnsw_tpu_torch.ops import insert_rounds

    with eager_rounds(), watched_rounds(torch, insert_rounds, "round_step",
                                        BUILD_TRACE_ROUND,
                                        lambda args, out: (tuple(args[3]), args[7])) as rec:
        _, build_s, peaks = build_path1(torch, X)
    eager = round_form(torch, rec, build_s, peaks, None)
    eager["spans"] = PROFILER.report()
    equal, diff = tables_equal(torch, program_tables, rec["held"], len(X))
    failures = [] if equal else [
        f"build_program: the program build differs from the eager one: {diff}"]
    emit({"phase": "build_program", "n": len(X), "tables_equal_eager": equal,
          "first_difference": diff, "program_build_s": program_build_s,
          "eager": eager, "failures": failures})
    return failures


def phase_build_extend(torch, X, n=20_000, batch=2048):
    """The widen pass (``set_extend_candidates(True)``, which every index
    loaded from the reference's format has) on the card: two builds of
    ``X[:n]`` (M=8, batch ``batch``) through the round programs, each
    bit-equal to its eager build on every real row. At ef_construction 16
    every beam returns at most 2M = 16 candidates, so every round widens and
    the captured widen piece replays; at 48 the steady rounds keep, and the
    captured keep piece replays. Returns the failures."""
    from hnsw_tpu_torch import Hnsw
    from hnsw_tpu_torch.ops import insert_rounds, program

    def build(efc):
        torch.cuda.synchronize()
        t0 = time.time()
        h = Hnsw(max_nb_connection=8, max_elements=n, ef_construction=efc, dist="L2",
                 device="cuda")
        h.set_extend_candidates(True)
        h.parallel_insert(X[:n], mode="device", batch_size=batch)
        torch.cuda.synchronize()
        return h, time.time() - t0

    failures, builds = [], {}
    for efc, branch in ((16, "widen"), (48, "keep")):
        with watched_rounds(torch, program.BuildPrograms, "round", -1,
                            lambda args, out: (args[1].tables(), args[1].indeg0)) as rec:
            h, program_s = build(efc)
        stats, held = h._round_stats, rec["held"]
        with eager_rounds(), watched_rounds(torch, insert_rounds, "round_step", -1,
                                            lambda args, out: (tuple(args[3]), args[7])) as rec:
            _, eager_s = build(efc)
        equal, diff = tables_equal(torch, held, rec["held"], n)
        held = h = rec = None
        label = f"build_extend efC={efc}"
        if not equal:
            failures.append(f"{label}: the program build differs from the eager one: {diff}")
        if stats[f"{branch}_replays"] < 1:
            failures.append(f"{label}: the captured {branch} piece never replayed")
        failures += round_faults(label, stats)
        builds[efc] = {"tables_equal_eager": equal, "first_difference": diff,
                       "program_s": program_s, "eager_s": eager_s,
                       "widen_replays": stats["widen_replays"],
                       "keep_replays": stats["keep_replays"], "round_programs": stats}
    emit({"phase": "build_extend", "n": n, "d": X.shape[1], "M": 8, "batch": batch,
          "by_efc": builds, "failures": failures})
    return failures


def one_shot_blocks(torch, g, codec):
    """The codec's blocks as one gather (the form the chunked build
    replaced): the int8 rows of each node's table and its id rows."""
    tbl = g.layer_ids[0][:, :codec.M0]
    cap1, M0 = tbl.shape
    d = codec.dim
    v = g.vectors.to(torch.float32)
    amax = torch.clamp_min(v.abs().max(), 1e-12)
    vq = torch.clamp(torch.round(v * (127.0 / amax)), -127, 127).to(torch.int8)
    blocks = vq[torch.clamp(tbl, 0, cap1 - 1).long()]
    if codec.id_rows:
        idp = torch.full((cap1, codec.id_rows * d // 4), -1, dtype=torch.int32,
                         device=v.device)
        idp[:, :M0] = tbl
        blocks = torch.cat([blocks, idp.view(torch.int8).reshape(cap1, codec.id_rows, d)], 1)
    return blocks.contiguous()


def phase_codec(torch, h):
    """Path 1's codec, built in row chunks (``BeamCodec._build``): its build's
    own peak device memory (above what was allocated before it) against a
    one-shot gather's, and its blocks byte-equal to that gather's. Returns
    the failures."""
    g = h.device_graph()
    peaks = {}
    for form in ("chunked", "one_shot"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = h.device_codec() if form == "chunked" else one_shot_blocks(torch, g, codec)
        torch.cuda.synchronize()
        peaks[form] = {"s": time.time() - t0,
                       "peak_above_base_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
        if form == "chunked":
            codec = out
        else:
            want = out
    equal = bool(torch.equal(codec.blocks, want))
    del want
    failures = [] if equal else ["codec: the chunked blocks differ from the one-shot gather"]
    emit({"phase": "codec", "cap1": g.cap1, "M0": codec.M0, "id_rows": codec.id_rows,
          "blocks_gb": codec.blocks.numel() / 1e9, "byte_equal_one_shot": equal,
          **peaks, "failures": failures})
    return failures


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
    from hnsw_tpu_torch.ops.scan_topk import refine_width

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
          "exact_queries": len(Q), "refine_width": refine_width(k, bf.SCAN_OVERFETCH, 1 << 30)})
    return kth, recall, bf, ids_bf


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
        # the first call builds the program (a warm-up run, then a replay)
        b1_before = kernel_lib.LAUNCHES["codec_scores_ids"]
        ids, _ = device_search_stream(h, Q, k, ef, batch=16384, expand=4)
        b1_first = kernel_lib.LAUNCHES["codec_scores_ids"] - b1_before
        oid = np.where(ids >= 0, h._origin[np.clip(ids, 0, h._nb_point - 1)], -1)
        r = recall_fp64(X, Q, kth, oid, k)
        torch.cuda.synchronize()
        b1_before = kernel_lib.LAUNCHES["codec_scores_ids"]
        t0 = time.time()
        device_search_stream(h, Qs, k, ef, batch=16384, expand=4)
        qps = len(Qs) / (time.time() - t0)
        b1_batch = (kernel_lib.LAUNCHES["codec_scores_ids"] - b1_before) / (len(Qs) // 16384)
        out[ef] = {"recall_at_10": r, "qps": qps, "b1_launches_per_batch": b1_batch,
                   "b1_launches_first_call": b1_first}
    emit({"phase": "serve", "batch": 16384, "expand": 4, "codec_M0": codec.M0,
          "codec_id_rows": codec.id_rows, "pivots": int(g.pivot_ids.numel()),
          "stream_queries": len(Qs), "by_ef": out})
    return out


PROGRAM_EFS = (32, 64, 96)
PROGRAM_ROUNDS = 3          # timed windows of each form, taken in turns


def search_static(h, ef, k=10, expand=4, **kw):
    """``search_program``'s static arguments as ``device_search_stream``
    passes them, so ``h.device_program`` finds the program the stream built."""
    from hnsw_tpu_torch.ops.beam_search import serve_static

    return serve_static(h.device_codec(), ef=ef, knbn=k, expand=expand, **kw)


def replay_equals_direct(torch, prog, q, mask=None):
    """The program's replay against a direct call of the same pieces on the
    card (``search_fixed``: every beam iteration to the cap, no capture):
    True when ids and distances are equal bit for bit."""
    from hnsw_tpu_torch.ops.program import search_fixed

    ids_r, d_r = prog.run(q, mask)
    ids_d, d_d = search_fixed(prog.g, q, mask, **prog.kw)
    return bool(torch.equal(ids_r, ids_d) and torch.equal(d_r, d_d))


def trace_window(torch, fn, host_ops=True):
    """``fn`` once under torch.profiler: wall ms to the device's end, device
    busy ms (the device activities' summed time: kernels, copies, sets) and
    the idle share, the device activities by time, and the seconds the
    profiler took to stop and hand over its records. ``host_ops=False`` (a
    build round) records the device activity alone and reads the records
    raw: a round's tens of thousands of host ops, and ``key_averages()``'s
    event tree over its device records, would take the profiler seconds.
    Both forms sum the same device records."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if host_ops else []
    prof = profile(activities=acts + [ProfilerActivity.CUDA])
    with prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_name = {}
    if host_ops:
        # kernel-level rows only: op-level rows repeat their kernels' time
        for e in prof.key_averages():
            if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.key] = [e.count, e.self_device_time_total * 1e3]
    else:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
                calls_ns = by_name.setdefault(e.name(), [0, 0])
                calls_ns[0] += 1
                calls_ns[1] += e.duration_ns()
    profiler_s = time.time() - t0 - wall_ms / 1e3
    busy_ms = sum(ns for _, ns in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "profiler_s": profiler_s,
            "top": [{"name": name[:80], "calls": c, "device_ms": ns / 1e6}
                    for name, (c, ns) in top]}


def phase_program(torch, h, Q, k=10):
    """The search as one device program on path 1's index, batch 16384, at
    ef 32/64/96 (one graph each: max_iters <= 48): the replay bit-equal to a
    direct call of the same pieces and to the eager search (one host read per
    iteration), B1 launches per batch counted through replays (one per beam
    iteration, all ``bulk``), and the wall, device busy and idle of one batch
    for both forms (median of PROGRAM_ROUNDS profiled windows in turns; wall
    also from the host clock without the profiler). Returns the failures."""
    from hnsw_tpu_torch.ops import kernel_lib
    from hnsw_tpu_torch.ops.beam_search import search_program

    failures = []
    g, codec = h.device_graph(), h.device_codec()
    q = torch.as_tensor(Q[:16384], device="cuda")
    by_ef = {}
    for ef in PROGRAM_EFS:
        static = search_static(h, ef, k)
        t0 = time.time()
        prog = h.device_program(len(q), torch.float32, **static)
        get_s = time.time() - t0  # 0 when the serve phase built it
        prog.run(q)
        torch.cuda.synchronize()
        before = dict(kernel_lib.LAUNCHES)
        ids_r, d_r = prog.run(q)
        torch.cuda.synchronize()
        b1 = kernel_lib.LAUNCHES["codec_scores_ids"] - before["codec_scores_ids"]
        bulk = kernel_lib.LAUNCHES["codec_scores_ids.bulk"] - before["codec_scores_ids.bulk"]
        direct = replay_equals_direct(torch, prog, q)
        ids_e, d_e = search_program(g, q, None, codec=codec, **static)
        eager = bool(torch.equal(ids_r, ids_e) and torch.equal(d_r, d_e))

        def run_program():
            prog.run(q)

        def run_eager():
            search_program(g, q, None, codec=codec, **static)

        walls = {"program": [], "eager": []}
        for _ in range(PROGRAM_ROUNDS):
            for name, fn in (("program", run_program), ("eager", run_eager)):
                torch.cuda.synchronize()
                t0 = time.time()
                fn()
                torch.cuda.synchronize()
                walls[name].append((time.time() - t0) * 1e3)
        traced = {"program": [], "eager": []}
        for _ in range(PROGRAM_ROUNDS):
            for name, fn in (("program", run_program), ("eager", run_eager)):
                traced[name].append(trace_window(torch, fn))
        row = {"max_iters": static["max_iters"], "unrolled": prog.unrolled,
               "program_get_s": get_s, "pool_bytes": prog.pool_bytes,
               "b1_launches_per_batch": b1, "b1_bulk": bulk,
               "replay_equals_direct": direct, "replay_equals_eager": eager}
        for name in ("program", "eager"):
            w = traced[name]
            mid = sorted(w, key=lambda x: x["wall_ms"])[len(w) // 2]
            row[name] = {"wall_ms": float(np.median(walls[name])),
                         "wall_ms_all": walls[name],
                         "traced_wall_ms": mid["wall_ms"],
                         "device_busy_ms": mid["device_busy_ms"],
                         "idle_share": mid["idle_share"],
                         "busy_ms_all": [x["device_busy_ms"] for x in w],
                         "top": mid["top"][:6]}
        by_ef[ef] = row
        if not (direct and eager):
            failures.append(f"program ef={ef}: replay equals direct {direct}, eager {eager}")
        if b1 != static["max_iters"] or bulk != b1:
            failures.append(f"program ef={ef}: {b1} B1 launches a batch ({bulk} bulk), "
                            f"not {static['max_iters']}")
    emit({"phase": "program", "batch": len(q), "programs": len(h._programs),
          "pool_bytes": h._programs.pool_bytes(), "by_ef": by_ef, "failures": failures})
    return failures


EXACT_BATCH = 2048           # the exact engine's batch (BENCH_SCANB)
EXACT_STREAM_QUERIES = 65_536
EXACT_STREAM_BLOCKS = 3
EXACT_BLOCK_S = 0.5
SMALL_N = 20_000             # below BruteForceIndex.SCAN_MIN_POINTS: the matmul route


def call_replay_equals_direct(torch, prog, *xs):
    """A ``CallProgram``'s replay against a direct call of its function (the
    same pieces, no capture) on the card: (outputs equal bit for bit, the
    launches the replay counted by counter)."""
    from hnsw_tpu_torch.ops import kernel_lib

    before = dict(kernel_lib.LAUNCHES)
    out_r = prog.run(*xs)
    launches = {c: v - before[c] for c, v in kernel_lib.LAUNCHES.items() if v != before[c]}
    out_d = prog.fn(*xs)
    return all(torch.equal(a, b) for a, b in zip(out_r, out_d)), launches


def one_scan_launch(counter):
    """What one replay of an exact-scan program launches: the kernel once,
    through its tensor-core entry."""
    return {counter: 1, f"{counter}.wgmma": 1}


def eager_exact_search(bf, queries, knbn, filter=None):
    """``BruteForceIndex.search_batch`` on its scan as it ran before its
    programs: the same batches and pipeline (``l2_topk_stream``'s), each
    batch through ``l2_topk`` called op by op. The eager form the programs
    are held against and timed beside."""
    from hnsw_tpu_torch.ops.scan_topk import l2_topk
    from hnsw_tpu_torch.ops.stream import fetch_host, pipelined_stream, upload_batch

    Xd, xsq, Xscan, perm, acc, _ = bf._scan_device()
    q = np.atleast_2d(np.asarray(queries, np.float32))
    nq, kf = len(q), bf._fetch_width(knbn, filter)
    batch = min(EXACT_BATCH, max(256, nq))
    out_d = np.empty((nq, kf), np.float32)
    out_i = np.empty((nq, kf), np.int64)

    def upload(s):
        qb = q[s:s + batch]
        if len(qb) < batch:
            qb = np.concatenate([qb, np.repeat(qb[-1:], batch - len(qb), 0)])
        return upload_batch(qb, Xd.device)

    def dispatch(s, staged):
        return fetch_host(l2_topk(staged.wait(), Xd, xsq, kf, Xscan=Xscan,
                                  overfetch=bf.SCAN_OVERFETCH, acc=acc))

    def fetch(s, out):
        dd, ii = out.get()
        n = min(batch, nq - s)
        out_d[s:s + n], out_i[s:s + n] = dd[:n], ii[:n]

    pipelined_stream(range(0, nq, batch), upload, dispatch, fetch)
    return bf._finish(out_d, perm[np.clip(out_i, 0, len(perm) - 1)], knbn, filter)


def eager_ivf_search(ix, queries, knbn, nprobe, filter=None, chunk=512):
    """``IvfFlatIndex.search_batch`` as it ran before its programs: each
    512-query chunk through ``ivf_search`` (route, probe, refine) called op by
    op and read back to the host."""
    import torch
    from hnsw_tpu_torch.models.ivf import ivf_search

    np_eff, kf = ix._probe_plan(knbn, 0, nprobe, filter)
    q = ix._queries(queries)
    rows, dists = [], []
    for s in range(0, len(q), chunk):
        qs = torch.as_tensor(q[s:s + chunk], device=ix.device)
        r, d = ivf_search(qs, *ix._built[:5], nprobe=np_eff, kf=kf, metric=ix.metric.name)
        rows.append(r.cpu().numpy())
        dists.append(d.cpu().numpy())
    return ix._finish(np.concatenate(rows), np.concatenate(dists), knbn, filter)


def forms_timed(torch, forms, rounds=PROGRAM_ROUNDS):
    """Each form (name -> fn) timed in turns: wall ms (host clock to the
    device's end) median of ``rounds``, then one torch.profiler window each
    (device busy ms, idle share, kernels by time)."""
    walls = {name: [] for name in forms}
    for _ in range(rounds):
        for name, fn in forms.items():
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            walls[name].append((time.time() - t0) * 1e3)
    out = {}
    for name, fn in forms.items():
        w = trace_window(torch, fn)
        out[name] = {"wall_ms": float(np.median(walls[name])), "wall_ms_all": walls[name],
                     "traced_wall_ms": w["wall_ms"], "device_busy_ms": w["device_busy_ms"],
                     "idle_share": w["idle_share"], "top": w["top"][:5]}
    return out


def answers_equal(a, b):
    return bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))


def even_ids_filter(n):
    """An id filter keeping about half the corpus: the even external ids."""
    from hnsw_tpu_torch.filter import SortedIdFilter

    return SortedIdFilter(np.arange(0, n, 2))


def filtered_ok(ids, k):
    """Every returned id passes ``even_ids_filter`` and every row is full."""
    return bool((ids >= 0).all() and (ids % 2 == 0).all() and ids.shape[1] == k)


def phase_exact_program(torch, bf, X, Q, k=10):
    """The exact engine as a captured program on path 1's ``BruteForceIndex``
    (200k x 128, kernel B2, batch 2048): the replay of the k=10 key bit-equal
    to a direct ``l2_topk`` call and one B2 launch (``wgmma``) per replay;
    one 2048-query batch through ``search_batch`` against the eager form
    (wall median of 3 in turns, device busy from one profiler window each),
    and the program alone against its direct call on a resident batch; the
    stream of 65,536 f32 queries through ``search_batch`` against the eager
    form (median QPS over 3 blocks, spread; one more pass each with the
    stream's upload/dispatch/fetch spans); a filtered search (even ids)
    equal to the eager one, every id passing; below the scan, the matmul
    route's program (L2 and Cosine on 20k rows) equal to its direct
    ``_bf_topk`` call; the pools. Returns (failures, the replay's launches)."""
    from hnsw_tpu_torch import PROFILER, BruteForceIndex, bench
    from hnsw_tpu_torch.ops.scan_topk import SCAN_GROUP, SCAN_TN, scan_program

    failures = []
    Xd, xsq, Xscan, perm, acc, programs = bf._scan_device()
    held = len(programs)
    prog = scan_program(programs, Xd, xsq, EXACT_BATCH, torch.float32, Xscan=Xscan, k=k,
                        tn=SCAN_TN, group=SCAN_GROUP, acc=acc,
                        overfetch=bf.SCAN_OVERFETCH, packed=True)
    q = torch.as_tensor(Q[:EXACT_BATCH], device="cuda")
    direct, launches = call_replay_equals_direct(torch, prog, q)
    if not direct:
        failures.append("exact program k=10: the replay differs from the direct l2_topk call")
    if launches != one_scan_launch("scan_topk"):
        failures.append(f"exact program k=10: a replay launched {launches}, not one B2 "
                        "through wgmma")
    Q1 = Q[:EXACT_BATCH]
    same = answers_equal(bf.search_batch(Q1, k), eager_exact_search(bf, Q1, k))
    if not same:
        failures.append("exact program: search_batch differs from the eager search")
    one_batch = forms_timed(torch, {"program": lambda: bf.search_batch(Q1, k),
                                    "eager": lambda: eager_exact_search(bf, Q1, k)})
    resident = forms_timed(torch, {"program": lambda: prog.run(q), "eager": lambda: prog.fn(q)})
    Qs = np.tile(Q, (-(-EXACT_STREAM_QUERIES // len(Q)), 1))[:EXACT_STREAM_QUERIES]
    stream = {}
    for name, fn in (("program", lambda: bf.search_batch(Qs, k)),
                     ("eager", lambda: eager_exact_search(bf, Qs, k))):
        qps, spread, blocks, disc = bench.median_blocks(fn, len(Qs), EXACT_STREAM_BLOCKS,
                                                        EXACT_BLOCK_S)
        # where one pass's host time goes: the stream's three stages (threads)
        PROFILER.reset()
        t0 = time.time()
        fn()
        stream[name] = {"qps": qps, "spread": spread, "blocks": blocks, "discarded": disc,
                        "pass_s": time.time() - t0, "spans": PROFILER.report()}
    flt = even_ids_filter(len(X))
    got = bf.search_batch(Q1, k, filter=flt)
    filtered = {"equal_eager": answers_equal(got, eager_exact_search(bf, Q1, k, filter=flt)),
                "ids_pass": filtered_ok(got[0], k)}
    if not all(filtered.values()):
        failures.append(f"exact program, filtered: {filtered}")
    # below the scan: the matmul route's program (TopkProgram) on the first
    # SMALL_N rows, L2 and Cosine
    matmul_route = {}
    for metric in ("L2", "Cosine"):
        small = BruteForceIndex(dist=metric, device="cuda")
        small.parallel_insert(X[:SMALL_N])
        small.search_batch(Q1, k)
        (p,) = small._programs._progs.values()
        equal_m, launches_m = call_replay_equals_direct(torch, p, q)
        matmul_route[metric] = {"replay_equals_direct": equal_m, "launches": launches_m,
                                "pool_bytes": p.pool_bytes}
        if not equal_m or launches_m or small._use_scan():
            failures.append(f"exact program below the scan, {metric}: {matmul_route[metric]}")
        small.drop_programs()
    emit({"phase": "exact_program", "batch": EXACT_BATCH, "k": k, "packed": True,
          "programs_before": held, "replay_equals_direct": direct,
          "launches_per_replay": launches, "search_batch_equals_eager": same,
          "one_batch": one_batch, "resident_batch": resident,
          "stream": {"queries": len(Qs), "query_dtype": "f32", **stream},
          "filtered": filtered, "matmul_route": matmul_route, "programs": len(programs),
          "pool_bytes": programs.pool_bytes(),
          "pools": [{"k": p.kw["k"], "batch": p.inputs[0].shape[0],
                     "dtype": str(p.inputs[0].dtype), "pool_bytes": p.pool_bytes}
                    for p in programs._progs.values()],
          "failures": failures})
    return failures, launches


def phase_bench(torch, h, build_s, bf, X, Q, kth):
    """The port's benchmark (``hnsw_tpu_torch.bench``) on path 1's
    index, queries and truth, with no second build: its ef sweep, the exact
    engine (on ``bf``'s scan corpus) and the chosen ef timed in 3 blocks of
    0.5 s, the device-resident rate over S2 = 4 sub-batches, the other knobs at
    bench.py's defaults. Prints its record, ``{"bench": {...}}``, and returns
    the failures: a key missing, recall below bench.py's floor (graph) or
    RECALL_EXACT (exact), a B1 launch not through ``bulk`` or a B2 launch not
    through ``wgmma``."""
    from hnsw_tpu_torch import bench
    from hnsw_tpu_torch.ops import kernel_lib

    cfg = bench.Config(n=len(X), d=X.shape[1], qbatch=len(Q), k=10, dataset="gauss",
                       recall=RECALL_BENCH, blocks=3, min_block_s=0.5, kernel_s=4,
                       device="cuda")
    before = dict(kernel_lib.LAUNCHES)
    t0 = time.time()
    exact = bench.measure_exact(cfg, bf._scan_device(), X, Q, kth)
    hnsw = bench.measure_hnsw(cfg, h, X, Q, kth)
    faults = bench.entry_faults(before, kernel_lib.LAUNCHES, X.shape[1], h.device_codec())
    rec = bench.make_record(cfg, exact, hnsw, h, build_s, "device",
                            bench.device_info(torch.device("cuda")))
    emit({"phase": "bench", "seconds": time.time() - t0, "sweep": hnsw["choice"].sweep,
          "launches": {c: kernel_lib.LAUNCHES[c] - before[c]
                       for c in ("codec_scores_ids.bulk", "scan_topk.wgmma")}})
    emit({"bench": rec})
    failures = [f"bench: {f}" for f in faults]
    missing = [key for key in bench.KEYS if key not in rec]
    if missing:
        failures.append(f"bench: keys missing from the record: {missing}")
    if rec["hnsw_recall"] < cfg.recall:
        failures.append(f"bench: hnsw_recall {rec['hnsw_recall']} < {cfg.recall}")
    if rec["exact_recall"] < RECALL_EXACT:
        failures.append(f"bench: exact_recall {rec['exact_recall']} < {RECALL_EXACT}")
    return failures


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
    """Dump the built index both ways and reload both onto the card; the
    reference-format dump and reload must take the native tier, and a second
    dump by the Python route must give the same bytes."""
    import filecmp

    from hnsw_tpu_torch import HnswIo, load_native
    from hnsw_tpu_torch.io import hnswio

    failures = []
    routes0 = dict(hnswio.ROUTES)
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
        routes = {k: hnswio.ROUTES[k] - routes0[k] for k in routes0}
        if routes["file_dump.native"] != 1 or routes["load_hnsw.native"] != 1:
            failures.append(f"file_dump / load_hnsw did not take the native route: {routes}")
        os.environ["HNSW_TPU_NATIVE_IO"] = "0"
        try:
            t_py = time.time()
            base_py = h.file_dump(tmp, "smoke_python")
            py_dump_s = time.time() - t_py
        finally:
            del os.environ["HNSW_TPU_NATIVE_IO"]
        if hnswio.ROUTES["file_dump.python"] - routes0["file_dump.python"] != 1:
            failures.append("the HNSW_TPU_NATIVE_IO=0 dump did not take the Python route")
        same = {ext: filecmp.cmp(os.path.join(tmp, base + ext),
                                 os.path.join(tmp, base_py + ext), shallow=False)
                for ext in (".hnsw.graph", ".hnsw.data")}
        if not all(same.values()):
            failures.append(f"native and Python dumps differ: {same}")
        sizes = {os.path.basename(p): os.path.getsize(p)
                 for p in (npz, os.path.join(tmp, base + ".hnsw.graph"),
                           os.path.join(tmp, base + ".hnsw.data"))}
        more, f = persist_more(torch, h, h3, tmp, base)
        failures += f
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
          "file_dump_python_s": py_dump_s, "routes": routes,
          "native_equals_python_bytes": same, "compare_s": compare_s,
          "bytes": sizes, "persist_more": more, "failures": failures})
    return h2, h3, failures


RECALL_NATIVE_EF64 = 0.97   # the native tier's host search of path 1's graph
RECALL_NATIVE20K = 0.95     # a native build of 20k rows, served on the card


def phase_native(torch, h, X, Q, kth, k=10, nq=4096):
    """The native tier on the host threads: path 1's graph searched by the
    C++ core, handed back to the card, and a native build served on the card."""
    from hnsw_tpu_torch import NativeHnsw
    from hnsw_tpu_torch.ops.beam_search import device_search_stream

    failures = []
    t0 = time.time()
    nh = NativeHnsw.from_hnsw(h)
    import_s = time.time() - t0
    ids, _ = nh.parallel_search(Q[:nq], k, 64)  # external ids: arange
    t0 = time.time()
    nh.parallel_search(Q[:nq], k, 64)
    host_qps = nq / (time.time() - t0)
    r_host = recall_fp64(X, Q, kth[:nq], ids, k)
    if r_host < RECALL_NATIVE_EF64:
        failures.append(f"native host search recall@10 at ef=64 {r_host:.4f} "
                        f"< {RECALL_NATIVE_EF64}")
    back = nh.to_hnsw()
    del nh
    served = {}
    for name, hh in (("built", h), ("to_hnsw", back)):
        i, _ = device_search_stream(hh, Q[:nq], k, 64, batch=16384, expand=4)
        served[name] = np.where(i >= 0, hh._origin[np.clip(i, 0, hh._nb_point - 1)], -1)
    same = float((served["built"] == served["to_hnsw"]).all(1).mean())
    if same < 1.0:
        failures.append(f"to_hnsw() served ids equal the built index's on {same:.5f} "
                        "of queries, not all")
    del back
    # a native build of path 1's first 20k rows, handed to the card
    n20 = 20_000
    t0 = time.time()
    nb = NativeHnsw(max_nb_connection=16, max_elements=n20, ef_construction=100)
    nb.parallel_insert(X[:n20], np.arange(n20))
    build20_s = time.time() - t0
    h20 = nb.to_hnsw()
    kth20 = matmul_kth(torch, X[:n20], Q[:nq], k)
    i20, _ = device_search_stream(h20, Q[:nq], k, 64, batch=16384, expand=4)
    i20 = np.where(i20 >= 0, h20._origin[np.clip(i20, 0, n20 - 1)], -1)
    r20 = recall_fp64(X[:n20], Q, kth20, i20, k)
    if r20 < RECALL_NATIVE20K:
        failures.append(f"native 20k build served on the card: recall@10 at ef=64 "
                        f"{r20:.4f} < {RECALL_NATIVE20K}")
    if h20.device.type != "cuda":
        failures.append("to_hnsw() did not place the index on the card")
    emit({"phase": "native", "queries": nq, "cpu_count": os.cpu_count(),
          "import_s": import_s, "host_recall_at_10_ef64": r_host, "host_qps": host_qps,
          "to_hnsw_ids_equal_frac": same,
          "build20k": {"n": n20, "M": 16, "efC": 100, "build_s": build20_s,
                       "card_recall_at_10_ef64": r20},
          "failures": failures})
    return failures


def phase_serve2(torch, h, h2, bf, X, Q, kth10):
    """Recall-critical serving from the reloaded index ``h2``."""
    from hnsw_tpu_torch.ops import kernel_lib
    from hnsw_tpu_torch.ops.beam_search import device_search_stream
    from hnsw_tpu_torch.ops.scan_topk import SCAN_GROUP, SCAN_TN, l2_topk_stream, scan_program

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
    q1 = torch.as_tensor(Q[:16384], device="cuda")
    prog = h2.device_program(len(q1), torch.float32,
                             **search_static(h2, 192, 100, expand=8, pool=256))
    out = {"k100": {"ef": 192, "expand": 8, "pool": 256, "recall_at_100": r100,
                    "ids_equal_built": bool(np.array_equal(ids_h, ids_h2)),
                    "qps": stream_qps(h2, 100, 192, **kw), "unrolled": prog.unrolled,
                    "replay_equals_direct": replay_equals_direct(torch, prog, q1)}}
    # (b) ef=256 through the unfused (B4) and the fused (B1) codec scores
    for name, fused, counter in (("unfused", False, "codec_scores_gathered"),
                                 ("fused", True, "codec_scores_ids")):
        # the first call builds the program (66 iterations: the chunked
        # form); launches and time are read on the second
        ids, _ = device_search_stream(h2, Q, 10, 256, batch=16384, expand=4,
                                      allow_fused=fused)
        before = kernel_lib.LAUNCHES[counter]
        torch.cuda.synchronize()
        t0 = time.time()
        device_search_stream(h2, Q, 10, 256, batch=16384, expand=4, allow_fused=fused)
        batch_ms = (time.time() - t0) * 1e3
        iters = kernel_lib.LAUNCHES[counter] - before
        prog = h2.device_program(len(q1), torch.float32,
                                 **search_static(h2, 256, 10, allow_fused=fused))
        out[name] = {"ef": 256, "expand": 4,
                     "recall_at_10": recall_fp64(X, Q, kth10, oids(h2, ids), 10),
                     "launches_per_batch": iters, "batch_ms": batch_ms,
                     "ms_per_iteration": batch_ms / max(iters, 1),
                     "qps": stream_qps(h2, 10, 256, expand=4, allow_fused=fused),
                     "chunks": prog.n_chunks,
                     "replay_equals_direct": replay_equals_direct(torch, prog, q1)}
    for name in ("k100", "unfused", "fused"):
        if not out[name]["replay_equals_direct"]:
            failures.append(f"serve2 {name}: the program's replay differs from the "
                            "direct call of its pieces")
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
    # engine's padded corpus, each a replay of its program from the engine's
    # cache (built by the first call); each program's replay against the
    # direct l2_topk call, and its launches
    Xd, xsq, Xscan, perm, acc, programs = bf._scan_device()
    nq = 4096
    exact, replays = {}, {}
    q2 = torch.as_tensor(Q[:EXACT_BATCH], device="cuda")
    for name, packed in (("unpacked", False), ("packed", True)):
        kw = dict(tn=SCAN_TN, group=SCAN_GROUP, acc=acc, overfetch=bf.SCAN_OVERFETCH,
                  packed=packed)
        _, idx = l2_topk_stream(Q[:nq], Xd, xsq, 100, Xscan=Xscan, batch=EXACT_BATCH,
                                programs=programs, **kw)
        torch.cuda.synchronize()
        t0 = time.time()
        l2_topk_stream(Q[:nq], Xd, xsq, 100, Xscan=Xscan, batch=EXACT_BATCH,
                       programs=programs, **kw)
        qps = nq / (time.time() - t0)
        exact[name] = (idx, qps)
        prog = scan_program(programs, Xd, xsq, EXACT_BATCH, torch.float32, Xscan=Xscan,
                            k=100, **kw)
        equal, launches = call_replay_equals_direct(torch, prog, q2)
        replays[name] = {"replay_equals_direct": equal, "launches_per_replay": launches}
        counter = "scan_topk" if packed else "scan_topk_unpacked"
        if not equal or launches != one_scan_launch(counter):
            failures.append(f"exact k=100 {name}: replay equals direct {equal}, launches "
                            f"a replay {launches}")
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
                         "packed_qps": exact["packed"][1], "programs": replays}
    emit({"phase": "serve2", "batch": 16384, "stream_queries": len(Qs), **out,
          "failures": failures})
    return out, failures


# ------------------------------------------------------------------ path 3 ----

RECALL_HAMMING_EF128 = 0.90  # 100k x 256-bit codes, recall@10 at ef=128
RECALL_SMALL_EF64 = 0.95     # each 10k metric, recall@10 at ef=64
# path 3's sizes, cut (from sift-256-hamming's 1M, and from 200k / 20k before
# the later lines took their seconds) to keep the script within its time
HAMMING_N = 100_000
METRIC_N = 10_000
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
    """Hamming on HAMMING_N 256-bit codes, built and served on the card."""
    from hnsw_tpu_torch import Hnsw, get_metric

    codes, qcodes = hamming_codes(X[:HAMMING_N], Q[:nq])
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
    prog = h.device_program(nq, torch.float32, **search_static(h, 128, k))
    program_equal = replay_equals_direct(
        torch, prog, torch.as_tensor(qcodes.astype(np.float32), device="cuda"))
    if not program_equal:
        failures.append("hamming: the program's replay differs from the direct call")
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
            "repair": h._repair_stats, "by_ef": by_ef, "scores_equal_oracle": exact,
            "replay_equals_direct": program_equal}, h, qcodes


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
    (``tests/test_torch_levenshtein_recall.py``), below the gate at 20k rows."""
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


_W16_ON = {}


def _w16(device):
    """The weights on ``device``, copied there once: the search replays the
    score form inside a CUDA graph, where a copy from the host is refused."""
    import torch
    w = _W16_ON.get(str(device))
    if w is None:
        w = _W16_ON[str(device)] = torch.as_tensor(_W16, device=device)
    return w


def _wl2_scores(q, C):
    w = _w16(q.device)
    diff = q[:, None, :].float() - C.float()
    return (w * diff * diff).sum(-1)


_WL2_MATMUL_CALLS = [0]      # calls of the weighted L2's matmul form (host side)


def _wl2_matmul(q, X, x_sqnorms=None):
    import torch
    _WL2_MATMUL_CALLS[0] += 1
    w = _w16(q.device)
    qf, Xf = q.float(), X.float()
    g = qf @ (w * Xf).T
    return torch.clamp_min((w * qf * qf).sum(-1)[:, None] - 2.0 * g
                           + (w * Xf * Xf).sum(-1)[None, :], 0.0)


def small_sets(X, Q, seed, n=METRIC_N, nq=1024):
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
        prog = h.device_program(len(Qs), torch.float32, **search_static(h, 64, k))
        program_equal = replay_equals_direct(
            torch, prog, torch.as_tensor(np.asarray(Qs, np.float32), device="cuda"))
        if not program_equal:
            failures.append(f"{m.name}: the program's replay differs from the direct call")
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
               "repair": h._repair_stats, "replay_equals_direct": program_equal,
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
IVF_REPLAY_LAUNCHES = {"id_scores": 1, "id_scores.f32": 1}  # the refine, a replay
# the exact scan (bf16, 32 finalists re-scored in f32) on the 1M clustered corpus
RECALL_EXACT_CLUSTERED = 0.99
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
    from hnsw_tpu_torch.ops.scan_topk import SCAN_GROUP, SCAN_TN, scan_program

    failures = []
    t0 = time.time()
    X, Q = f32_dataset("clustered", np.random.default_rng(seed), n, nq, 128, 16)
    data_s = time.time() - t0
    # the truth takes no engine under test: kernel B2 is scored against it
    kth = matmul_kth(torch, X, Q, k)
    bf = BruteForceIndex(dist="L2", device="cuda")
    bf.parallel_insert(X)
    if not bf._use_scan():
        raise RuntimeError("the 1M exact engine must take the scan (kernel B2)")
    ids_bf, _ = bf.search_batch(Q, k)
    torch.cuda.synchronize()
    t0 = time.time()
    bf.search_batch(Q, k)
    exact_qps = nq / (time.time() - t0)
    exact_recall = recall_fp64(X, Q, kth, ids_bf, k)
    if exact_recall < RECALL_EXACT_CLUSTERED:
        failures.append(f"exact-scan recall@10 on the clustered corpus {exact_recall:.5f} "
                        f"< {RECALL_EXACT_CLUSTERED}")
    # the IVF engine at its defaults; its k-means steps replay programs
    ix = IvfFlatIndex("L2", device="cuda")
    ix.parallel_insert(X)
    torch.cuda.synchronize()
    kmeans = kmeans_check(torch, X)
    failures += kmeans.pop("failures")
    t0 = time.time()
    with counted_kmeans_programs() as made:
        ix.build()
    torch.cuda.synchronize()
    build_s = time.time() - t0
    kmeans["build_programs_rows"] = made
    if not made:
        failures.append("ivf: the k-means steps of the build ran no program")
    L, cap = ix.n_lists, ix._built[6]
    by_np = {}
    for nprobe in (16, 32, 64):
        ids, _ = ix.search_batch(Q, k, nprobe=nprobe)
        torch.cuda.synchronize()
        t0 = time.time()
        ix.search_batch(Q, k, nprobe=nprobe)
        by_np[nprobe] = {"recall_at_10": recall_fp64(X, Q, kth, ids, k),
                         "qps": nq / (time.time() - t0)}
    # the IVF search as a captured program: each nprobe's 512-query program
    # replayed against a direct call of its pieces (one kernel of the repo's
    # runs in it: the refine's id_scores on the f32 slab), and the whole
    # search_batch against the eager form (the same chunks through the pieces
    # called op by op): ids and recall equal
    ivf_programs = {}
    qd = torch.as_tensor(ix._queries(Q[:512]), device="cuda")
    for nprobe in (16, 32, 64):
        prog = ix._program(512, torch.float32, *ix._probe_plan(k, 0, nprobe))
        equal, launches = call_replay_equals_direct(torch, prog, qd)
        ids_e, _ = eager_ivf_search(ix, Q, k, nprobe)
        r_e = recall_fp64(X, Q, kth, ids_e, k)
        ids_p, _ = ix.search_batch(Q, k, nprobe=nprobe)
        ivf_programs[nprobe] = {"replay_equals_direct": equal, "launches_per_replay": launches,
                                "ids_equal_eager": bool(np.array_equal(ids_p, ids_e)),
                                "eager_recall_at_10": r_e}
        if not (equal and launches == IVF_REPLAY_LAUNCHES
                and ivf_programs[nprobe]["ids_equal_eager"]
                and r_e == by_np[nprobe]["recall_at_10"]):
            failures.append(f"ivf program nprobe={nprobe}: {ivf_programs[nprobe]}, recall "
                            f"{by_np[nprobe]['recall_at_10']}")
    ivf_one = forms_timed(torch, {"program": lambda: ix.search_batch(Q, k, nprobe=32),
                                  "eager": lambda: eager_ivf_search(ix, Q, k, 32)})
    flt = even_ids_filter(n)
    got = ix.search_batch(Q, k, nprobe=32, filter=flt)
    ivf_filtered = {"equal_eager": answers_equal(got, eager_ivf_search(ix, Q, k, 32, flt)),
                    "ids_pass": filtered_ok(got[0], k)}
    if not all(ivf_filtered.values()):
        failures.append(f"ivf program, filtered: {ivf_filtered}")
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
    Xa, xsqa, Xsa, _, acca, pa = a.engine._scan_device()
    prog = scan_program(pa, Xa, xsqa, EXACT_BATCH, torch.float32, Xscan=Xsa, k=k,
                        tn=SCAN_TN, group=SCAN_GROUP, acc=acca,
                        overfetch=a.engine.SCAN_OVERFETCH, packed=True)
    auto_equal, auto_launches = call_replay_equals_direct(
        torch, prog, torch.as_tensor(Q[:EXACT_BATCH], device="cuda"))
    if not auto_equal or auto_launches != one_scan_launch("scan_topk"):
        failures.append(f"AutoIndex('L2')'s scan program: replay equals direct {auto_equal}, "
                        f"launches a replay {auto_launches}")
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
    # every engine's programs and their pools, released before the next path
    pools = {name: {"programs": len(eng._programs), "pool_bytes": eng._programs.pool_bytes()}
             for name, eng in (("exact", bf), ("ivf", ix), ("auto L2", a.engine),
                               ("auto Cosine", c.engine))}
    for eng in (bf, ix, a.engine, c.engine):
        eng.drop_programs()
    emit({"phase": "ivf", "n": n, "d": 128, "queries": nq, "data_s": data_s,
          "truth": "f32 matmul top-64 on the card, refined in fp64",
          "exact_recall_at_10": exact_recall, "exact_qps": exact_qps,
          "kmeans": kmeans,
          "ivf": {"build_s": build_s, "lists": L, "cap": cap,
                  "padding_share": 1.0 - n / (L * cap), "by_nprobe": by_np,
                  "programs": ivf_programs, "one_batch_nprobe32": ivf_one,
                  "filtered": ivf_filtered,
                  "stream": {"nprobe": 32, "batch": 8192, "qps": stream_qps,
                             "ids_equal_search_batch": stream_equal,
                             "ids_equal_f32_batch_frac": float(
                                 (ids_s == ix.search_batch(Q, k, nprobe=32)[0]).all(1).mean())}},
          "auto_l2": {"engine": eng_l2, "insert_build_s": auto_l2_s, "b2_launches": auto_b2,
                      "ids_equal_bruteforce": bool(np.array_equal(ids_a, ids_bf)),
                      "replay_equals_direct": auto_equal,
                      "launches_per_replay": auto_launches},
          "auto_cosine": {"engine": eng_cos, "insert_build_s": auto_cos_s,
                          "lists": c.engine.n_lists, "recall_at_10_nprobe32": r_cos},
          "pools": pools, "failures": failures})
    return failures, (ix, Q), (bf, X, Q, kth), auto_launches


KMEANS_CHUNK = 65536         # the IVF build's k-means chunk rows (``_kmeans``)
KMEANS_PSUM_RTOL = 1e-5      # the partial sums' float atomics add in any order


@contextlib.contextmanager
def counted_kmeans_programs():
    """The chunk rows of every k-means program built in this scope."""
    from hnsw_tpu_torch.models import ivf

    real, made = ivf.KmeansProgram, []
    ivf.KmeansProgram = lambda rows, C, d, device: made.append(rows) or real(rows, C, d, device)
    try:
        yield made
    finally:
        ivf.KmeansProgram = real


def kmeans_check(torch, X):
    """The IVF build's k-means step as a program at its full chunk shape
    (65536 rows, the build's C, d=128): one replay against a direct call on
    the same static inputs, assignments and alternates equal, partial sums
    within KMEANS_PSUM_RTOL of their largest magnitude, counts equal."""
    from hnsw_tpu_torch.ops.program import KmeansProgram

    n, d = X.shape
    C = int(np.clip(2 * np.sqrt(n), 16, 4096))
    Xc = torch.as_tensor(X[:KMEANS_CHUNK], device="cuda")
    cent = torch.as_tensor(X[::n // C][:C], device="cuda")
    csq = (cent * cent).sum(-1)
    prog = KmeansProgram(KMEANS_CHUNK, C, d, "cuda")
    got = prog.run(Xc, cent, csq)
    want = prog.fn(Xc, cent, csq)
    psum_err = float((got[2] - want[2]).abs().max() / want[2].abs().max())
    out = {"rows": KMEANS_CHUNK, "C": C, "pool_bytes": prog.pool_bytes,
           "assign_equal": bool(torch.equal(got[0], want[0])),
           "top4_equal": bool(torch.equal(got[1], want[1])),
           "psum_rel_err": psum_err, "pcnt_equal": bool(torch.equal(got[3], want[3]))}
    out["failures"] = [] if (out["assign_equal"] and out["top4_equal"] and out["pcnt_equal"]
                            and psum_err <= KMEANS_PSUM_RTOL) else [
        f"ivf: the k-means program's replay differs from its direct call: {out}"]
    return out


def scan_on_clustered(torch, bf, X, Q, kth, k=10):
    """B2 against its plain version on path 4's corpus and queries at the
    shape ``BruteForceIndex`` gives it (the shuffled, padded 1M corpus in bf16,
    2048-query batches), and where the exact scan's misses come from: the
    engine's answers through the kernel and through the plain version, an f32
    scan (B2's tf32x3 entry, every launch counted), and a wider overfetch,
    each scored against the
    matmul truth. Runs after path 4's counts are read: these are comparisons.
    Returns (the raw-output check, failures)."""
    from hnsw_tpu_torch.ops import kernel_lib
    from hnsw_tpu_torch.ops import scan_topk as st

    failures = []
    Xd, xsq, Xs, perm, acc, _ = bf._scan_device()
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
    ids, f32_launches = {}, None
    for name, kw in variants.items():
        before = dict(kernel_lib.LAUNCHES)
        ids[name] = answers(**kw)
        if name == "f32_scan":  # the full-precision scan: every launch tf32x3
            f32_launches = {c: v - before[c] for c, v in kernel_lib.LAUNCHES.items()
                            if v > before[c]}
            if (f32_launches.get("scan_topk.tf32x3", 0) == 0
                    or f32_launches.get("scan_topk.tf32x3") != f32_launches.get("scan_topk")):
                failures.append(f"path 4: the f32 scan's launches {f32_launches}, not all "
                                "tf32x3")
    recall = {name: recall_fp64(X, Q, kth, i, k) for name, i in ids.items()}
    same = float((np.sort(ids["kernel"], 1) == np.sort(ids["plain"], 1)).all(1).mean())
    if same < B2_SET_EQUAL:
        failures.append(f"path 4: B2's answers set-equal to its plain version's on "
                        f"{same:.4f} of queries")
    emit({"phase": "ivf_scan", "check": check, "recall_at_10": recall,
          "f32_scan_launches": f32_launches,
          "kernel_set_equal_plain_frac": same, "overfetch": of, "failures": failures})
    return check, failures


# ------------------------------------------------------------------ path 5 ----

N_SHARDS = 4
MESH_CHECK_ROWS = 20_000     # the program mesh build held against an eager one: 4 x 5k
MESH_CHECK_BATCH = 512       # rounds enough at one batch size to replay
RECALL_SHARDED_EF96 = 0.97
SET_EQUAL_EXACT = 0.999


def sharded_index(n, devices=None):
    """Path 5's ``ShardedHnsw`` for ``n`` rows: four shards, all on ``cuda:0``
    unless ``devices`` places them, path 1's graph settings on every shard."""
    from hnsw_tpu_torch import ShardedHnsw

    devices = devices or ["cuda:0"] * N_SHARDS
    sh = ShardedHnsw(devices=devices, max_nb_connection=24,
                     max_elements=n // len(devices) + 8, ef_construction=400, dist="L2")
    for s in sh.shards:
        s.set_keeping_pruned(True)
        s.modify_level_scale(0.5)
    return sh


@contextlib.contextmanager
def held_mesh_rounds(form):
    """Record, in the returned dict's ``tables``, every shard's (tables,
    in-degrees) of the mesh builds in this scope: through the round programs
    (``form="program"``) or the eager rounds, which the scope then runs."""
    from hnsw_tpu_torch.parallel import sharded

    held = {}
    real_round, real_fn = sharded.sharded_program_round, sharded.sharded_insert_round_fn

    def program_round(devices, programs, bts, *args):
        held["tables"] = [(bt.tables(), bt.indeg0) for bt in bts]
        return real_round(devices, programs, bts, *args)

    def eager_fn(devices, cfg):
        step = real_fn(devices, cfg)

        def recorded(*args):
            tables, indeg = step(*args)
            held["tables"] = [(tuple(t), i) for t, i in zip(tables, indeg)]
            return tables, indeg
        return recorded

    ctx = eager_rounds() if form == "eager" else contextlib.nullcontext()
    sharded.sharded_program_round, sharded.sharded_insert_round_fn = program_round, eager_fn
    try:
        with ctx:
            yield held
    finally:
        sharded.sharded_program_round, sharded.sharded_insert_round_fn = real_round, real_fn


def mesh_build_check(torch, X):
    """The mesh build through the shards' round programs against the eager
    mesh build (``round_step`` per shard) on the first MESH_CHECK_ROWS rows
    (4 shards x 5k) at batch MESH_CHECK_BATCH, so that rounds repeat their
    keys: every shard's tables and in-degrees bit-equal on its real rows,
    rounds replayed on every shard, both forms' seconds. Returns the line's
    dict (with its failures)."""
    Xs = X[:MESH_CHECK_ROWS]
    out, tables = {"rows": len(Xs), "shards": N_SHARDS, "batch": MESH_CHECK_BATCH}, {}
    for form in ("program", "eager"):
        with held_mesh_rounds(form) as held:
            torch.cuda.synchronize()
            t0 = time.time()
            sh = sharded_index(len(Xs))
            sh.parallel_insert(Xs, mode="mesh", batch_size=MESH_CHECK_BATCH)
            torch.cuda.synchronize()
        out[form] = {"build_s": time.time() - t0, "rounds": sh._mesh_rounds}
        tables[form] = held["tables"]
        if form == "program":
            out[form]["round_programs"] = sh._round_stats
            sizes = [s._nb_point for s in sh.shards]
    diffs = [tables_equal(torch, a, b, nb)
             for a, b, nb in zip(tables["program"], tables["eager"], sizes)]
    out["tables_equal_eager"] = all(e for e, _ in diffs)
    out["first_difference"] = next((d for e, d in diffs if not e), None)
    out["failures"] = [] if out["tables_equal_eager"] else [
        f"sharded: the program mesh build differs from the eager one: {out['first_difference']}"]
    for s, stats in enumerate(out["program"]["round_programs"]):
        out["failures"] += round_faults(f"sharded check shard {s}", stats)
    return out


def peaks_by_card_gb(devices):
    """Each card's peak allocated GB since its ``reset_peak_memory``."""
    from hnsw_tpu_torch.ops import program

    return {f"cuda:{c}": a / 1e9 for c, (a, _) in program.peak_memory_by_card(devices).items()}


def phase_sharded(torch, X, Q, kth, ids_bf, k=10):
    """Path 5: ``ShardedHnsw`` with four shards on one card, path 1's corpus
    and graph settings, the mesh build and the per-shard int8 codec (B3), the
    exact search (B2 on every shard), the manifest dump and reload. Returns
    (failures, the index, each shard's B2 launches a replay of its exact
    program)."""
    from hnsw_tpu_torch import ShardedHnsw
    from hnsw_tpu_torch.ops import kernel_lib, program

    failures = []
    n, nq = len(X), len(kth)
    mesh_check = mesh_build_check(torch, X)
    failures += mesh_check.pop("failures")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    program.reset_peak_memory()
    t0 = time.time()
    sh = sharded_index(n)
    sh.set_traversal_codec("i8")
    sh.parallel_insert(X, mode="mesh")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    peaks_gb = peaks_by_card_gb(sh.devices)
    for s, stats in enumerate(sh._round_stats):
        failures += round_faults(f"sharded shard {s}", stats)
    if any(d != torch.device("cuda", 0) for d in sh.devices):
        failures.append(f"path 5's shards are not all on cuda:0: {sh.devices}")
    blocks, _, scale, M0, _ = sh.device_codec_arrays()
    id_rows = [c.id_rows for c in sh._codecs()]
    if any(id_rows):
        failures.append(f"sharded: a shard's codec carries id rows: {id_rows}")
    by_ef, stream_ids = {}, None
    for ef in (64, 96):
        ids, _ = sh.search_stream(Q, k, ef, batch=16384)
        torch.cuda.synchronize()
        t0 = time.time()
        sh.search_stream(Q, k, ef, batch=16384)
        by_ef[ef] = {"recall_at_10": recall_fp64(X, Q, kth, ids, k),
                     "qps": len(Q) / (time.time() - t0)}
        stream_ids = ids
    if by_ef[96]["recall_at_10"] < RECALL_SHARDED_EF96:
        failures.append(f"sharded recall@10 at ef=96 {by_ef[96]['recall_at_10']:.4f} "
                        f"< {RECALL_SHARDED_EF96}")
    # the per-shard programs of ef 96 (chunked: a cap of 128 iterations), on
    # a warmed batch: B3 launches and wall time, then each shard's replay
    # against a direct call of its pieces
    q1 = torch.as_tensor(Q[:16384], device="cuda")
    st, programs, run = sh._search_fn(k, 96, None, 4, None)
    progs = programs(len(q1), torch.float32)
    # each shard's program reads its own snapshot (GraphArrays, no pivot set)
    # and its codec
    snapshots = all(p.g is g and g.pivot_ids is None and p.codec is c
                    for p, g, c in zip(progs, st.graphs, sh._codecs()))
    if not snapshots:
        failures.append("sharded: a shard's program does not hold its snapshot and codec")
    b3_before = kernel_lib.LAUNCHES["codec_scores"]
    torch.cuda.synchronize()
    t0 = time.time()
    run(q1)
    torch.cuda.synchronize()
    one_batch = {"wall_ms": (time.time() - t0) * 1e3,
                 "b3_launches": kernel_lib.LAUNCHES["codec_scores"] - b3_before,
                 "chunks": [p.n_chunks for p in progs],
                 "pool_bytes": sum(c.pool_bytes() for c in sh._programs),
                 "programs_hold_snapshots": snapshots,
                 "replay_equals_direct": [replay_equals_direct(torch, p, q1) for p in progs]}
    if not all(one_batch["replay_equals_direct"]):
        failures.append("sharded: a shard's program replay differs from the direct call")
    ids_b, _ = sh.search_batch(Q[:2048], k, 96)
    batch_equal = bool(np.array_equal(ids_b, stream_ids[:2048]))
    if not batch_equal:
        failures.append("sharded search_batch ids differ from search_stream's")
    # exact: auto must take the packed scan (B2) on every shard, once a shard
    # on a warmed call (the first builds every shard's program: a warm-up run
    # and a capture)
    sh.exact_search_batch(Q[:nq], k)
    before = kernel_lib.LAUNCHES["scan_topk"]
    torch.cuda.synchronize()
    t0 = time.time()
    ids_e, _ = sh.exact_search_batch(Q[:nq], k)
    exact_s = time.time() - t0
    b2 = kernel_lib.LAUNCHES["scan_topk"] - before
    if b2 != N_SHARDS:
        failures.append(f"exact_search_batch(auto) launched B2 {b2} times on a warmed "
                        "call, not once a shard")
    r_exact = recall_fp64(X, Q, kth, ids_e, k)
    eq_bf = float((np.sort(ids_e, 1) == np.sort(ids_bf[:nq], 1)).all(1).mean())
    if r_exact < RECALL_EXACT or eq_bf < SET_EQUAL_EXACT:
        failures.append(f"sharded exact: recall@10 {r_exact:.5f} (gate {RECALL_EXACT}), "
                        f"ids set-equal to BruteForceIndex's on {eq_bf:.5f} (gate "
                        f"{SET_EQUAL_EXACT})")
    ids_t, _ = sh.exact_search_batch(Q[:2048], k, mode="tiled")
    eq_tiled = float((np.sort(ids_t, 1) == np.sort(ids_e[:2048], 1)).all(1).mean())
    if eq_tiled < SET_EQUAL_EXACT:
        failures.append(f"sharded exact tiled vs auto: set-equal on {eq_tiled:.5f}")
    # each shard's exact program in both modes: the replay against a direct
    # call of its scan; B2 once a replay in the packed mode, nothing in the
    # tiled one (matmuls and sorts)
    exact_programs = {}
    for mode, nb, want in (("pallas", nq, one_scan_launch("scan_topk")), ("tiled", 2048, {})):
        qd = torch.as_tensor(Q[:nb], device="cuda")
        progs = [next(p for key, p in c._progs.items() if key[:3] == ("exact", mode, nb))
                 for c in sh._programs]
        res = [call_replay_equals_direct(torch, p, qd) for p in progs]
        exact_programs[mode] = {"batch": nb, "replay_equals_direct": [e for e, _ in res],
                                "launches_per_replay": [l for _, l in res],
                                "pool_bytes": [p.pool_bytes for p in progs]}
        if not all(e and l == want for e, l in res):
            failures.append(f"sharded exact {mode}: a shard's program replay differs from "
                            f"its direct call or launched other than {want}: {res}")
    # the manifest dump, reloaded onto the card
    from hnsw_tpu_torch.io import hnswio
    routes0 = dict(hnswio.ROUTES)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        t0 = time.time()
        sh.file_dump(tmp, "sharded")
        dump_s = time.time() - t0
        t0 = time.time()
        r = ShardedHnsw.load(tmp, "sharded", max_nb_connection=24,
                             max_elements=n // N_SHARDS + 8, ef_construction=400, dist="L2")
        load_s = time.time() - t0
    routes = {kk: hnswio.ROUTES[kk] - routes0[kk] for kk in routes0}
    r.set_traversal_codec("i8")
    ids_r, _ = r.search_batch(Q[:2048], k, 96)
    reload_equal = bool(np.array_equal(ids_r, ids_b))
    if not reload_equal:
        failures.append(f"the reloaded sharded index answers differently on "
                        f"{float((ids_r != ids_b).any(1).mean()):.5f} of queries")
    if any(d.type != "cuda" for d in r.devices):
        failures.append("the sharded reload is not on the card")
    del r
    emit({"phase": "sharded", "n": n, "shards": N_SHARDS,
          "devices": [str(d) for d in sh.devices], "build_s": build_s,
          "build_peak_mem_gb": max(peaks_gb.values()),
          "build_peak_mem_gb_by_card": peaks_gb, "round_programs": sh._round_stats,
          "mesh_build_check": mesh_check,
          "rounds": sh._mesh_rounds, "layer0_widths": [int(s._layers[0].width)
                                                       for s in sh.shards],
          "shard_sizes": [s._nb_point for s in sh.shards],
          "codec": {"M0": M0, "id_rows": id_rows, "scales": [float(x) for x in scale],
                    "blocks_shape": list(blocks[0].shape)},
          "by_ef": by_ef, "one_batch_ef96": one_batch, "batch_ids_equal_stream": batch_equal,
          "exact": {"queries": nq, "b2_launches": b2, "recall_at_10": r_exact,
                    "qps": nq / exact_s, "set_equal_bruteforce_frac": eq_bf,
                    "tiled_set_equal_frac": eq_tiled, "programs": exact_programs},
          "persist": {"file_dump_s": dump_s, "load_s": load_s, "routes": routes,
                      "ids_equal": reload_equal},
          "failures": failures})
    return failures, sh, exact_programs["pallas"]["launches_per_replay"]


# ------------------------------------------------- paths only the CPU had run ----

BUDGET_N = 20_000            # the build_budget line: 20k x 128 rows at batch 2048
BUDGET_BATCH = 2048


@contextlib.contextmanager
def budget_rounds(share, made):
    """Builds in this scope run their rounds through round programs whose
    pool is kept within ``share`` of the card (``program.round_programs(device,
    share)``); each build's ``BuildPrograms`` goes into ``made``."""
    from hnsw_tpu_torch.ops import program

    real = program.round_programs
    program.round_programs = lambda device, share_=program.POOL_SHARE: (
        made.append(real(device, share)) or made[-1])
    try:
        yield
    finally:
        program.round_programs = real


def phase_build_budget(torch, X):
    """The build's pool budget (``BuildPrograms.admit``): a key whose captures
    would take the pool past its share of the card runs uncaptured for the
    rest of the build. A 20k x 128 build at batch 2048 (path 1's graph
    settings) through the round programs at the default share measures every
    kind of part's peak; then the same build with the budget halfway between
    the smallest and the largest peak (some keys captured, some not) and with
    the budget below every peak (none captured). Every build bit-equal to the
    eager build of the same rows on every real row, and none raises. Returns
    the failures."""
    from hnsw_tpu_torch.ops import insert_rounds, program

    Xs = X[:BUDGET_N]
    total = torch.cuda.get_device_properties(0).total_memory
    seen = {}  # key -> (runs, peak) of the build's programs, after each round

    def keep_prog(args, out):
        seen.update({key: (p.runs, p.peak) for (_, key), p in args[0]._progs.items()})
        return args[1].tables(), args[1].indeg0

    with eager_rounds(), watched_rounds(torch, insert_rounds, "round_step", -1,
                                        lambda args, out: (tuple(args[3]), args[7])) as rec:
        _, eager_s, _ = build_path1(torch, Xs, BUDGET_BATCH)
    eager = rec["held"]
    failures, builds, shares = [], {}, {"default": program.POOL_SHARE}
    for label in ("default", "between", "below"):
        made = []
        seen.clear()
        try:
            with budget_rounds(shares[label], made), watched_rounds(
                    torch, program.BuildPrograms, "round", -1, keep_prog) as rec:
                h, build_s, peaks = build_path1(torch, Xs, BUDGET_BATCH)
        except RuntimeError as e:
            failures.append(f"build_budget {label}: the build raised: {e}")
            break
        stats = h._round_stats
        equal, diff = tables_equal(torch, eager, rec["held"], len(Xs))
        h = rec = None
        builds[label] = {"share": shares[label], "budget_bytes": shares[label] * total,
                         "tables_equal_eager": equal, "first_difference": diff,
                         "build_s": build_s, **peaks,
                         **{k: stats[k] for k in ("rounds", "rounds_replayed", "keys",
                                                  "captures", "uncaptured_keys",
                                                  "pool_bytes")},
                         "peaks": stats["peaks"], "uncaptured": stats["uncaptured"],
                         "pools": stats["pools"]}
        if not equal:
            failures.append(f"build_budget {label}: differs from the eager build: {diff}")
        if label == "default":
            # the peaks of the keys that reached their second run (the
            # cold start's keys run once and never decide)
            decided = [peak for runs, peak in seen.values() if runs > 1]
            lo, hi = min(decided), max(decided)
            builds[label]["decided_peaks"] = {"min": lo, "max": hi, "keys": len(decided)}
            shares["between"] = (lo + hi) / 2 / total
            shares["below"] = lo / 2 / total
        elif label == "between" and not (stats["captures"] >= 1
                                         and stats["uncaptured_keys"] >= 1):
            failures.append(f"build_budget between: {stats['captures']} keys captured, "
                            f"{stats['uncaptured_keys']} uncaptured: wanted both")
        elif label == "below" and not (stats["captures"] == 0
                                       and stats["uncaptured_keys"] >= 1
                                       and stats["rounds_replayed"] == 0):
            failures.append(f"build_budget below: {stats['captures']} captures, "
                            f"{stats['uncaptured_keys']} keys uncaptured: wanted none "
                            "captured")
    emit({"phase": "build_budget", "n": len(Xs), "d": Xs.shape[1], "batch": BUDGET_BATCH,
          "eager_build_s": eager_s, "builds": builds, "failures": failures})
    return failures


# What the reference's dryrun body answers at 4 devices for its int8-codec
# self-retrieval (``ids3[:, 0]``; the JAX package on its 4-device CPU mesh):
# query 5 finds 136, so the body's assertion holds at 8 devices only
# (``tests/test_torch_graft_entry.py`` holds the port's answer to it).
REFERENCE_DRYRUN4_IDS3 = [0, 1, 2, 3, 4, 136, 6, 7]


def phase_graft(torch):
    """The graft entry points of the port (``hnsw_tpu_torch/graft_entry.py``)
    on the card: ``entry()``'s ``fn(*args)`` replayed through a
    ``SearchProgram`` (``compiled``) equal to the direct call, bit for bit,
    as given (no codec: the reference's entry) and with the index's int8
    codec bound in (d = 32: no id rows, so the codec kernel runs as B3, and
    its launches are read on a warmed replay); then ``dryrun_multichip(8)``,
    eight shards on ``cuda:0``, every assertion of the reference's body (the
    reference runs it on 8 devices), and ``dryrun_multichip(4)``, which must
    stop where the reference's body stops at 4 devices, at the int8
    self-retrieval, with the reference's ids. Returns the failures."""
    import functools

    from hnsw_tpu_torch import graft_entry
    from hnsw_tpu_torch.ops import kernel_lib
    from hnsw_tpu_torch.ops.graph_arrays import BeamCodec

    failures, forms = [], {}
    t0 = time.time()
    fn, args = graft_entry.entry()
    for name, f in (("entry", fn),
                    ("entry_i8", functools.partial(fn, codec=BeamCodec.build(args[0], "i8")))):
        run = graft_entry.compiled(f, args)
        run(*args)
        before = dict(kernel_lib.LAUNCHES)
        got = run(*args)
        launches = {c: v - before[c] for c, v in kernel_lib.LAUNCHES.items() if v != before[c]}
        want = f(*args)
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        forms[name] = {"replay_equals_direct": equal, "launches_per_replay": launches,
                       "shape": list(got[0].shape)}
        if not equal:
            failures.append(f"graft {name}: the replay differs from the direct call")
    if not forms["entry_i8"]["launches_per_replay"].get("codec_scores"):
        failures.append("graft entry_i8: the replay launched no codec kernel")
    entry_s = time.time() - t0
    dryrun = {}
    for n in (8, 4):
        t0 = time.time()
        try:
            graft_entry.dryrun_multichip(n)
            stop = None
        except AssertionError as e:
            stop = np.asarray(e.args[0]).tolist() if e.args else repr(e)
        dryrun[n] = {"passed": stop is None, "stopped_at_ids3": stop,
                     "seconds": time.time() - t0, "devices": [f"cuda:{i % torch.cuda.device_count()}"
                                                               for i in range(n)]}
    if not dryrun[8]["passed"]:
        failures.append(f"graft dryrun_multichip(8): an assertion failed: "
                        f"{dryrun[8]['stopped_at_ids3']}")
    if dryrun[4]["stopped_at_ids3"] != REFERENCE_DRYRUN4_IDS3:
        failures.append(f"graft dryrun_multichip(4): {dryrun[4]}, not the reference's stop "
                        f"at ids {REFERENCE_DRYRUN4_IDS3}")
    emit({"phase": "graft", "forms": forms, "entry_s": entry_s, "dryrun": dryrun,
          "failures": failures})
    return failures


# ---------------------------------------------------------------- the cards ----

CARDS_MIN = 2                # the cards phase refuses to run on fewer visible cards
CARDS_SCALE_N = 4_000_000    # 4 x 1M rows: bench run b's size on every card
CARDS_BATCH = 16384          # bench run b's build and serve batch
CARDS_STREAM_COPIES = 4      # the equality stream: path 1's 16384 queries four times
CARDS_EFS = (64, 96, 128)
CARDS_TIMED = 3              # timed calls of each scale search (median)
CARDS_TRACE_ROUND = 20       # a steady round of the 4 x 1M build (B=16384, keys replayed)
CARDS_EXACT_Q = 4096
RECALL_CARDS_EF96 = 0.97


def card_lines():
    """nvidia-smi's "name, power limit" of every card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines() if smi.returncode == 0 else ["unknown"]


def sync_cards(torch, devices):
    """``torch.cuda.synchronize`` of every card of ``devices`` (a bare call
    waits on the current card alone)."""
    from hnsw_tpu_torch.ops import program

    for c in program.cards(devices):
        torch.cuda.synchronize(c)


def busy_by_card(spans):
    """{"cuda:<c>": busy ms} from device activities ``(card, start ns, end
    ns)``: the union of each card's intervals, so activities that overlap on
    one card count once."""
    out = {}
    for card in sorted({c for c, _, _ in spans}):
        busy, end = 0, None
        for a, b in sorted((a, b) for c, a, b in spans if c == card):
            if end is None or a > end:
                busy, end = busy + b - a, b
            elif b > end:
                busy, end = busy + b - end, b
        out[f"cuda:{card}"] = busy / 1e6
    return out


def trace_cards(torch, fn, devices):
    """``fn`` once under torch.profiler, device activity alone: the wall ms
    to every card's end, each card's busy ms and the cards' busy time summed
    over the wall (at most the number of cards: each card busy all along)."""
    from torch.profiler import ProfilerActivity, profile

    sync_cards(torch, devices)
    prof = profile(activities=[ProfilerActivity.CUDA])
    with prof:
        t0 = time.time()
        fn()
        sync_cards(torch, devices)
        wall_ms = (time.time() - t0) * 1e3
    busy = busy_by_card([(e.device_index(), e.start_ns(), e.end_ns())
                         for e in prof.profiler.kineto_results.events()
                         if e.device_type() == torch.autograd.DeviceType.CUDA
                         and not e.is_user_annotation()])
    return {"wall_ms": wall_ms, "busy_ms_by_card": busy,
            "busy_sum_over_wall": sum(busy.values()) / wall_ms}


@contextlib.contextmanager
def watched_mesh_rounds(torch, devices, at):
    """Run each call of the mesh build's round function between two
    synchronizes of every card, timed on the host clock, and call ``at``
    (from 0) inside ``trace_cards``; the returned dict holds the rounds'
    walls, that call's trace, its wall with the profiler's own start and stop
    (``total_ms``), and the host clock at the first round's start and the
    last round's end (what precedes them is the build's set-up, what follows
    its flush)."""
    from hnsw_tpu_torch.parallel import sharded

    real = sharded.sharded_program_round
    rec = {"walls_ms": [], "trace": None, "total_ms": None, "first": None, "last": None}

    def watched(*args):
        sync_cards(torch, devices)
        t0 = time.time()
        rec["first"] = rec["first"] or t0
        if len(rec["walls_ms"]) == at:
            rec["trace"] = trace_cards(torch, lambda: real(*args), devices)
        else:
            real(*args)
        sync_cards(torch, devices)
        rec["last"] = time.time()
        rec["walls_ms"].append((rec["last"] - t0) * 1e3)
        if len(rec["walls_ms"]) == at + 1:
            rec["total_ms"] = rec["walls_ms"][-1]

    sharded.sharded_program_round = watched
    try:
        yield rec
    finally:
        sharded.sharded_program_round = real


def mesh_build_timed(torch, X, devices, ids=None):
    """``sharded_index`` on ``devices`` with the int8 codec, built with
    ``mode="mesh"`` at batch CARDS_BATCH, every round watched
    (``watched_mesh_rounds``, round CARDS_TRACE_ROUND traced). Returns the
    index and its line: build seconds less the profiler's own, the set-up
    (the host states and uploads before the first round), the rounds, the
    flush (the tables back into the host graphs), the first runs (rounds
    before STEADY_FROM: the ramp's batch sizes and each key's uncaptured
    first run and capture), the steady rounds' median, the traced round,
    what each card held before and its peak, and the round programs'
    counts."""
    from hnsw_tpu_torch.ops import program

    held = {f"cuda:{c}": torch.cuda.memory_allocated(c) / 1e9 for c in program.cards(devices)}
    for c in program.cards(devices):
        program.reset_peak_memory(c)
    sync_cards(torch, devices)
    t0 = time.time()
    with watched_mesh_rounds(torch, devices, CARDS_TRACE_ROUND) as rec:
        sh = sharded_index(len(X), devices)
        sh.set_traversal_codec("i8")
        sh.parallel_insert(X if ids is None else (X, ids), mode="mesh",
                           batch_size=CARDS_BATCH)
    sync_cards(torch, devices)
    t1 = time.time()
    walls = rec["walls_ms"]
    profiler_s = (rec["total_ms"] - rec["trace"]["wall_ms"]) / 1e3 if rec["trace"] else 0.0
    steady = [w for r, w in enumerate(walls) if r >= STEADY_FROM and r != CARDS_TRACE_ROUND]
    peaks = peaks_by_card_gb(devices)
    return sh, {
        "devices": [str(x) for x in sh.devices], "shard_sizes": [x._nb_point for x in sh.shards],
        "build_s": t1 - t0 - profiler_s, "build_s_with_profiler": t1 - t0,
        "setup_s": rec["first"] - t0, "rounds_s": sum(walls) / 1e3 - profiler_s,
        "flush_s": t1 - rec["last"], "rounds": len(walls),
        "first_runs_s": sum(walls[:STEADY_FROM]) / 1e3,
        "steady_round_ms_median": float(np.median(steady)) if steady else None,
        "round_ms": [round(w, 1) for w in walls],
        "traced_round": {"round": CARDS_TRACE_ROUND, **(rec["trace"] or {})},
        "held_before_gb_by_card": held, "build_peak_mem_gb_by_card": peaks,
        "round_programs": [{key: st[key] for key in (
            "rounds", "rounds_replayed", "captures", "uncaptured_keys", "pool_bytes",
            "capture_s")} for st in sh._round_stats]}


def to_device(torch, held, device):
    """A build's held ``(tables, indeg0)`` copied to ``device``."""
    tables, indeg = held
    return [(i.to(device), d.to(device)) for i, d in tables], indeg.to(device)


def card_answers(torch, sh, X, Q, k=10):
    """What the cards phase holds bit for bit across placements, on one
    index: ``search_batch`` of path 1's 16384 queries at ef 64 and 96, the
    65,536-query stream at ef 96 (f16 ingest, batches of 16384; its QPS on
    the second call), a filtered search (the even ids), ``exact_search_batch``
    at k=10 and k=100. Returns ({name: (ids, dists)}, stream QPS, seconds)."""
    t_all = time.time()
    out = {f"batch_ef{ef}": sh.search_batch(Q, k, ef) for ef in (64, 96)}
    Qs = np.concatenate([Q] * CARDS_STREAM_COPIES)
    sh.search_stream(Qs[:CARDS_BATCH], k, 96, batch=CARDS_BATCH, query_dtype="f16")
    sync_cards(torch, sh.devices)
    t0 = time.time()
    out["stream_ef96"] = sh.search_stream(Qs, k, 96, batch=CARDS_BATCH, query_dtype="f16")
    qps = len(Qs) / (time.time() - t0)
    out["filtered_ef96"] = sh.search_batch(Q[:2048], k, 96, filter=even_ids_filter(len(X)))
    for kk in (10, 100):
        out[f"exact_k{kk}"] = sh.exact_search_batch(Q[:CARDS_EXACT_Q], kk)
    return out, qps, time.time() - t_all


def launches_on_cards(before, cards):
    """{"cuda:<c>": {counter: launches}} since ``before`` (a copy of
    ``kernel_lib.CARD_LAUNCHES``), for B3 and B2 and their entries."""
    from hnsw_tpu_torch.ops import kernel_lib

    keep = ("codec_scores", "codec_scores.bulk", "scan_topk", "scan_topk.wgmma")
    return {f"cuda:{c}": {key: kernel_lib.CARD_LAUNCHES.get((c, key), 0) - before.get((c, key), 0)
                          for key in keep} for c in cards}


def cards_equality(torch, X, Q, kth, one, many, k=10):
    """Path 5's index (200k x 128, 4 shards, M=24, efC 400) built twice in
    this process, its shards on ``one`` (cuda:0 x 4) and on ``many`` (one a
    card): tables, in-degrees, codec blocks, squared norms and scales, every
    answer of ``card_answers``, the manifest dumps' bytes and the reloads
    onto the other placement, each bit for bit; B3 and B2 launched on every
    card of ``many`` (all ``bulk`` and ``wgmma``). Returns (line, failures)."""
    import filecmp

    from hnsw_tpu_torch import ShardedHnsw
    from hnsw_tpu_torch.ops import kernel_lib, program

    failures, forms, built = [], {}, {}
    for name, devs in (("one_card", one), ("cards", many)):
        for c in program.cards(devs):
            program.reset_peak_memory(c)
        before = dict(kernel_lib.CARD_LAUNCHES)
        sync_cards(torch, devs)
        t0 = time.time()
        with held_mesh_rounds("program") as held:
            sh = sharded_index(len(X), devs)
            sh.set_traversal_codec("i8")
            sh.parallel_insert(X, mode="mesh")
        sync_cards(torch, devs)
        build_s = time.time() - t0
        codec = sh.device_codec_arrays()
        answers, qps, answers_s = card_answers(torch, sh, X, Q, k)
        sh.search_batch(Q, k, 96)  # warm, then one batch traced
        trace = trace_cards(torch, lambda: sh.search_batch(Q, k, 96), devs)
        forms[name] = {"devices": [str(d) for d in sh.devices], "build_s": build_s,
                       "rounds": sh._mesh_rounds, "answers_s": answers_s,
                       "stream_qps_ef96": qps, "peak_mem_gb_by_card": peaks_by_card_gb(devs),
                       "search_batch_ef96_trace": trace,
                       "launches_by_card": launches_on_cards(before, program.cards(devs))}
        if kth is not None:
            forms[name]["recall_at_10_ef96"] = recall_fp64(X, Q, kth, answers["batch_ef96"][0], k)
        for s, stats in enumerate(sh._round_stats):
            failures += round_faults(f"cards {name} shard {s}", stats)
        built[name] = (sh, held["tables"], codec, answers)
    (sh_a, tab_a, cod_a, ans_a), (sh_b, tab_b, cod_b, ans_b) = built["one_card"], built["cards"]
    dev0 = torch.device("cuda", 0)
    sizes = [s._nb_point for s in sh_a.shards]
    tables = [tables_equal(torch, a, to_device(torch, b, dev0), n)
              for a, b, n in zip(tab_a, tab_b, sizes)]
    codec_equal = [all(torch.equal(x[s], y[s].to(dev0)) for x, y in zip(cod_a[:3], cod_b[:3]))
                   for s in range(N_SHARDS)] if cod_a and cod_b else [False]
    # each shard's search snapshot (GraphArrays): the same tensors and fields
    snapshots_equal = [
        all(torch.equal(x, y.to(dev0)) for x, y in zip((ga.vectors, ga.sqnorms, *ga.layer_ids),
                                                      (gb.vectors, gb.sqnorms, *gb.layer_ids)))
        and (ga.entry, ga.n, ga.cap1, ga.entry_level, ga.layer_nonempty)
        == (gb.entry, gb.n, gb.cap1, gb.entry_level, gb.layer_nonempty)
        for ga, gb in zip(sh_a.searcher().graphs, sh_b.searcher().graphs)]
    answers = {key: answers_equal(ans_a[key], ans_b[key]) for key in ans_a}
    wrong_place = [str(d) for s, d in enumerate(sh_b.devices) if d != many[s]]
    # the manifest dumps (equal builds: equal bytes), each reloaded onto the
    # other placement and answering as the other reload does
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cards_") as tmp:
        dirs = {name: os.path.join(tmp, name) for name in built}
        for name, (sh, *_) in built.items():
            os.makedirs(dirs[name])
            sh.file_dump(dirs[name], "cards")
        files = sorted(os.listdir(dirs["one_card"]))
        dumps_equal = (files == sorted(os.listdir(dirs["cards"])) and all(
            filecmp.cmp(os.path.join(dirs["one_card"], f), os.path.join(dirs["cards"], f),
                        shallow=False) for f in files))
        reload = {}
        for name, src, devs in (("one_card_to_cards", "one_card", many),
                                ("cards_to_one_card", "cards", one)):
            r = ShardedHnsw.load(dirs[src], "cards", devices=devs, max_nb_connection=24,
                                 max_elements=len(X) // N_SHARDS + 8, ef_construction=400,
                                 dist="L2")
            r.set_traversal_codec("i8")
            reload[name] = (r.search_batch(Q[:2048], k, 96), [str(d) for d in r.devices])
            del r
    source_ids = ans_a["batch_ef96"][0][:2048]
    reload_line = {
        name: {"devices": devs, "ids_equal_source": bool(np.array_equal(ans[0], source_ids))}
        for name, (ans, devs) in reload.items()}
    reload_equal = answers_equal(reload["one_card_to_cards"][0], reload["cards_to_one_card"][0])
    launches = forms["cards"]["launches_by_card"]
    missing = {c: v for c, v in launches.items()
               if not (v["codec_scores"] and v["scan_topk"]
                       and v["codec_scores.bulk"] == v["codec_scores"]
                       and v["scan_topk.wgmma"] == v["scan_topk"])}
    line = {"n": len(X), "shards": N_SHARDS, "forms": forms,
            "tables_equal": [e for e, _ in tables],
            "first_difference": next((d for e, d in tables if not e), None),
            "codec_equal": codec_equal, "snapshots_equal": snapshots_equal,
            "answers_equal": answers,
            "dumps_byte_equal": dumps_equal, "reload": reload_line,
            "reloads_equal": reload_equal}
    if len(program.cards(many)) < CARDS_MIN or wrong_place:
        failures.append(f"cards: the shards are not spread over the cards: {many}, "
                        f"misplaced {wrong_place}")
    if not all(e for e, _ in tables):
        failures.append(f"cards: the builds' tables differ: {line['first_difference']}")
    if not all(codec_equal):
        failures.append(f"cards: the codecs differ by shard: {codec_equal}")
    if not all(snapshots_equal):
        failures.append(f"cards: the search snapshots differ by shard: {snapshots_equal}")
    if not all(answers.values()):
        failures.append(f"cards: answers differ across placements: {answers}")
    if not dumps_equal:
        failures.append("cards: the two placements' dumps differ")
    if not reload_equal or not all(r["ids_equal_source"] for r in reload_line.values()):
        failures.append(f"cards: the reloads answer differently: {reload_line}, "
                        f"equal to each other {reload_equal}")
    if missing:
        failures.append(f"cards: B3 and B2 (bulk, wgmma) not launched on every card: {missing}")
    if kth is not None and forms["cards"]["recall_at_10_ef96"] < RECALL_CARDS_EF96:
        failures.append(f"cards: recall@10 at ef 96 {forms['cards']['recall_at_10_ef96']:.5f}")
    for sh, *_ in built.values():
        for c in sh._programs:
            c.clear()
    return line, failures


def served(torch, sh, X, Q, kth, k=10, to_rows=None):
    """Streamed recall@10 and QPS of ``sh`` at CARDS_EFS (f16 ingest, batch
    16384: a warm call, then CARDS_TIMED timed calls, median), scored as path
    1 (``to_rows`` maps the answered ids to rows of ``X``)."""
    by_ef = {}
    for ef in CARDS_EFS:
        ids, _ = sh.search_stream(Q, k, ef, batch=CARDS_BATCH, query_dtype="f16")
        walls = []
        for _ in range(CARDS_TIMED):
            sync_cards(torch, sh.devices)
            t0 = time.time()
            sh.search_stream(Q, k, ef, batch=CARDS_BATCH, query_dtype="f16")
            walls.append(time.time() - t0)
        rows = ids if to_rows is None else to_rows(ids)
        by_ef[ef] = {"recall_at_10": recall_fp64(X, Q, kth, rows, k),
                     "qps": len(Q) / float(np.median(walls)),
                     "qps_each": [len(Q) / w for w in walls]}
    return by_ef


def truth(torch, X, Q, k=10):
    """fp64 k-th distances of the first 4096 queries over ``X`` (path 1's
    method: a ``BruteForceIndex`` top-64 pool on cuda:0, refined on the
    host) and the seconds they took."""
    from hnsw_tpu_torch import BruteForceIndex

    t0 = time.time()
    bf = BruteForceIndex(dist="L2", device="cuda:0")
    bf.parallel_insert(X)
    kth = kth_fp64(bf, X, Q, min(len(Q), 4096), k, 64)
    bf.drop_programs()
    del bf
    torch.cuda.empty_cache()
    return kth, time.time() - t0


def cards_scale(torch, seed, many, k=10):
    """4 x 1M rows of bench.py's gauss corpus (seed ``seed``) sharded one
    shard a card at bench run b's settings (M=24, efC 400, level scale 0.5,
    kept pruned links, batch 16384, int8 codec; ``mesh_build_timed``);
    streamed recall@10 and QPS at ef 64 / 96 / 128 and the exact search's
    against a 4M truth; one search batch traced; then shard 0's rows built
    and served alone on cuda:0 the same way, in the same process. Returns
    (line, failures)."""
    from hnsw_tpu_torch.ops import program

    failures, n, d, nq = [], CARDS_SCALE_N, 128, 16384
    t0 = time.time()
    X, Q = f32_dataset("gauss", np.random.default_rng(seed), n, nq, d, 16)
    line = {"n": n, "d": d, "queries": nq, "data_s": time.time() - t0}
    sh, built = mesh_build_timed(torch, X, many)
    for s, stats in enumerate(sh._round_stats):
        failures += round_faults(f"cards scale shard {s}", stats)
    kth, line["truth_s"] = truth(torch, X, Q, k)
    by_ef = served(torch, sh, X, Q, kth, k)
    sh.exact_search_batch(Q[:CARDS_EXACT_Q], k)
    walls = []
    for _ in range(CARDS_TIMED):
        sync_cards(torch, many)
        t0 = time.time()
        ids_e, _ = sh.exact_search_batch(Q[:CARDS_EXACT_Q], k)
        walls.append(time.time() - t0)
    sh.search_batch(Q, k, 96)
    line["sharded"] = dict(
        built, by_ef=by_ef, exact={"queries": CARDS_EXACT_Q,
                                   "recall_at_10": recall_fp64(X, Q, kth, ids_e, k),
                                   "qps": CARDS_EXACT_Q / float(np.median(walls))},
        search_batch_ef96_trace=trace_cards(torch, lambda: sh.search_batch(Q, k, 96), many),
        peak_mem_gb_by_card=peaks_by_card_gb(many))
    if by_ef[96]["recall_at_10"] < RECALL_CARDS_EF96:
        failures.append(f"cards scale: recall@10 at ef 96 {by_ef[96]['recall_at_10']:.5f} "
                        f"< {RECALL_CARDS_EF96}")
    if line["sharded"]["exact"]["recall_at_10"] < RECALL_EXACT:
        failures.append(f"cards scale: exact recall@10 "
                        f"{line['sharded']['exact']['recall_at_10']:.5f} < {RECALL_EXACT}")
    for c in sh._programs:
        c.clear()
    del sh
    torch.cuda.empty_cache()
    # shard 0's rows (the strided split's) built and served alone on cuda:0
    one = [torch.device("cuda", 0)]
    X0, ids0 = np.ascontiguousarray(X[0::N_SHARDS]), np.arange(0, n, N_SHARDS)
    sh1, built1 = mesh_build_timed(torch, X0, one, ids0)
    kth0, _ = truth(torch, X0, Q, k)
    by_ef1 = served(torch, sh1, X0, Q, kth0, k,
                    to_rows=lambda ids: np.where(ids >= 0, ids // N_SHARDS, -1))
    sh1.search_batch(Q, k, 96)
    line["one_card_shard0"] = dict(
        built1, by_ef=by_ef1,
        search_batch_ef96_trace=trace_cards(torch, lambda: sh1.search_batch(Q, k, 96), one),
        peak_mem_gb_by_card=peaks_by_card_gb(one))
    line["four_over_one"] = {
        key: line["sharded"][key] / built1[key]
        for key in ("build_s", "setup_s", "rounds_s", "flush_s", "first_runs_s",
                    "steady_round_ms_median")}
    line["four_over_one"]["qps_by_ef"] = {ef: by_ef[ef]["qps"] / by_ef1[ef]["qps"]
                                          for ef in CARDS_EFS}
    for c in sh1._programs:
        c.clear()
    return line, failures


def phase_cards(torch, X, Q, kth, seed, parts, k=10):
    """The sharded tier with one shard a card (``default_devices``: 4 shards
    dealt round-robin over the visible cards, so two a card on two cards):
    ``cards_equality`` at path 5's size against the same shards on cuda:0,
    then ``cards_scale`` at 4 x 1M rows, each where ``parts`` names it.
    Returns the failures."""
    from hnsw_tpu_torch.parallel.sharded import default_devices

    many = default_devices(N_SHARDS)
    one = [torch.device("cuda", 0)] * N_SHARDS
    names = card_lines()
    failures = []
    if "equality" in parts:
        eq, failures = cards_equality(torch, X, Q, kth, one, many, k)
        emit({"phase": "cards", "part": "equality", "cards": names, **eq,
              "failures": failures})
        torch.cuda.empty_cache()
    if "scale" not in parts:
        return failures
    scale, f = cards_scale(torch, seed, many, k)
    emit({"phase": "cards", "part": "scale", "cards": names, **scale, "failures": f})
    return failures + f


RECALL_FILTER_EF96 = 0.95
FILTER_CPU_QUERIES = 256
FILTER_CPU_AGREE = 0.99


def phase_filters(torch, h, bf, X, Q, k=10, ef=96, nq=4096, nhost=64):
    """Filtered graph search on path 1's index, with the even ids and with a
    sorted id range (the middle half): ``device_search_stream`` (the program
    with its mask) over 4096 queries and ``Hnsw.search_filter`` (the host
    search) over 64; no returned id may fail the filter; recall@10 against
    ``BruteForceIndex``'s exact answers under the same filter; and the same
    stream on a CPU copy of the index (``to_arrays`` / ``from_arrays``) must
    answer the same id set on 99% of 256 queries. Returns the failures."""
    from hnsw_tpu_torch import SortedIdFilter, from_arrays, to_arrays
    from hnsw_tpu_torch.convert import params_of
    from hnsw_tpu_torch.ops.beam_search import device_search_stream

    n = len(X)
    failures, out = [], {}
    cpu = from_arrays(to_arrays(h), params_of(h), device="cpu")
    Qf = Q[:nq]
    for name, keep in (("even", np.arange(0, n, 2)), ("range", np.arange(n // 4, 3 * n // 4))):
        flt, allowed = SortedIdFilter(keep), np.zeros(n, bool)
        allowed[keep] = True
        exact, _ = bf.search_batch(Qf, k, filter=flt)
        t0 = time.time()
        ids, _ = device_search_stream(h, Qf, k, ef, batch=nq, filter=flt)
        stream_s = time.time() - t0
        oid = np.where(ids >= 0, h._origin[np.clip(ids, 0, h._nb_point - 1)], -1)
        recall = float(np.mean([len(set(oid[b]) & set(exact[b])) / k for b in range(nq)]))
        host = [h.search_filter(Qf[b], k, ef, filter=flt) for b in range(nhost)]
        host_ids = [[r.d_id for r in res] for res in host]
        host_recall = float(np.mean([len(set(host_ids[b]) & set(exact[b])) / k
                                     for b in range(nhost)]))
        leaked = int((~allowed[oid[oid >= 0]]).sum()) + sum(
            int(not allowed[i]) for row in host_ids for i in row)
        full = bool((oid >= 0).all()) and all(len(r) == k for r in host_ids)
        ids_cpu, _ = device_search_stream(cpu, Qf[:FILTER_CPU_QUERIES], k, ef,
                                          batch=FILTER_CPU_QUERIES, filter=flt)
        oid_cpu = np.where(ids_cpu >= 0, cpu._origin[np.clip(ids_cpu, 0, n - 1)], -1)
        agree = float(np.mean([set(oid[b]) == set(oid_cpu[b])
                               for b in range(FILTER_CPU_QUERIES)]))
        out[name] = {"kept": len(keep), "recall_at_10": recall, "host_recall_at_10": host_recall,
                     "leaked": leaked, "rows_full": full, "stream_s": stream_s,
                     "cpu_copy_agreement": agree}
        if leaked or not full:
            failures.append(f"filters {name}: {leaked} ids leaked, rows full {full}")
        if min(recall, host_recall) < RECALL_FILTER_EF96:
            failures.append(f"filters {name}: recall@10 {recall:.4f} (stream), "
                            f"{host_recall:.4f} (host) < {RECALL_FILTER_EF96} at ef {ef}")
        if agree < FILTER_CPU_AGREE:
            failures.append(f"filters {name}: the CPU copy agrees on {agree:.4f} of "
                            f"{FILTER_CPU_QUERIES} queries < {FILTER_CPU_AGREE}")
    emit({"phase": "filters", "n": n, "ef": ef, "queries": nq, "host_queries": nhost,
          "by_filter": out, "failures": failures})
    return failures


def persist_more(torch, h, h3, tmp, base):
    """On path 2's reference-format dump (``base`` in ``tmp``): the data file
    through ``io/datamap.py``'s ``DataMap`` must give every vector byte-equal
    to the index's row of that id; a Light dump of the same index reloaded
    (``HnswIo.load_hnsw``, the Python route) must hold every layer's table
    equal to the Full reload's (``h3``). Returns (its line, failures)."""
    from hnsw_tpu_torch import DataMap, HnswIo
    from hnsw_tpu_torch.io.hnswio import file_dump

    failures = []
    t = [time.time()]
    dm = DataMap(tmp, base)
    view, ids = dm.strided_view(), dm.ids()
    n = h._nb_point
    row_of = np.empty(n, np.int64)
    row_of[h._origin[:n]] = np.arange(n)
    rows = h._data[row_of[ids]]
    datamap_equal = bool(len(ids) == n and view.tobytes() == np.ascontiguousarray(rows).tobytes()
                         and all(np.array_equal(dm.get_data(int(i)), h._data[row_of[i]])
                                 for i in ids[:: max(1, n // 64)]))
    t.append(time.time())
    light = file_dump(h, tmp, "smoke_light", mode="Light")
    t.append(time.time())
    hl = HnswIo(tmp, light).load_hnsw()
    t.append(time.time())
    diff = [f"layer {l} {f}" for l in sorted(h3._layers)
            for f in ("ids", "dists", "counts")
            if l not in hl._layers or not np.array_equal(
                getattr(h3._layers[l], f)[:n], getattr(hl._layers[l], f)[:n])]
    diff += [f"layer {l} only in the Light reload" for l in hl._layers if l not in h3._layers]
    if not datamap_equal:
        failures.append("persist_more: the DataMap's vectors differ from the index's rows")
    if diff:
        failures.append(f"persist_more: the Light reload differs from the Full one: {diff}")
    line = {"datamap_equal": datamap_equal, "datamap_records": len(ids),
            "datamap_s": t[1] - t[0], "light_dump_s": t[2] - t[1],
            "light_load_s": t[3] - t[2], "light_tables_equal_full": not diff,
            "light_device": str(hl.device)}
    return line, failures


PIVOT_N = 40_000             # above PIVOT_MIN_POINTS (32,768): the pivot entry


def phase_user_pivots(torch, X, Q, k=10, nq=1024):
    """The weighted-L2 ``UserMetric`` of path 3 at 40k x 16, above
    ``PIVOT_MIN_POINTS``: the snapshot must carry entry pivots, recall@10 at
    ef 64 against its fp64 oracle >= 0.95, the program's capture must have
    called the metric's ``matmul_scores`` (the pivot entry) and its replay
    must equal a direct call. Returns the failures."""
    from hnsw_tpu_torch import Hnsw, UserMetric

    failures = []
    user = UserMetric(_wl2_pair, name="WeightedL2", scores=_wl2_scores,
                      matmul_scores=_wl2_matmul)
    Xs, Qs = np.ascontiguousarray(X[:PIVOT_N, :16]), np.ascontiguousarray(Q[:nq, :16])
    torch.cuda.synchronize()
    t0 = time.time()
    h = Hnsw(max_nb_connection=16, max_elements=len(Xs), ef_construction=100, dist=user,
             device="cuda")
    h.parallel_insert(Xs, mode="device", batch_size=4096)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    g = h.device_graph()
    pivots = None if g.pivot_ids is None else int(g.pivot_ids.shape[0])
    oid, qps = stream_timed(torch, h, Qs, k, 64, batch=nq)
    recall = recall_oracle(user, Xs, Qs, exact_kth(torch, user, Xs, Qs, k), oid, k)
    h.drop_programs()
    calls = _WL2_MATMUL_CALLS[0]
    prog = h.device_program(nq, torch.float32, **search_static(h, 64, k))
    captured_calls = _WL2_MATMUL_CALLS[0] - calls
    q = torch.as_tensor(Qs, device="cuda")
    calls = _WL2_MATMUL_CALLS[0]
    equal = replay_equals_direct(torch, prog, q)
    if pivots is None:
        failures.append("user pivots: the snapshot of 40k rows has no entry pivots")
    if recall < RECALL_SMALL_EF64:
        failures.append(f"user pivots: recall@10 at ef 64 {recall:.4f} < {RECALL_SMALL_EF64}")
    if captured_calls < 1 or not equal:
        failures.append(f"user pivots: matmul_scores called {captured_calls} times while the "
                        f"program was built, replay equal to the direct call: {equal}")
    emit({"phase": "user_pivots", "n": len(Xs), "d": 16, "build_s": build_s,
          "pivots": pivots, "recall_at_10": recall, "qps": qps,
          "matmul_scores_calls_building_program": captured_calls,
          "matmul_scores_calls_replay_and_direct": _WL2_MATMUL_CALLS[0] - calls,
          "replay_equals_direct": equal, "failures": failures})
    return failures


RECALL_TOPK_GATHERED = 0.999


def phase_topk_gathered(torch, X, Q, k=10, n=20_000, nq=256):
    """``TopkProgram``'s gathered route: ``BruteForceIndex("Hellinger")`` (no
    ``matmul_scores``, so ``_bf_topk`` scores the broadcast corpus a chunk of
    queries at a time) on path 3's softmax rows; the replay must equal the
    direct call bit for bit and answer the fp64 oracle's top-10 (recall
    scored as path 3 scores it, >= 0.999). Returns the failures."""
    from hnsw_tpu_torch import BruteForceIndex, get_metric

    failures = []
    P, PQ = _softmax(X[:n, :64]), _softmax(Q[:nq, :64])
    m = get_metric("Hellinger")
    bf = BruteForceIndex(dist="Hellinger", device="cuda")
    bf.parallel_insert(P)
    t0 = time.time()
    ids, _ = bf.search_batch(PQ, k)
    first_s = time.time() - t0
    (prog,) = bf._programs._progs.values()
    equal, launches = call_replay_equals_direct(torch, prog, torch.as_tensor(PQ, device="cuda"))
    kth = np.array([np.sort(m.np_batch(PQ[b], P))[k - 1] for b in range(nq)])
    recall = recall_oracle(m, P, PQ, kth, ids, k)
    if not equal or launches or recall < RECALL_TOPK_GATHERED:
        failures.append(f"topk gathered: replay equal {equal}, launches {launches}, "
                        f"recall@10 {recall:.4f} (>= {RECALL_TOPK_GATHERED} wanted)")
    emit({"phase": "topk_gathered", "metric": "Hellinger", "n": n, "d": 64, "queries": nq,
          "program": type(prog).__name__, "replay_equals_direct": equal,
          "launches_per_replay": launches, "recall_at_10": recall, "first_call_s": first_s,
          "pool_bytes": prog.pool_bytes, "failures": failures})
    bf.drop_programs()
    return failures


BENCH_KNOB_N = 20_000
BENCH_KNOB_Q = 4096


def phase_bench_knobs(torch):
    """``hnsw_tpu_torch.bench.main`` at a cut size (20k x 128, 4096 queries; 2
    blocks of 0.2 s, S2 = 4), once with ``BENCH_BUILD=native`` (the C++ tier
    builds, the card serves) and once with ``BENCH_GT=host`` (the fp64 host
    oracle); each record must hold every key, the graph recall its floor and
    the exact recall RECALL_EXACT. The host oracle's k-th distances must
    equal the exact-scan pool's on the same queries within recall_fp64's
    relative margin (1e-6: the norm form against the direct form). Returns
    the failures."""
    from hnsw_tpu_torch import bench

    failures, runs = [], {}
    for knob, value in (("BENCH_BUILD", "native"), ("BENCH_GT", "host")):
        os.environ[knob] = value
        try:
            cfg = bench.Config(n=BENCH_KNOB_N, qbatch=BENCH_KNOB_Q, blocks=2,
                               min_block_s=0.2, kernel_s=4, device="cuda")
            t0 = time.time()
            rec = bench.main(cfg)
        finally:
            del os.environ[knob]
        # the repair keys come with a device build alone, as in bench.py's
        # record (a native build runs no repair)
        missing = [key for key in bench.KEYS if key not in rec and not (
            key.startswith("repair_") and rec.get("build_backend") != "device")]
        runs[f"{knob}={value}"] = {"seconds": time.time() - t0, "build": cfg.build,
                                   "gt": cfg.gt, "backend": rec.get("build_backend"),
                                   "hnsw_recall": rec["hnsw_recall"],
                                   "exact_recall": rec["exact_recall"],
                                   "hnsw_qps": rec["hnsw_qps"], "missing": missing}
        if missing:
            failures.append(f"bench {knob}={value}: keys missing: {missing}")
        if rec["hnsw_recall"] < cfg.recall or rec["exact_recall"] < RECALL_EXACT:
            failures.append(f"bench {knob}={value}: recall {rec['hnsw_recall']} (floor "
                            f"{cfg.recall}), exact {rec['exact_recall']} ({RECALL_EXACT})")
    X, Q = f32_dataset("gauss", np.random.default_rng(1234), BENCH_KNOB_N, BENCH_KNOB_Q,
                       128, 16)
    nq = min(len(Q), bench.NQ_GT_MAX)
    host = bench.host_kth(X, Q[:nq], 10)
    pool = bench.pool_kth(bench.scan_corpus(X, torch.device("cuda")), X, Q[:nq], 10, 64, 2048)
    rel = float(np.max(np.abs(host - pool) / pool))
    if rel > 1e-6:
        failures.append(f"bench: the host oracle's k-th distances differ from the pool's "
                        f"by {rel:.2e} relative (> 1e-6)")
    emit({"phase": "bench_knobs", "n": BENCH_KNOB_N, "queries": BENCH_KNOB_Q, "runs": runs,
          "host_vs_pool_kth_max_rel": rel, "failures": failures})
    return failures


# ------------------------------------------------------------- the high-d path ----

# AutoIndex sends every L2 corpus with d >= HIGH_D (512) to the exact scan:
# the repo's own high-d configuration, ann-mnist-784-euclidean (BASELINE.json
# configs[1]), and the corpus shape of ann-benchmarks' gist-960-euclidean,
# both made with bench.py's gauss generator (16 intrinsic dimensions) from
# the seed.
MNIST_SHAPE = (70_000, 784)
GIST_SHAPE = (1_000_000, 960)
HIGHD_Q = 16_384            # the 784 line's queries: search_batch and the graph's stream
GIST_Q = 4096
HIGHD_RUNS = 3              # timed exact searches: median QPS and spread
HIGHD_K100_Q = 4096         # l2_topk_stream at k=100, packed against unpacked
HIGHD_EFS = (32, 48, 64, 96, 128, 192, 256, 384)  # the graph's sweep, up to 0.999
RECALL_HIGHD_GRAPH = 0.98
PLAIN_SLICE = 256           # queries of the plain versions at 1M x 960 ([B, N] f32 each)
SCAN_EXPECTED = {"scan_topk": "wgmma", "scan_topk_unpacked": "wgmma",
                 "codec_scores_ids": "bulk", "codec_scores": "bulk"}
# the f32 lines (``SCAN_DTYPE = None``): every scan through the tf32x3 entry
SCAN_F32_EXPECTED = {"scan_topk": "tf32x3", "scan_topk_unpacked": "tf32x3"}
# the graph's codec carries id rows only where d % 128 == 0 (the JAX codec's
# layout): at d = 784 its scores are B3's (``codec_scores``), not B1's
HIGHD_GRAPH_CODEC = "codec_scores_ids" if MNIST_SHAPE[1] % 128 == 0 else "codec_scores"


def entry_faults_of(label, counts, expected=SCAN_EXPECTED):
    """Every launch of a kernel in ``counts`` (a line's launch counts from
    zero) through the entry the high-d shapes select (``expected``: the bf16
    lines', or ``SCAN_F32_EXPECTED`` for the f32 scan's lines)."""
    return [f"{label}: {counts[f'{c}.{e}']} of {counts[c]} {c} launches took {e}"
            for c, e in expected.items() if counts[f"{c}.{e}"] != counts[c]]


def timed_exact(torch, index, X, Q, kth, label, failures, t0, k=10):
    """An exact index's first answer on ``Q`` (which builds its scan program;
    seconds since ``t0``, its set-up's start), recall@10 against ``kth``, and
    QPS: median of ``HIGHD_RUNS`` searches, spread (max - min) / median."""
    ids, _ = index.search_batch(Q, k)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    recall = recall_fp64(X, Q, kth, ids, k)
    qps = []
    for _ in range(HIGHD_RUNS):
        t0 = time.time()
        index.search_batch(Q, k)
        qps.append(len(Q) / (time.time() - t0))
    med = float(np.median(qps))
    if recall < RECALL_EXACT:
        failures.append(f"{label}: exact recall@10 {recall:.5f} < {RECALL_EXACT}")
    return {"set_up_to_first_answer_s": first_s, "recall_at_10": recall,
            "queries": len(Q), "qps": med, "qps_runs": qps,
            "qps_spread": (max(qps) - min(qps)) / med}


def exact_auto(torch, X, Q, kth, label, failures, k=10):
    """``AutoIndex("L2")`` over ``X``: the engine it chooses (must be the
    scan), then ``timed_exact``."""
    from hnsw_tpu_torch import AutoIndex

    a = AutoIndex("L2", device="cuda")
    t0 = time.time()
    a.parallel_insert(zip(X, range(len(X))))
    engine = a.choose_engine()
    a.build()
    out = timed_exact(torch, a, X, Q, kth, label, failures, t0, k)
    if engine != "scan" or a.engine_name != "scan":
        failures.append(f"{label}: AutoIndex('L2') chose {engine!r}, not 'scan'")
    return a, {"engine": engine, **out}


def exact_f32(torch, X, Q, kth, label, failures, k=10):
    """``BruteForceIndex`` with ``SCAN_DTYPE = None`` over ``X``: the
    full-precision first stage, the f32 corpus scanned through the tf32x3
    entry; then ``timed_exact``."""
    from hnsw_tpu_torch import BruteForceIndex

    bf = BruteForceIndex("L2", device="cuda")
    bf.SCAN_DTYPE = None
    t0 = time.time()
    bf.parallel_insert(X)
    return bf, {"scan_dtype": "f32", **timed_exact(torch, bf, X, Q, kth, label, failures, t0, k)}


def k100_pair(torch, st, engine, X, Q, kth, label, failures):
    """``l2_topk_stream`` at k=100 over the exact engine's scan copy, unpacked
    (B5) and packed (B2), on ``HIGHD_K100_Q`` queries: the two id sets equal
    on >= ``B2_SET_EQUAL`` of the queries, the unpacked answer's recall@10
    (its first 10) against ``kth``, and each one's QPS (a second call, after
    the one that builds its program)."""
    Xd, xsq, Xscan, perm, acc, programs = engine._scan_device()
    nq = HIGHD_K100_Q
    out = {}
    for name, packed in (("unpacked", False), ("packed", True)):
        kw = dict(tn=st.SCAN_TN, group=st.SCAN_GROUP, acc=acc,
                  overfetch=engine.SCAN_OVERFETCH, packed=packed, Xscan=Xscan,
                  batch=EXACT_BATCH, programs=programs)
        _, idx = st.l2_topk_stream(Q[:nq], Xd, xsq, 100, **kw)
        torch.cuda.synchronize()
        t0 = time.time()
        st.l2_topk_stream(Q[:nq], Xd, xsq, 100, **kw)
        out[name] = (idx, nq / (time.time() - t0))
    same = float((np.sort(out["unpacked"][0], 1) == np.sort(out["packed"][0], 1))
                 .all(1).mean())
    if same < B2_SET_EQUAL:
        failures.append(f"{label}: k=100 unpacked and packed ids set-equal on {same:.4f}")
    rows = perm[np.clip(out["unpacked"][0][:, :10], 0, len(perm) - 1)]
    return {"queries": nq, "set_equal_frac": same,
            "unpacked_recall_at_10": recall_fp64(X, Q, kth[:nq], rows, 10),
            "unpacked_qps": out["unpacked"][1], "packed_qps": out["packed"][1]}


def highd_graph(torch, X, Q, kth, failures, k=10):
    """The 784 corpus through the graph at the reference's mnist settings (M=24,
    efC=400, level scale 0.5; bench.py's kept pruned links, batch 16384, cap
    96; the int8 codec, whose kernel, B1 with id rows or B3 without, must take
    "bulk"), then ``device_search_stream`` over ``HIGHD_EFS`` until recall@10
    reaches 0.999: recall and streamed QPS (the queries twice, after the call
    that builds each ef's program)."""
    from hnsw_tpu_torch.ops.beam_search import device_search_stream
    from hnsw_tpu_torch.ops.codec_scores import codec_entry

    h, build_s, mem = build_path1(torch, X)
    codec = h.device_codec()
    entry = None if codec is None else codec_entry(X.shape[1], codec.M0, codec.id_rows)
    if codec is None or entry != "bulk":
        failures.append(f"highd_graph: the int8 codec's scores must take 'bulk' at "
                        f"d={X.shape[1]}; entry {entry}")
    Qs = np.concatenate([Q, Q])
    sweep = {}
    for ef in HIGHD_EFS:
        ids, _ = device_search_stream(h, Q, k, ef, batch=16384, expand=4)
        oid = np.where(ids >= 0, h._origin[np.clip(ids, 0, h._nb_point - 1)], -1)
        r = recall_fp64(X, Q, kth, oid, k)
        torch.cuda.synchronize()
        t0 = time.time()
        device_search_stream(h, Qs, k, ef, batch=16384, expand=4)
        sweep[ef] = {"recall_at_10": r, "qps": len(Qs) / (time.time() - t0)}
        if r >= RECALL_EXACT:
            break
    at = {floor: next((ef for ef, v in sweep.items() if v["recall_at_10"] >= floor), None)
          for floor in (RECALL_HIGHD_GRAPH, RECALL_EXACT)}
    if at[RECALL_HIGHD_GRAPH] is None:
        failures.append(f"highd_graph: recall@10 below {RECALL_HIGHD_GRAPH} at every ef "
                        f"{list(sweep)}")
    h.drop_programs()
    return {"build_s": build_s, **mem, "codec_M0": None if codec is None else codec.M0,
            "codec_id_rows": None if codec is None else codec.id_rows,
            "codec_kernel": HIGHD_GRAPH_CODEC, "codec_entry": entry,
            "stream_queries": len(Qs), "sweep": sweep,
            "ef_at_0.98": at[RECALL_HIGHD_GRAPH], "ef_at_0.999": at[RECALL_EXACT]}


def scan_launcher(torch, st, kernel_lib, packed, entry, layout, qs, Xs, xsq, acc):
    """One launch of B2 (``packed``) or B5 through its library's launch
    function with the entry and layout named, not through the wrapper (not
    counted): the other entry's and layout's times on the same shape."""
    tn, grp = st.SCAN_TN, st.SCAN_GROUP
    B, d = qs.shape
    N = Xs.shape[0]
    G, _, acc, n_blocks, LB = st._geometry(N, tn, grp, acc)
    name = "scan_topk" if packed else "scan_topk_unpacked"
    lib = kernel_lib.load(name)
    stream = torch.cuda.current_stream().cuda_stream
    head = (qs.data_ptr(), Xs.data_ptr(), xsq.data_ptr(), B, N, d, tn, grp, acc)
    codes = (int(Xs.dtype == torch.bfloat16), kernel_lib.SCAN_ENTRIES.index(entry),
             st.SCAN_LAYOUTS.index(layout))
    out = torch.empty((n_blocks, B, 2 * G), dtype=torch.int32, device=Xs.device)
    if packed:
        fn, args = lib.scan_topk_launch, (*head, LB, *codes, out.data_ptr(), stream)
    else:
        outd = torch.empty((n_blocks, B, 2 * G), dtype=torch.float32, device=Xs.device)
        fn, args = (lib.scan_topk_unpacked_launch,
                    (*head, *codes, outd.data_ptr(), out.data_ptr(), stream))
    return lambda: kernel_lib.check(fn(*args), f"{name}.{entry} ({layout})")


def kernel_ptxas(kernel_lib, source, layout, f32=False):
    """ptxas's registers and spills of ``source``'s tensor-core kernel in
    ``layout``, over bf16 or (``f32``, the tf32x3 entry) f32 rows."""
    kernel = "scan_kloop_kernel" if layout == "kloop" else "scan_tile_kernel"
    return next(({k: e[k] for k in ("registers", "spill_stores", "spill_loads")}
                 for e in kernel_lib.ptxas_report((source,))[source]
                 if kernel in e["entry"] and ("bfloat16" in e["entry"]) != f32), None)


def scan_row(torch, st, kernel_lib, name, qs, Xs, xsq, acc, check, line, plain_q=None,
             failures=None):
    """A kernels-line row for B2 or B5 (``name`` "B2", "B5", or with " f32"
    for f32 inputs, the tf32x3 entry) at a shape of the path ``line`` runs (B =
    ``len(qs)`` queries): the wrapper's ms in turns with the library call (one
    matmul in the inputs' type, TF32 off for f32, + topk) and the f32-FMA
    entry ("was", where its shared memory fits), back-to-back ms, the plain
    version's ms (on ``plain_q``, a slice where [B, N] intermediates would not
    fit), the bound and the epilogue's, and ``check`` (``compare_scans``'
    result at this shape). The bound of an f32 row is its three tf32 products
    at the TF32 rate (or its bytes), with one pass of f32 FMAs beside it
    (``fma_floor_ms``); an f32 row slower than its library call or than the
    f32-FMA entry adds to ``failures``."""
    packed = name.startswith("B2")
    f32 = Xs.dtype == torch.float32
    tn, grp = st.SCAN_TN, st.SCAN_GROUP
    B, d = qs.shape
    Np = Xs.shape[0]
    n_blocks = st._geometry(Np, tn, grp, acc)[3]
    wrap = st.scan_packed if packed else st.scan_unpacked
    plain = st.scan_packed_plain if packed else st.scan_unpacked_plain
    plain_q = qs if plain_q is None else plain_q

    def library():
        gq = torch.matmul(qs, Xs.T)
        return torch.topk(xsq[None, :] - 2.0 * gq.float(), 18, dim=1, largest=False)

    fns = [lambda: wrap(qs, Xs, xsq, tn, grp, acc), library]
    simt_bytes = st.scan_smem("simt", d, packed)[0]
    if simt_bytes <= st.SMEM_LIMIT:
        fns.append(scan_launcher(torch, st, kernel_lib, packed, "simt", "resident", qs, Xs,
                                 xsq, acc))
    times = cuda_ms_turns(torch, fns, rounds=3)
    ms, lib_ms = times[:2]
    was_ms = times[2] if len(times) > 2 else None
    plain_ms = cuda_ms(torch, lambda: plain(plain_q, Xs, xsq, tn, grp, acc), warmup=1, iters=3)
    flops = 2 * B * Np * d
    esize = Xs.element_size()
    nbytes = (Np * d * esize + Np * 4 + B * d * esize
              + (1 if packed else 2) * n_blocks * B * 256 * 4)
    bms, by = bound_ms(nbytes, 3 * flops, TF32_FLOPS) if f32 else bound_ms(nbytes, flops,
                                                                            BF16_FLOPS)
    instr = B2_EPILOGUE_INSTR if packed else B5_EPILOGUE_INSTR
    entry = st.scan_entry(Xs.dtype, d, packed)
    layout = st.scan_layout(d, packed, Xs.dtype)
    source = "scan_topk" if packed else "scan_topk_unpacked"
    row = {"name": name, "route": "cuda",
           "source": f"hnsw_tpu_torch/csrc/{source}.cu",
           "replaces": "hnsw_tpu/ops/pallas_topk.py:106" if packed
           else "hnsw_tpu/ops/pallas_topk.py:38",
           "counter": source, "line": line,
           "shape": f"B={B} N={Np} d={d} {'f32' if f32 else 'bf16'} acc={acc}",
           "entry": entry, "layout": layout,
           "ptxas": kernel_ptxas(kernel_lib, source, layout, f32),
           "stages": st.scan_smem(entry, d, packed)[1],
           "max_abs_err": check["b2_max_abs_err" if packed else "b5_max_abs_err"],
           "ms": ms, "ms_back_to_back": cuda_ms_queued(
               torch, lambda: wrap(qs, Xs, xsq, tn, grp, acc), n=5),
           "plain_ms": plain_ms, "plain_queries": len(plain_q),
           "bound_ms": bms, "bound_by": by,
           "epilogue_bound_ms": B * Np * instr / CUDA_CORE_INSTR_PER_S * 1e3,
           "tflops": flops / ms / 1e9, "bound_share": bms / ms, "library_ms": lib_ms,
           "was_ms": was_ms, "was_entry": "simt", "simt_shared_bytes": simt_bytes,
           "shapes_checked": [check]}
    if f32:
        row["fma_floor_ms"] = flops / F32_FLOPS * 1e3
        row["library"] = "f32 torch.matmul (allow_tf32 False) + torch.topk"
        if ms > lib_ms:
            failures.append(f"{name} at {row['shape']}: {ms:.3f} ms is slower than its library "
                            f"call {lib_ms:.3f} ms")
        if was_ms is not None and ms > was_ms:
            failures.append(f"{name} at {row['shape']}: {ms:.3f} ms is slower than the simt "
                            f"entry's {was_ms:.3f} ms")
    if was_ms is None:
        row["was_note"] = (f"the simt entry asks for {simt_bytes} bytes of shared memory "
                           f"(the block's limit is {st.SMEM_LIMIT}): it never launched here")
    return row


def phase_highd(torch, seed, kernels, k=10):
    """The high-d path, five lines each with its launch counts from zero:
    ``highd_mnist`` (AutoIndex's scan at 70k x 784, ``l2_topk_stream`` at
    k=100 packed and unpacked), ``highd_graph`` (the same corpus through the
    graph), ``highd_mnist_f32`` (``BruteForceIndex`` with ``SCAN_DTYPE =
    None`` on the same corpus: the f32 scan, entry tf32x3, at k=10 and at
    k=100 packed and unpacked), ``highd_gist`` (AutoIndex's scan at 1M x 960)
    and ``highd_gist_f32`` (the f32 scan there); then, outside the counted
    windows, B2 and B5 against their plain versions at 784 and B2 at 960, in
    bf16 and in f32 (``kernels``). Returns (failures, kernel rows, {line:
    counts})."""
    from hnsw_tpu_torch.ops import kernel_lib
    from hnsw_tpu_torch.ops import scan_topk as st

    failures, rows, counts = [], [], {}
    # ---- 70k x 784: the exact engine AutoIndex chooses ----
    X, Q = f32_dataset("gauss", np.random.default_rng(seed), MNIST_SHAPE[0], HIGHD_Q,
                       MNIST_SHAPE[1], 16)
    t0 = time.time()
    kth = matmul_kth(torch, X, Q, k)
    truth_s = time.time() - t0
    kernel_lib.reset_launch_counts()
    a, exact = exact_auto(torch, X, Q, kth, "highd_mnist", failures, k)
    k100 = k100_pair(torch, st, a.engine, X, Q, kth, "highd_mnist", failures)
    Xd, xsq, Xscan, perm, acc, programs = a.engine._scan_device()
    counts["highd_mnist"] = dict(kernel_lib.LAUNCHES)
    failures += entry_faults_of("highd_mnist", counts["highd_mnist"])
    emit({"phase": "highd_mnist", "n": MNIST_SHAPE[0], "d": MNIST_SHAPE[1], "seed": seed,
          "truth_s": truth_s, **exact, "scan_layout": {
              p: st.scan_layout(MNIST_SHAPE[1], p) for p in (True, False)},
          "k100": k100, "launches": {c: v for c, v in counts["highd_mnist"].items() if v},
          "failures": failures})
    # ---- the same corpus through the graph ----
    kernel_lib.reset_launch_counts()
    graph = highd_graph(torch, X, Q, kth, failures, k)
    counts["highd_graph"] = dict(kernel_lib.LAUNCHES)
    failures += entry_faults_of("highd_graph", counts["highd_graph"])
    ef98 = graph["ef_at_0.98"]
    emit({"phase": "highd_graph", **graph, "exact_qps": exact["qps"],
          "graph_over_exact_qps_at_0.98": None if ef98 is None
          else graph["sweep"][ef98]["qps"] / exact["qps"],
          "launches": {c: v for c, v in counts["highd_graph"].items() if v}})
    if kernels:
        qs = st.scan_copy(torch.as_tensor(Q[:EXACT_BATCH], device="cuda"))
        label = f"highd B={EXACT_BATCH} N={Xd.shape[0]} d={MNIST_SHAPE[1]} bf16 acc={acc}"
        check = compare_scans(torch, st, kernel_lib, qs, Xscan, xsq, acc, label, "wgmma",
                              failures)
        rows += [scan_row(torch, st, kernel_lib, name, qs, Xscan, xsq, acc, check,
                          "highd_mnist") for name in ("B2", "B5")]
    a.engine.drop_programs()
    del a, Xd, xsq, Xscan, programs
    torch.cuda.empty_cache()
    # ---- the same corpus through the f32 scan (SCAN_DTYPE None) ----
    kernel_lib.reset_launch_counts()
    bf, exact32 = exact_f32(torch, X, Q, kth, "highd_mnist_f32", failures, k)
    k100 = k100_pair(torch, st, bf, X, Q, kth, "highd_mnist_f32", failures)
    counts["highd_mnist_f32"] = dict(kernel_lib.LAUNCHES)
    failures += entry_faults_of("highd_mnist_f32", counts["highd_mnist_f32"],
                                SCAN_F32_EXPECTED)
    emit({"phase": "highd_mnist_f32", "n": MNIST_SHAPE[0], "d": MNIST_SHAPE[1], **exact32,
          "bf16_recall_at_10": exact["recall_at_10"], "bf16_qps": exact["qps"],
          "k100": k100, "launches": {c: v for c, v in counts["highd_mnist_f32"].items() if v}})
    if kernels:
        Xd, xsq, _, _, acc, _ = bf._scan_device()
        qf = torch.as_tensor(Q[:EXACT_BATCH], device="cuda")
        label = f"highd B={EXACT_BATCH} N={Xd.shape[0]} d={MNIST_SHAPE[1]} f32 acc={acc}"
        check = compare_scans(torch, st, kernel_lib, qf, Xd, xsq, acc, label, "tf32x3",
                              failures)
        rows += [scan_row(torch, st, kernel_lib, name, qf, Xd, xsq, acc, check,
                          "highd_mnist_f32", failures=failures)
                 for name in ("B2 f32", "B5 f32")]
        del Xd, xsq, qf
    bf.drop_programs()
    del bf, X, Q
    torch.cuda.empty_cache()
    # ---- 1M x 960 ----
    X, Q = f32_dataset("gauss", np.random.default_rng(seed), GIST_SHAPE[0], GIST_Q,
                       GIST_SHAPE[1], 16)
    t0 = time.time()
    kth = matmul_kth(torch, X, Q, k)
    truth_s = time.time() - t0
    torch.cuda.empty_cache()
    kernel_lib.reset_launch_counts()
    a, exact = exact_auto(torch, X, Q, kth, "highd_gist", failures, k)
    counts["highd_gist"] = dict(kernel_lib.LAUNCHES)
    failures += entry_faults_of("highd_gist", counts["highd_gist"])
    emit({"phase": "highd_gist", "n": GIST_SHAPE[0], "d": GIST_SHAPE[1], "seed": seed,
          "truth_s": truth_s, **exact,
          "launches": {c: v for c, v in counts["highd_gist"].items() if v}})
    if kernels:
        Xd, xsq, Xscan, perm, acc, programs = a.engine._scan_device()
        a.engine.drop_programs()
        qs = st.scan_copy(torch.as_tensor(Q[:EXACT_BATCH], device="cuda"))
        label = f"highd B={PLAIN_SLICE} N={Xd.shape[0]} d={GIST_SHAPE[1]} bf16 acc={acc}"
        check = compare_scans(torch, st, kernel_lib, qs[:PLAIN_SLICE], Xscan, xsq, acc,
                              label, "wgmma", failures)
        rows.append(scan_row(torch, st, kernel_lib, "B2", qs, Xscan, xsq, acc, check,
                             "highd_gist", plain_q=qs[:PLAIN_SLICE]))
        del Xd, xsq, Xscan, programs, qs
    a.engine.drop_programs()
    del a
    torch.cuda.empty_cache()
    # ---- the f32 scan at 1M x 960 ----
    kernel_lib.reset_launch_counts()
    bf, exact32 = exact_f32(torch, X, Q, kth, "highd_gist_f32", failures, k)
    counts["highd_gist_f32"] = dict(kernel_lib.LAUNCHES)
    failures += entry_faults_of("highd_gist_f32", counts["highd_gist_f32"], SCAN_F32_EXPECTED)
    emit({"phase": "highd_gist_f32", "n": GIST_SHAPE[0], "d": GIST_SHAPE[1], **exact32,
          "bf16_recall_at_10": exact["recall_at_10"], "bf16_qps": exact["qps"],
          "launches": {c: v for c, v in counts["highd_gist_f32"].items() if v}})
    if kernels:
        Xd, xsq, _, _, acc, _ = bf._scan_device()
        bf.drop_programs()
        qf = torch.as_tensor(Q[:EXACT_BATCH], device="cuda")
        label = f"highd B={PLAIN_SLICE} N={Xd.shape[0]} d={GIST_SHAPE[1]} f32 acc={acc}"
        check = compare_scans(torch, st, kernel_lib, qf[:PLAIN_SLICE], Xd, xsq, acc, label,
                              "tf32x3", failures)
        rows.append(scan_row(torch, st, kernel_lib, "B2 f32", qf, Xd, xsq, acc, check,
                             "highd_gist_f32", plain_q=qf[:PLAIN_SLICE], failures=failures))
        del Xd, xsq, qf
    bf.drop_programs()
    del bf, X, Q
    torch.cuda.empty_cache()
    return failures, rows, counts


def profiled(torch, label, fn, top=12, warm=True):
    """Run ``fn`` under torch.profiler (after one untraced call with
    ``warm``, so a search program is built before its window); emit device
    busy time by kernel and the device's idle share of the window's wall
    time. Returns a failure when the kernels' summed time exceeds the wall
    time (a double count)."""
    if warm:
        fn()
    w = trace_window(torch, fn)
    emit({"phase": "profile", "window": label, **w, "top": w["top"][:top]})
    if w["device_busy_ms"] > w["wall_ms"]:
        return (f"profile {label}: device busy {w['device_busy_ms']:.1f} ms > wall "
                f"{w['wall_ms']:.1f} ms")
    return None


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="env,kernels,build,gt,exact_program,serve,program,bench,persist,"
                            "serve2,filters,native,metrics,ivf,sharded,highd,graft,"
                            "build_budget,user_pivots,topk_gathered,bench_knobs")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--cards-parts", default="equality,scale",
                    help="the cards phase's lines: equality (the four-card build and "
                         "answers bit for bit against cuda:0 x 4), scale (4 x 1M rows)")
    ap.add_argument("--profile", action="store_true",
                    help="after the phases, trace one served batch per operating "
                         "point and a second build with torch.profiler")
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if "cards" in phases and torch.cuda.device_count() < CARDS_MIN:
        print(f"chip_smoke: the cards phase spreads the shards over at least {CARDS_MIN} "
              f"cards; this machine shows {torch.cuda.device_count()}", file=sys.stderr)
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
    X, Q = f32_dataset("gauss", np.random.default_rng(args.seed), 200_000, nq, d, 16)
    rows = []
    if "kernels" in phases:
        rows, f = scan_rows(torch, X, Q)
        failures += f
    later = {}  # the lines after the paths and highd's, each with its counts from zero
    if "highd" in phases:
        # first, on an empty card: its 784-d graph build peaks at 31 GB
        f, r, lines = phase_highd(torch, args.seed, "kernels" in phases)
        failures += f
        rows += r
        later.update(lines)
    # ---- path 1: counts run from zero over build, gt and serve ----
    kernel_lib.reset_launch_counts()
    h = build_s = None
    if "build" in phases:
        # the widen pass's small builds first: they also take the process's
        # first use of the card off the timed builds
        failures += phase_build_extend(torch, X)
        h, build_s, f, tables = phase_build(torch, X)
        failures += f
        failures += phase_build_program(torch, X, tables, build_s)
        tables = None
    kth = bf = ids_bf = None
    replays = {}  # B2/B5 launches a replay of an exact program, by path
    if "gt" in phases:
        kth, exact, bf, ids_bf = phase_gt(torch, X, Q)
        if exact < RECALL_EXACT:
            failures.append(f"exact-scan recall@10 {exact:.4f} < {RECALL_EXACT}")
    if bf is not None and "exact_program" in phases:
        f, replays["path1 k=10 packed"] = phase_exact_program(torch, bf, X, Q)
        failures += f
    if h is not None and kth is not None and "serve" in phases:
        failures += phase_codec(torch, h)
        by_ef = phase_serve(torch, h, X, Q, kth)
        if by_ef[96]["recall_at_10"] < RECALL_EF96:
            failures.append(f"recall@10 at ef=96 {by_ef[96]['recall_at_10']:.4f} "
                            f"< {RECALL_EF96}")
    if h is not None and kth is not None and "program" in phases:
        failures += phase_program(torch, h, Q)
    if h is not None and kth is not None and "bench" in phases:
        failures += phase_bench(torch, h, build_s, bf, X, Q, kth)
    path1 = dict(kernel_lib.LAUNCHES)
    # ---- path 2: counts run from zero over persist and serve2 ----
    kernel_lib.reset_launch_counts()
    h2 = None
    if h is not None and "persist" in phases:
        native_ready()
        h2, _, f = phase_persist(torch, h)
        failures += f
    if h2 is not None and kth is not None and "serve2" in phases:
        out2, f = phase_serve2(torch, h, h2, bf, X, Q, kth)
        failures += f
        for name, r in out2["exact_k100"]["programs"].items():
            replays[f"path2 k=100 {name}"] = r["launches_per_replay"]
    path2 = dict(kernel_lib.LAUNCHES)
    # ---- the later lines, each with its counts from zero ----
    if h is not None and bf is not None and "filters" in phases:
        kernel_lib.reset_launch_counts()
        failures += phase_filters(torch, h, bf, X, Q)
        later["filters"] = dict(kernel_lib.LAUNCHES)
    if h is not None and kth is not None and "native" in phases:
        native_ready()
        failures += phase_native(torch, h, X, Q, kth)
    if "kernels" in phases:
        # after the paths, on the codec the serve phases read (B3 on path
        # 5's codec when path 5 runs)
        codec = h.device_codec() if h is not None else None
        r, f = codec_rows(torch, Q, args.seed, codec,
                          h._nb_point if h is not None else None,
                          names=("B1",) if "sharded" in phases else ("B1", "B3"))
        rows = r + rows
        failures += f
        if codec is not None:
            r, f = gathered_rows(torch, Q, args.seed, codec, h._nb_point)
            rows += r
            failures += f
        if h is not None:
            r, f = id_scores_rows(torch, h, X, Q)
            rows += r
            failures += f
            r, f = beam_step_rows(torch, X, Q)
            rows += r
            failures += f
    # the search programs paths 1-2 captured, and the bytes their pools hold,
    # released before the other paths
    emit({"phase": "programs", "held": {
        name: {"programs": len(x._programs), "pool_bytes": x._programs.pool_bytes()}
        for name, x in (("path1", h), ("path2", h2), ("exact", bf))
        if x is not None and x._programs is not None}})
    for x in (h, h2, bf):
        if x is not None:
            x.drop_programs()
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
        f, ivf, scan4, replays["path4 AutoIndex scan"] = phase_ivf(torch, args.seed)
        failures += f
    path4 = dict(kernel_lib.LAUNCHES)
    if scan4 is not None:
        check, f = scan_on_clustered(torch, *scan4)
        failures += f
        for r in rows:
            if r["name"] == "B2" and "line" not in r:  # the d = 128 row
                r["shapes_checked"].append(check)
    scan4 = None
    torch.cuda.empty_cache()
    # ---- path 5: the sharded tier on one card, counts from zero ----
    kernel_lib.reset_launch_counts()
    sh = None
    if kth is not None and "sharded" in phases:
        native_ready()
        f, sh, per_shard = phase_sharded(torch, X, Q, kth, ids_bf)
        failures += f
        for s, launches in enumerate(per_shard):
            replays[f"path5 shard {s}"] = launches
    path5 = dict(kernel_lib.LAUNCHES)
    if sh is not None and "kernels" in phases:
        blocks, _, scale, _, _ = sh.device_codec_arrays()
        r, f = codec_rows(torch, Q, args.seed, names=("B3",),
                          b3=(blocks[0], scale[0], sh.shards[0]._nb_point))
        rows = rows[:1] + r + rows[1:]
        failures += f
    for name, run in (("graft", lambda: phase_graft(torch)),
                      ("build_budget", lambda: phase_build_budget(torch, X)),
                      ("user_pivots", lambda: phase_user_pivots(torch, X, Q)),
                      ("topk_gathered", lambda: phase_topk_gathered(torch, X, Q)),
                      ("bench_knobs", lambda: phase_bench_knobs(torch)),
                      ("cards", lambda: phase_cards(torch, X, Q, kth, args.seed,
                                                    args.cards_parts.split(",")))):
        if name in phases:
            if name == "bench_knobs":
                native_ready()
            kernel_lib.reset_launch_counts()
            failures += run()
            later[name] = dict(kernel_lib.LAUNCHES)
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
            Xd, xsq, Xscan, _, acc, programs = bf._scan_device()
            windows.append(("exact k=10 packed, one 2048-query batch",
                            lambda: bf.search_batch(Q[:2048], 10)))
            windows.append(("exact k=100 unpacked, one 2048-query batch",
                            lambda: l2_topk_stream(
                                Q[:2048], Xd, xsq, 100, tn=SCAN_TN, group=SCAN_GROUP,
                                Xscan=Xscan, acc=acc, overfetch=bf.SCAN_OVERFETCH,
                                batch=2048, packed=False, programs=programs)))
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
        if sh is not None:
            windows.append(("sharded search_stream ef=96, 4 shards, one 16384-query batch",
                            lambda: sh.search_stream(Q, 10, 96, batch=16384)))
        windows.append(("build (a second, traced build of the same index)",
                        lambda: build_path1(torch, X)))
        for label, fn in windows:
            f = profiled(torch, label, fn, warm=not label.startswith("build"))
            if f:
                failures.append(f)
    # a kernel's launches are read on the path that drives it: B1 and B2 on
    # path 1 (and again on path 2), B4 and B5 on path 2, B2 on path 4 (the
    # AutoIndex scan and BruteForceIndex's answers), B3 and B2 on path 5;
    # path 3 on none
    ran1 = all(p in phases for p in ("build", "gt", "serve"))
    ran2 = ran1 and all(p in phases for p in ("persist", "serve2"))
    ran4 = "ivf" in phases
    ran5 = sh is not None
    paths = {"path1": path1, "path2": path2, "path3": path3, "path4": path4,
             "path5": path5, **later}
    # (ran, counts, must launch there)
    # every graph search and build runs beam_step's two entries
    needed = {"B1": [(ran1, path1, True), (ran2, path2, False)],
              "B2": [(ran1, path1, True), (ran4, path4, True), (ran5, path5, True)],
              "B3": [(ran5, path5, True)],
              "B4": [(ran2, path2, True)], "B5": [(ran2, path2, True)],
              **{f"beam_step {e}": [(ran1, path1, True), (ran2, path2, True),
                                    (ran5, path5, True)] for e in ("fused", "merge")}}
    if ran5:
        other = {c: path5[c] for c in ("codec_scores_ids", "codec_scores_gathered",
                                       "scan_topk_unpacked") if path5[c]}
        if other:
            failures.append(f"path 5 launched kernels other than B3 and B2: {other}")
    for label, launches in replays.items():
        scans = launches.get("scan_topk", 0) + launches.get("scan_topk_unpacked", 0)
        if scans != 1:
            failures.append(f"{label}: a replay of its exact program launched {scans} "
                            "scans, not one")
    for r in rows:
        c = r.pop("counter")
        if "line" in r:  # a high-d or f32 row: its launches are its own line's
            if r["line"] not in paths:  # (the d = 128 f32 rows without highd)
                r["launches"] = None
                continue
            cnt = paths[r["line"]]
            r["launches"] = cnt.get(c, 0)
            r["launches_by_entry"] = {k.split(".")[1]: v for k, v in cnt.items()
                                      if k.startswith(c + ".")}
            if r["launches"] == 0:
                failures.append(f"kernel {r['name']} never launched on {r['line']}")
            continue
        if r["name"] in ("B2", "B5"):
            r["launches_per_replay"] = {w: l.get(c, 0) for w, l in replays.items()
                                        if l.get(c, 0) or r["name"] == "B2"}
        r["launches_by_path"] = {p: cnt[c] for p, cnt in paths.items()}
        r["launches"] = path1[c] or path2[c] or path4[c] or path5[c]
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
            elif c == "beam_step":  # two entries, each launched every iteration
                if counts[e] == 0:
                    failures.append(f"kernel {r['name']} never launched on its path")
            elif counts[e] != counts[c]:
                failures.append(f"kernel {r['name']} did not run its path through the "
                                f"{r['entry']} entry ({counts[e]} of {counts[c]} launches)")
    if ran2 and (path2["codec_scores_ids"] == 0 or path2["scan_topk"] == 0):
        failures.append("path 2 did not run B1 and B2")
    # the later lines' kernels: filters B1 and B2 (the codec search, the
    # exact truth), graft B3 and B2 (the i8 codec of the reference's d = 32
    # index, which carries no id rows, and the sharded "pallas" scan),
    # bench_knobs B2 (20k rows: below the codec's 32,768, no B1);
    # build_budget, user_pivots and topk_gathered none of the five
    for name, counters in (("highd_mnist", ("scan_topk", "scan_topk_unpacked")),
                           ("highd_graph", (HIGHD_GRAPH_CODEC,)),
                           ("highd_mnist_f32", ("scan_topk", "scan_topk_unpacked")),
                           ("highd_gist", ("scan_topk",)),
                           ("highd_gist_f32", ("scan_topk",)),
                           ("filters", ("codec_scores_ids", "scan_topk")),
                           ("graft", ("codec_scores", "scan_topk")),
                           ("cards", ("codec_scores", "scan_topk")),
                           ("bench_knobs", ("scan_topk",)),
                           ("build_budget", ()), ("user_pivots", ()),
                           ("topk_gathered", ())):
        if name not in later:
            continue
        counts = later[name]
        missing = [c for c in counters if counts[c] == 0]
        extra = {c: counts[c] for c in ("codec_scores_ids", "codec_scores",
                                        "codec_scores_gathered", "scan_topk",
                                        "scan_topk_unpacked")
                 if c not in counters and counts[c]}
        if missing or extra:
            failures.append(f"{name}: kernels {missing} never launched, others launched: "
                            f"{extra}")
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
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # the interpreter's own teardown of the card's state (the indexes'
    # captured programs) took 11 s after the last line; nothing is left to run
    os._exit(rc)
