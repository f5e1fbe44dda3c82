"""Recall and speed of the graph search over an (ef, expand, max_iters,
seeds, qbatch) grid on a reloaded snapshot: the counterpart of the root
``tools/exp_search.py`` (the JAX package's).

    python -m hnsw_tpu_torch.tools.exp_search [--device cpu]

Reloads a ``save_native`` snapshot (``BENCH_SAVE`` of the port's bench) with
``load_native``, recreates the corpus it was built from with
``hnsw_tpu_torch.bench``'s ``make_dataset`` (rounded to float32, the rows the
index holds) and the same seeds, and its ground truth as the bench makes it
(the exact scan's top-64 pool re-scored in fp64). Per grid point, on one
JSON line on stdout (with the device: the card's name and power limit):
recall@10 of ``device_search_stream`` over the first 4096 queries scored in
fp64 (``recall_fp64``, f16 ingest), its streamed QPS (median over
``EXP_BLOCKS`` blocks of about 2 s, and their spread) and the
device-resident QPS of the captured ``SearchProgram`` (queries on the card,
four replays, one synchronize).

Env knobs, as the reference's: EXP_SNAP (the snapshot, default
``build/runs/1m.npz``), EXP_N, EXP_D, EXP_DATASET, EXP_INTRINSIC, EXP_GRID
(semicolon-separated ``ef,expand,max_iters,seeds,qbatch[,pool[,width[,rerank]]]``;
0 = the default), EXP_BLOCKS (5). Left out, as TPU-only: the jax compilation
cache.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..bench import device_info, f32_dataset, log, pool_kth, recall_fp64, scan_corpus, sync
from ..io.hnswio import load_native
from ..ops.beam_search import device_search_stream, serve_static
from ..utils.device import resolve_device

DEFAULT_GRID = ("80,4,0,4,16384;80,4,18,4,16384;80,4,14,4,16384;64,4,0,4,16384;"
                "64,4,0,8,16384;96,4,16,4,16384")
NQ = 16384
NQ_GT = 4096
BLOCK_S = 2.0
GT_POOL = 64
K = 10


def parse_spec(spec: str) -> dict:
    """``ef,expand,max_iters,seeds,qbatch[,pool[,width[,rerank]]]``, 0 = None."""
    parts = [int(x) for x in spec.split(",")]
    ef, expand, mi, seeds, qb = parts[:5]
    opt = [(parts[i] if len(parts) > i and parts[i] > 0 else None) for i in (5, 6, 7)]
    return dict(ef=ef, expand=expand, max_iters=mi if mi > 0 else None, seeds=seeds,
                qbatch=qb, pool=opt[0], width=opt[1], rerank=opt[2])


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    env = os.environ.get
    N, d = int(env("EXP_N", 1_000_000)), int(env("EXP_D", 128))
    snap = env("EXP_SNAP", "build/runs/1m.npz")
    blocks = int(env("EXP_BLOCKS", 5))
    X, Q = f32_dataset(env("EXP_DATASET", "gauss"), np.random.default_rng(1234), N, NQ, d,
                       int(env("EXP_INTRINSIC", 16)))
    log(f"[exp] loading snapshot {snap}")
    h = load_native(snap, device=device)
    assert h.get_nb_point() == N, (h.get_nb_point(), N)
    nq_gt = min(NQ_GT, NQ)
    log("[exp] ground truth pool ...")
    scan = scan_corpus(X, device)
    kth = pool_kth(scan, X, Q[:nq_gt], K, GT_POOL, 2048)
    del scan
    info = device_info(device)
    results = []
    for spec in env("EXP_GRID", DEFAULT_GRID).split(";"):
        p = parse_spec(spec)
        ef, expand, mi, seeds, qb = (p[k] for k in ("ef", "expand", "max_iters", "seeds",
                                                     "qbatch"))
        if getattr(h, "_codec_width", None) != p["width"]:
            h.set_traversal_codec(getattr(h, "_codec_kind", "auto"), p["width"])
        kw = dict(expand=expand, max_iters=mi, seeds=seeds, query_dtype="f16",
                  pool=p["pool"], rerank=p["rerank"])
        ids, _ = device_search_stream(h, Q[:nq_gt], K, ef, batch=min(qb, nq_gt), **kw)
        oid = np.where(ids >= 0, h._origin[np.clip(ids, 0, h._nb_point - 1)], -1)
        rec = recall_fp64(X, Q, kth, oid, K)

        Qs = np.tile(Q, (max(1, (2 * qb) // len(Q)) * 2, 1))

        def once():
            device_search_stream(h, Qs, K, ef, batch=qb, **kw)

        t0 = time.time()
        once()
        per = max(time.time() - t0, 1e-3)
        reps = max(1, int(np.ceil(BLOCK_S / per)))
        samples = []
        for _ in range(blocks):
            t0 = time.time()
            for _ in range(reps):
                once()
            samples.append(reps * len(Qs) / (time.time() - t0))
        qps = float(np.median(samples))
        spread = float((max(samples) - min(samples)) / qps)

        # device-resident: the captured program the stream replays, queries on
        # the card, one synchronize after four replays
        static = serve_static(h.device_codec(), ef=ef, knbn=K, expand=expand,
                              max_iters=mi, rerank=p["rerank"], pool=p["pool"],
                              seeds=seeds)
        qd = torch.as_tensor(np.resize(Q, (qb, d)).astype(np.float16), device=device)
        prog = h.device_program(qb, qd.dtype, **static)
        prog.run(qd)
        sync(device)
        t0 = time.time()
        for _ in range(4):
            out = prog.run(qd)
        out[0].cpu()
        kqps = 4 * qb / (time.time() - t0)
        row = dict(ef=ef, expand=expand, max_iters=static["max_iters"], seeds=seeds,
                   qb=qb, pool=p["pool"], width=p["width"], rerank=p["rerank"],
                   recall=rec, qps=qps, spread=spread, kernel_qps=kqps)
        results.append(row)
        log(f"[exp] {json.dumps(row)}")
    print(json.dumps({"tool": "exp_search", "snapshot": snap, "n": N, "d": d,
                      "queries_scored": nq_gt, "grid": results, "device": info}), flush=True)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
