#!/usr/bin/env python3
"""How far the exact scan's values lie from an fp64 evaluation of the same inputs.

    python3 tools/scan_accuracy.py   # needs one NVIDIA card and nvcc

For bench.py's gauss rows (16 intrinsic dimensions, seed 1234) at d = 128, 784
and 960 and for iid gaussian rows at d = 784, 256 queries in bf16: B5's values
v = |x|^2 - 2 q.x (``scan_unpacked``, the kernel) and two plain forms of the
same cells (``scan_unpacked_plain``, whose q.x sums each 64-column box; and one
f32 sum over all d columns, as a single matmul gives it) against v
evaluated in fp64 from the same bf16 values and f32 |x|^2, each over the terms
|x|^2 + 2 |q.x| of its cell's pick: the largest such error of each form and of
the kernel against the plain version. Prints the card's name and power limit,
then one JSON line per shape.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

SHAPES = (("gauss", 200_000, 128), ("gauss", 70_000, 784), ("iid", 70_000, 784),
          ("gauss", 300_000, 960))


def main():
    import torch
    from hnsw_tpu_torch.bench import f32_dataset
    from hnsw_tpu_torch.ops import scan_topk as st

    if not torch.cuda.is_available():
        print("scan_accuracy: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    tn, grp = st.SCAN_TN, st.SCAN_GROUP
    for kind, n, d in SHAPES:
        rng = np.random.default_rng(1234)
        if kind == "gauss":
            X, Q = f32_dataset("gauss", rng, n, 256, d, 16)
        else:
            X = rng.standard_normal((n, d)).astype(np.float32)
            Q = rng.standard_normal((256, d)).astype(np.float32)
        Xp, xsq, _ = st.pad_corpus(X)
        Xs = st.scan_copy(torch.from_numpy(Xp).to(dev))
        xd = torch.from_numpy(xsq).to(dev)
        acc = st.scan_acc(Xp.shape[0])
        qs = st.scan_copy(torch.from_numpy(Q).to(dev))
        x64, q64, xsq64 = Xs.double(), qs.double(), xd.double()

        def err(vals, ids):
            """max |vals - v64| / terms over the cells, v64 of each cell's row"""
            worst = 0.0
            for b in range(ids.shape[0]):
                r = ids[b].long()
                v64 = xsq64[r] - 2.0 * (x64[r] * q64[:, None, :]).sum(-1)
                terms = xsq64[r] + (xsq64[r] - v64).abs()
                worst = max(worst, float(((vals[b].double() - v64).abs() / terms).max()))
            return worst

        uk, jk = st.scan_unpacked(qs, Xs, xd, tn, grp, acc)
        up, jp = st.scan_unpacked_plain(qs, Xs, xd, tn, grp, acc)
        # one f32 sum over all d columns, at the plain version's picks
        r = jp.long()
        chain = torch.empty_like(up)
        for b in range(r.shape[0]):
            g = (qs.float() @ Xs.float().T).gather(1, r[b])
            chain[b] = xd[r[b]] - 2.0 * g
        pick = xd[jp.long()]
        print(json.dumps({
            "data": kind, "n": Xp.shape[0], "d": d, "queries": len(Q),
            "layout": st.scan_layout(d, False),
            "kernel_err_over_terms": err(uk, jk),
            "plain_box_sums_err_over_terms": err(up, jp),
            "plain_one_sum_err_over_terms": err(chain, jp),
            "kernel_vs_plain_over_terms": float(((uk - up).abs()
                                                 / (pick + (pick - up).abs())).max())}),
              flush=True)
        del Xs, xd, x64, uk, jk, up, jp, chain
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
