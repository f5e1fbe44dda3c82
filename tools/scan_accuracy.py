#!/usr/bin/env python3
"""How far the exact scan's values lie from an fp64 evaluation of the same inputs.

    python3 tools/scan_accuracy.py [--dtype bf16 f32]   # needs one NVIDIA card and nvcc

For bench.py's gauss rows (16 intrinsic dimensions, seed 1234) at d = 128, 784
and 960 and for iid gaussian rows at d = 784, 256 queries, in bf16 (the
``wgmma`` entry) and in f32 (the ``tf32x3`` entry, the full-precision scan):
B5's values v = |x|^2 - 2 q.x (``scan_unpacked``, the kernel) and other forms
of the same cells against v evaluated in fp64 from the same inputs (the bf16
values, or the f32 rows) and f32 |x|^2, each over the terms |x|^2 + 2 |q.x|
of its cell's pick: the plain version (``scan_unpacked_plain``, whose q.x sums
each 64-column box), one f32 sum over all d columns (as a single matmul gives
it); in f32 also the f32-FMA entry ("simt", where its shared memory fits:
d <= 715 unpacked) and the CPU model of the tf32x3 sum (``tf32x3_dots``).
Prints the largest such error of each form and of the kernel against the
plain version (f32 matmuls with TF32 off). In f32 also B2's decoded distances
d2 = |q|^2 + |x|^2 - 2 q.x against fp64 over |q|^2 + |x|^2 + 2 |q.x|
(``packed_err_over_terms``: the kernel, "simt" where its shared memory fits,
d <= 842 packed, and the plain version), at tn = 128 and acc = 1, where each
cell holds one row and the packing clears one mantissa bit: every row's
distance is compared. Prints the card's name and power limit, then one JSON
line per shape and dtype.
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


def simt_unpacked(torch, kernel_lib, st, qs, Xs, xd, acc):
    """B5's values and ids through the f32-FMA entry ("simt"), which no
    wrapper names: its launch function called directly (not counted)."""
    tn, grp = st.SCAN_TN, st.SCAN_GROUP
    B, d = qs.shape
    G, _, acc, n_blocks, _ = st._geometry(Xs.shape[0], tn, grp, acc)
    outd = torch.empty((n_blocks, B, 2 * G), dtype=torch.float32, device=Xs.device)
    outi = torch.empty((n_blocks, B, 2 * G), dtype=torch.int32, device=Xs.device)
    lib = kernel_lib.load("scan_topk_unpacked")
    kernel_lib.check(lib.scan_topk_unpacked_launch(
        qs.data_ptr(), Xs.data_ptr(), xd.data_ptr(), B, Xs.shape[0], d, tn, grp, acc,
        int(Xs.dtype == torch.bfloat16), kernel_lib.SCAN_ENTRIES.index("simt"), 0,
        outd.data_ptr(), outi.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "scan_topk_unpacked.simt")
    return outd, outi


def packed_errs(torch, kernel_lib, st, qs, Xs, xsq):
    """B2's decoded distances against fp64 over their terms, by form (the
    kernel through its wrapper, "simt" launched directly where its shared
    memory fits, the plain version), at tn = 128, group 1, acc 1: each cell
    holds one row (lane c of block b is row 128 b + c), LB = 1."""
    tn, grp, acc = 128, 1, 1
    B, d = qs.shape
    N = Xs.shape[0]
    q64, x64 = qs.double(), Xs.double()
    g64 = q64 @ x64.T
    q2 = (q64 * q64).sum(1, keepdim=True)
    x2 = xsq.double()[None, :]
    d64, terms = q2 + x2 - 2.0 * g64, q2 + x2 + 2.0 * g64.abs()
    forms = {"kernel": lambda: st.scan_packed(qs, Xs, xsq, tn, grp, acc),
             "plain": lambda: st.scan_packed_plain(qs, Xs, xsq, tn, grp, acc)}
    if st.scan_smem("simt", d, True)[0] <= st.SMEM_LIMIT:
        def simt():
            G, _, _, n_blocks, LB = st._geometry(N, tn, grp, acc)
            out = torch.empty((n_blocks, B, 2 * G), dtype=torch.int32, device=Xs.device)
            lib = kernel_lib.load("scan_topk")
            kernel_lib.check(lib.scan_topk_launch(
                qs.data_ptr(), Xs.data_ptr(), xsq.data_ptr(), B, N, d, tn, grp, acc, LB, 0,
                kernel_lib.SCAN_ENTRIES.index("simt"), 0, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream), "scan_topk.simt")
            return out
        forms["simt"] = simt
    out = {}
    for name, fn in forms.items():
        first = fn()[:, :, :128]  # [N / 128, B, 128]: m1 of each one-row cell
        vals = (first & ~1).view(torch.float32).permute(1, 0, 2).reshape(B, N).double()
        out[name] = float(((vals - d64).abs() / terms).max())
    out.setdefault("simt", None)
    return out


def main():
    import argparse

    import torch
    from hnsw_tpu_torch.bench import f32_dataset
    from hnsw_tpu_torch.ops import kernel_lib
    from hnsw_tpu_torch.ops import scan_topk as st

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", nargs="*", choices=("bf16", "f32"), default=["bf16", "f32"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_accuracy: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    tn, grp = st.SCAN_TN, st.SCAN_GROUP
    for (kind, n, d), dt in ((shape, dt) for shape in SHAPES for dt in args.dtype):
        rng = np.random.default_rng(1234)
        if kind == "gauss":
            X, Q = f32_dataset("gauss", rng, n, 256, d, 16)
        else:
            X = rng.standard_normal((n, d)).astype(np.float32)
            Q = rng.standard_normal((256, d)).astype(np.float32)
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        Xp, xsq, _ = st.pad_corpus(X)
        Xs = st.scan_copy(torch.from_numpy(Xp).to(dev), dtype)
        xd = torch.from_numpy(xsq).to(dev)
        acc = st.scan_acc(Xp.shape[0])
        qs = st.scan_copy(torch.from_numpy(Q).to(dev), dtype)
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

        def at_picks(dots, r):
            """|x|^2 - 2 q.x of the rows ``r`` [blocks, B, 2G] from a [B, N] q.x"""
            out = torch.empty(r.shape, dtype=torch.float32, device=dev)
            for b in range(r.shape[0]):
                out[b] = xd[r[b]] - 2.0 * dots.gather(1, r[b])
            return out

        uk, jk = st.scan_unpacked(qs, Xs, xd, tn, grp, acc)
        up, jp = st.scan_unpacked_plain(qs, Xs, xd, tn, grp, acc)
        r = jp.long()
        # one f32 sum over all d columns, at the plain version's picks
        chain = at_picks(qs.float() @ Xs.float().T, r)
        pick = xd[r]
        line = {"data": kind, "n": Xp.shape[0], "d": d, "queries": len(Q), "dtype": dt,
                "entry": st.scan_entry(dtype, d, False),
                "layout": st.scan_layout(d, False, dtype),
                "kernel_err_over_terms": err(uk, jk),
                "plain_box_sums_err_over_terms": err(up, jp),
                "plain_one_sum_err_over_terms": err(chain, jp),
                "kernel_vs_plain_over_terms": float(((uk - up).abs()
                                                     / (pick + (pick - up).abs())).max())}
        if dtype == torch.float32:
            line["tf32x3_model_err_over_terms"] = err(at_picks(st.tf32x3_dots(qs, Xs), r), jp)
            if st.scan_smem("simt", d, False)[0] <= st.SMEM_LIMIT:
                line["simt_err_over_terms"] = err(*simt_unpacked(torch, kernel_lib, st, qs, Xs,
                                                                 xd, acc))
            else:
                line["simt_err_over_terms"] = None  # its shared memory does not fit
            line["packed_err_over_terms"] = packed_errs(torch, kernel_lib, st, qs, Xs, xd)
        print(json.dumps(line), flush=True)
        del Xs, xd, x64, uk, jk, up, jp, chain
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
