#!/usr/bin/env python3
"""Where the tensor-core exact scan (kernels B2 and B5) spends its time.

    python3 tools/scan_variants.py [--acc 7 3] [--d 784 --n 70000]
        [--layouts resident kloop] [--extra SCAN_KLOOP_MAX_STAGES=3 ...]
    # needs one NVIDIA card and nvcc

Builds ``hnsw_tpu_torch/csrc/scan_topk.cu`` and ``scan_topk_unpacked.cu`` with
the measurement hooks of ``csrc/scan_tile.cuh`` and times each build's
tensor-core entry (B=2048 queries against ``--n`` gauss rows of ``--d``
columns in bf16; default the main path's 200704 x 128, spans of 7 tiles), 20
launches back to back between two CUDA events, in each layout of
``--layouts`` (default: the one ``scan_layout`` picks for the depth):

  whole        the kernel as the package builds it
  no-epilogue  the tile product and the copy ring only (results are wrong)
  no-product   the keep-2 epilogue only (results are wrong)
  timing       (resident layout only) the whole kernel with cycle counters
               around each phase of the main loop; prints, for one thread of
               each warpgroup of block (0, 0), the cycles spent starting the
               product and the copies (start), waiting for a stage (full), for
               its turn (turn), for the product (product), in the epilogue,
               and in the whole loop
  -DNAME=VAL   one more whole build per ``--extra`` define (the K-looped
               ring's ``SCAN_KLOOP_MAX_STAGES``)

``--acc`` times every variant once per span length (tiles per span; default:
the package's ``scan_acc``, 7 tiles = 14 spans = 224 blocks at 200k rows; 3
gives 33 spans = 528 blocks, four whole waves on 132 SMs, at 2.4x the
candidate buffer).

Prints the card's name and power limit, then one JSON line per measurement
(with the achieved TFLOP/s of the product, 2 B N d flops).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

VARIANTS = (("whole", ()), ("no-epilogue", ("-DSCAN_TILE_NO_EPILOGUE",)),
            ("no-product", ("-DSCAN_TILE_NO_PRODUCT",)), ("timing", ("-DSCAN_TILE_TIMING",)))
SOURCES = ("scan_topk", "scan_topk_unpacked")


def main():
    import torch
    from hnsw_tpu_torch.ops import kernel_lib, scan_topk as st

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--acc", type=int, nargs="*", default=None,
                    help="tiles per span to time (default: the package's choice)")
    ap.add_argument("--d", type=int, default=128, help="depth (a multiple of 16)")
    ap.add_argument("--n", type=int, default=200_000, help="corpus rows")
    ap.add_argument("--layouts", nargs="*", default=None, choices=st.SCAN_LAYOUTS,
                    help="tensor-core layouts to time (default: scan_layout's)")
    ap.add_argument("--extra", nargs="*", default=[],
                    help="NAME=VAL defines, one more whole build each")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_variants: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    B, d = 2048, args.d
    Xp, xsq, _ = st.pad_corpus(rng.standard_normal((args.n, d)).astype(np.float32))
    Np = Xp.shape[0]
    Xs = torch.from_numpy(Xp).to(dev).to(torch.bfloat16)
    xd = torch.from_numpy(xsq).to(dev)
    qs = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).to(dev).to(torch.bfloat16)
    tn, grp = st.SCAN_TN, st.SCAN_GROUP
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory(prefix="scan_variants_") as tmp:
        procs = []
        variants = VARIANTS + tuple((f"-D{x}", (f"-D{x}",)) for x in args.extra)
        for label, flags in variants:  # all nvcc processes together
            for name in SOURCES:
                lib = os.path.join(tmp, f"{name}-{label}.so")
                cmd = [kernel_lib._nvcc(), *kernel_lib.NVCC_FLAGS, *flags, "-o", lib,
                       str(kernel_lib.CSRC / f"{name}.cu")]
                procs.append((label, name, lib, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        libs = []
        for label, name, lib, p in procs:
            log, _ = p.communicate()
            if p.returncode:
                print(log, file=sys.stderr)
                return 1
            handle = ctypes.CDLL(lib)
            kernel_lib._bind(name, handle)
            libs.append((label, name, handle))
        layouts = args.layouts or [None]
        cases = [(a, lay, *t) for a in (args.acc or [st.scan_acc(Np)]) for lay in layouts
                 for t in libs]
        for want_acc, lay, label, name, handle in cases:
            packed = name == "scan_topk"
            lay = lay or st.scan_layout(d, packed)
            if label == "timing" and lay != "resident":
                continue
            layout = st.SCAN_LAYOUTS.index(lay)
            G, n_tiles, acc, spans, LB = st._geometry(Np, tn, grp, want_acc)
            outi = torch.empty((spans, B, 2 * G), dtype=torch.int32, device=dev)
            outd = torch.empty((spans, B, 2 * G), dtype=torch.float32, device=dev)
            if name == "scan_topk":
                def launch():
                    return handle.scan_topk_launch(
                        qs.data_ptr(), Xs.data_ptr(), xd.data_ptr(), B, Np, d, tn, grp, acc,
                        LB, 1, 1, layout, outi.data_ptr(), stream)
            else:
                def launch():
                    return handle.scan_topk_unpacked_launch(
                        qs.data_ptr(), Xs.data_ptr(), xd.data_ptr(), B, Np, d, tn, grp, acc,
                        1, 1, layout, outd.data_ptr(), outi.data_ptr(), stream)
            kernel_lib.check(launch(), name)
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(20):
                launch()
            e.record()
            e.synchronize()
            ms = s.elapsed_time(e) / 20
            row = {"kernel": name, "variant": label, "layout": lay, "d": d, "n": Np,
                   "acc": acc, "spans": spans, "blocks": -(-B // 128) * spans, "ms": ms,
                   "tflops": 2 * B * Np * d / ms / 1e9}
            if label == "timing":
                head = (outi if name == "scan_topk" else outd.view(torch.int32))[0, 0, :16].tolist()
                keys = ("start", "full", "turn", "product", "epilogue", "loop", "sub_tiles")
                row["cycles"] = {f"warpgroup{w}": dict(zip(keys, head[8 * w:8 * w + 7]))
                                 for w in (0, 1)}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
