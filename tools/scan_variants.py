#!/usr/bin/env python3
"""Where the tensor-core exact scan (kernels B2 and B5) spends its time.

    python3 tools/scan_variants.py [--acc 7 3] [--d 784 --n 70000]
        [--layouts resident kloop] [--extra SCAN_KLOOP_MAX_STAGES=3 ...]
        [--dtype f32]
    # needs one NVIDIA card and nvcc

Builds ``hnsw_tpu_torch/csrc/scan_topk.cu`` and ``scan_topk_unpacked.cu`` with
the measurement hooks of ``csrc/scan_tile.cuh`` and times each build's
tensor-core entry (B=2048 queries against ``--n`` gauss rows of ``--d``
columns in bf16, or with ``--dtype f32`` f32 rows through the tf32x3 entry;
default the main path's 200704 x 128, spans of 7 tiles), 20 launches back to
back between two CUDA events, in each layout of ``--layouts`` (default: the
one ``scan_layout`` picks for the depth):

  whole        the kernel as the package builds it
  no-epilogue  the tile product and the copy ring only (results are wrong;
               f32: the split too)
  no-product   the keep-2 epilogue only (results are wrong; f32: the split too)
  timing       (resident layout only) the whole kernel with cycle counters
               around each phase of the main loop; prints, for one thread of
               each warpgroup of block (0, 0), the cycles spent starting the
               product and the copies (start), waiting for a stage (full), for
               its turn (turn), for the product (product), in the epilogue,
               and in the whole loop
  -DNAME=VAL   one more whole build per ``--extra`` define (the K-looped
               ring's ``SCAN_KLOOP_MAX_STAGES``; f32's ``SCAN_TF32_RAW_HI``)

With ``--dtype f32`` also, each beside the loop's barriers and waits:

  copies       the copy ring alone (no split, product or epilogue)
  product      the three tf32 products alone (no split, no epilogue)
  split        the split of each box into tf32 parts alone
  epilogue     the keep-2 epilogue alone (no split, no product)
  no-copy      the whole kernel on whatever the ring holds: each stage is
               handed over at once, nothing copied (``SCAN_TILE_NO_COPY``)
  product-no-copy, split-no-copy   the products, the split, without copies
  loop-no-copy the loop alone: its barriers, waits and per-box sums

The builds that compute the scan (whole and the ``--extra`` ones) also report
B5's largest error against its plain version over the terms |x|^2 + 2 |q.x|
(``err_over_terms``; ``scan_unpacked_plain``, TF32 off) and B2's share of
cells whose loc bits equal the plain version's (``loc_equal``): a build with
``SCAN_TF32_RAW_HI`` agrees only if the tensor cores ignore an f32 word's low
13 bits.

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
F32_VARIANTS = (
    ("copies", ("-DSCAN_TILE_NO_SPLIT", "-DSCAN_TILE_NO_PRODUCT", "-DSCAN_TILE_NO_EPILOGUE")),
    ("product", ("-DSCAN_TILE_NO_SPLIT", "-DSCAN_TILE_NO_EPILOGUE")),
    ("split", ("-DSCAN_TILE_NO_PRODUCT", "-DSCAN_TILE_NO_EPILOGUE")),
    ("epilogue", ("-DSCAN_TILE_NO_SPLIT", "-DSCAN_TILE_NO_PRODUCT")),
    ("no-copy", ("-DSCAN_TILE_NO_COPY",)),
    ("product-no-copy", ("-DSCAN_TILE_NO_COPY", "-DSCAN_TILE_NO_SPLIT",
                         "-DSCAN_TILE_NO_EPILOGUE")),
    ("split-no-copy", ("-DSCAN_TILE_NO_COPY", "-DSCAN_TILE_NO_PRODUCT",
                       "-DSCAN_TILE_NO_EPILOGUE")),
    ("loop-no-copy", ("-DSCAN_TILE_NO_COPY", "-DSCAN_TILE_NO_SPLIT", "-DSCAN_TILE_NO_PRODUCT",
                      "-DSCAN_TILE_NO_EPILOGUE")))
SOURCES = ("scan_topk", "scan_topk_unpacked")
# the builds that compute the scan: checked against the plain versions
CORRECT = ("whole",)


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
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                    help="bf16 rows (entry wgmma) or f32 rows (entry tf32x3)")
    args = ap.parse_args()
    f32 = args.dtype == "f32"
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
    dtype = torch.float32 if f32 else torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    Xs = torch.from_numpy(Xp).to(dev).to(dtype)
    xd = torch.from_numpy(xsq).to(dev)
    qs = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).to(dev).to(dtype)
    entry = kernel_lib.SCAN_ENTRIES.index(st.scan_entry(dtype, d))
    tn, grp = st.SCAN_TN, st.SCAN_GROUP
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory(prefix="scan_variants_") as tmp:
        procs = []
        extra = tuple((f"-D{x}", (f"-D{x}",)) for x in args.extra)
        variants = VARIANTS + (F32_VARIANTS if f32 else ()) + extra
        if f32:  # the resident layout's cycle counters do not apply
            variants = tuple(v for v in variants if v[0] != "timing")
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
        plain = {}  # the plain versions' outputs, by (source, acc)
        for want_acc, lay, label, name, handle in cases:
            packed = name == "scan_topk"
            lay = lay or st.scan_layout(d, packed, dtype)
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
                        LB, int(not f32), entry, layout, outi.data_ptr(), stream)
            else:
                def launch():
                    return handle.scan_topk_unpacked_launch(
                        qs.data_ptr(), Xs.data_ptr(), xd.data_ptr(), B, Np, d, tn, grp, acc,
                        int(not f32), entry, layout, outd.data_ptr(), outi.data_ptr(),
                        stream)
            kernel_lib.check(launch(), name)
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(20):
                launch()
            e.record()
            e.synchronize()
            ms = s.elapsed_time(e) / 20
            row = {"kernel": name, "variant": label, "dtype": args.dtype, "layout": lay,
                   "d": d, "n": Np, "acc": acc, "spans": spans,
                   "blocks": -(-B // 128) * spans, "ms": ms,
                   "tflops": 2 * B * Np * d / ms / 1e9}
            if label in CORRECT or label.startswith("-D"):
                key = (name, acc)
                if key not in plain:  # on 256 queries: [B, N] f32 intermediates
                    fn = st.scan_packed_plain if packed else st.scan_unpacked_plain
                    plain[key] = fn(qs[:256], Xs, xd, tn, grp, acc)
                if packed:
                    mask = (1 << LB) - 1
                    row["loc_equal"] = float(((outi[:, :256] & mask) == (plain[key] & mask))
                                             .float().mean())
                else:
                    up, jp = plain[key]
                    pick = xd[jp.long()]
                    row["err_over_terms"] = float(((outd[:, :256] - up).abs()
                                                   / (pick + (pick - up).abs())).max())
            if label == "timing":
                head = (outi if name == "scan_topk" else outd.view(torch.int32))[0, 0, :16].tolist()
                keys = ("start", "full", "turn", "product", "epilogue", "loop", "sub_tiles")
                row["cycles"] = {f"warpgroup{w}": dict(zip(keys, head[8 * w:8 * w + 7]))
                                 for w in (0, 1)}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
