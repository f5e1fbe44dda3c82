#!/usr/bin/env python3
"""Where the tensor-core exact scan (kernels B2 and B5) spends its time.

    python3 tools/scan_variants.py [--acc 7 3]   # needs one NVIDIA card and nvcc

Builds ``hnsw_tpu_torch/csrc/scan_topk.cu`` and ``scan_topk_unpacked.cu`` four
times with the measurement hooks of ``csrc/scan_tile.cuh`` and times each
build's tensor-core entry at the main path's shape (B=2048 queries, 200704 x
128 bf16 corpus rows, spans of 7 tiles), 20 launches back to back between two
CUDA events:

  whole        the kernel as the package builds it
  no-epilogue  the tile product and the copy ring only (results are wrong)
  no-product   the keep-2 epilogue only (results are wrong)
  timing       the whole kernel with cycle counters around each phase of the
               main loop; prints, for one thread of each warpgroup of block
               (0, 0), the cycles spent starting the product and the copies
               (start), waiting for a stage (full), for its turn (turn), for
               the product (product), in the epilogue, and in the whole loop

``--acc`` times every variant once per span length (tiles per span; default:
the package's ``scan_acc``, 7 tiles = 14 spans = 224 blocks; 3 gives 33 spans =
528 blocks, four whole waves on 132 SMs, at 2.4x the candidate buffer).

Prints the card's name and power limit, then one JSON line per measurement.
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_variants: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    B, d = 2048, 128
    Xp, xsq, _ = st.pad_corpus(rng.standard_normal((200_000, d)).astype(np.float32))
    Np = Xp.shape[0]
    Xs = torch.from_numpy(Xp).to(dev).to(torch.bfloat16)
    xd = torch.from_numpy(xsq).to(dev)
    qs = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).to(dev).to(torch.bfloat16)
    tn, grp = st.SCAN_TN, st.SCAN_GROUP
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory(prefix="scan_variants_") as tmp:
        procs = []
        for label, flags in VARIANTS:  # all eight nvcc processes together
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
        cases = [(a, *t) for a in (args.acc or [st.scan_acc(Np)]) for t in libs]
        for want_acc, label, name, handle in cases:
            G, n_tiles, acc, spans, LB = st._geometry(Np, tn, grp, want_acc)
            outi = torch.empty((spans, B, 2 * G), dtype=torch.int32, device=dev)
            outd = torch.empty((spans, B, 2 * G), dtype=torch.float32, device=dev)
            if name == "scan_topk":
                def launch():
                    return handle.scan_topk_launch(
                        qs.data_ptr(), Xs.data_ptr(), xd.data_ptr(), B, Np, d, tn, grp, acc,
                        LB, 1, 1, outi.data_ptr(), stream)
            else:
                def launch():
                    return handle.scan_topk_unpacked_launch(
                        qs.data_ptr(), Xs.data_ptr(), xd.data_ptr(), B, Np, d, tn, grp, acc,
                        1, 1, outd.data_ptr(), outi.data_ptr(), stream)
            kernel_lib.check(launch(), name)
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(20):
                launch()
            e.record()
            e.synchronize()
            row = {"kernel": name, "variant": label, "acc": acc, "spans": spans,
                   "blocks": -(-B // 128) * spans, "ms": s.elapsed_time(e) / 20}
            if label == "timing":
                head = (outi if name == "scan_topk" else outd.view(torch.int32))[0, 0, :16].tolist()
                keys = ("start", "full", "turn", "product", "epilogue", "loop", "sub_tiles")
                row["cycles"] = {f"warpgroup{w}": dict(zip(keys, head[8 * w:8 * w + 7]))
                                 for w in (0, 1)}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
