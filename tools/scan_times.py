#!/usr/bin/env python3
"""Times the exact scan's wrappers (B2 ``scan_packed``, B5 ``scan_unpacked``) of
this checkout at the kernels rows' shapes.

    python3 tools/scan_times.py [--dtype bf16|f32]   # needs one NVIDIA card and nvcc

B=2048 queries against 200,704 x 128, 71,680 x 784 and 1,001,472 x 960 rows
(random normal, made on the card from seed 0), in bf16 (the copies of
``scan_copy``) or f32; the median of 10 CUDA-event timed calls of each, one
JSON line. It imports the package from the directory it is run in, so two
checkouts can be compared on one card by running it from each in turns
(parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.getcwd())

SHAPES = ((200_704, 128), (71_680, 784), (1_001_472, 960))


def main():
    import torch
    from hnsw_tpu_torch.ops import scan_topk as st

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_times: CUDA is not available", file=sys.stderr)
        return 2
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def median_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(iters):
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    out = {"checkout": os.path.basename(os.getcwd()), "dtype": args.dtype,
           "device": torch.cuda.get_device_name(0)}
    tn, grp = st.SCAN_TN, st.SCAN_GROUP
    for n, d in SHAPES:
        X = torch.randn((n, d), device=dev, generator=gen)
        xsq = (X * X).sum(1)
        Xs = st.scan_copy(X, dtype)
        qs = st.scan_copy(torch.randn((2048, d), device=dev, generator=gen), dtype)
        acc = st.scan_acc(n)
        out[f"B2_{d}_ms"] = median_ms(lambda: st.scan_packed(qs, Xs, xsq, tn, grp, acc))
        out[f"B5_{d}_ms"] = median_ms(lambda: st.scan_unpacked(qs, Xs, xsq, tn, grp, acc))
        del X, Xs, xsq, qs
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
