#!/usr/bin/env python3
"""Time the torch score forms of every metric at the shapes the device build
and search give them, on one NVIDIA card.

    python3 tools/metric_scores.py [--B 4096 --K 256]

For each metric of ``hnsw_tpu_torch/ops/distances.py`` with a batched form,
``scores(q, C)`` over ``q [B, d]`` and ``C [B, K, d]`` (d = 64 for the float
metrics, 256 for Hamming's 0/1 codes, 12 for Levenshtein's words): the
milliseconds of one call (median of CUDA-event timed calls after a warm-up),
the kernel launches it makes and its device time by kernel (torch.profiler).
Levenshtein's insert chain is also timed through ``torch.cummin`` against a
doubling scan of shifted minima (the same exact values) to show which of the
two its time follows.

Prints the card's name and power limit, then one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def ms(torch, fn, iters=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return float(np.median(out))


def profile(torch, fn, top=6):
    from torch.profiler import ProfilerActivity, profile as prof

    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in p.key_averages() if e.self_device_time_total > 0
          and e.device_type == torch.autograd.DeviceType.CUDA]
    ev.sort(key=lambda e: -e.self_device_time_total)
    return {"launches": int(sum(e.count for e in ev)),
            "device_ms": sum(e.self_device_time_total for e in ev) / 1e3,
            "top": [{"name": e.key[:70], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3} for e in ev[:top]]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--B", type=int, default=4096)
    ap.add_argument("--K", type=int, default=256)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("metric_scores: CUDA is not available", file=sys.stderr)
        return 2
    from hnsw_tpu_torch.ops import distances as D

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    B, K = args.B, args.K
    for name in ("L1", "L2", "Cosine", "Dot", "Hamming", "Jaccard", "Hellinger",
                 "Jeffreys", "JensenShannon", "Levenshtein"):
        d = {"Hamming": 256, "Levenshtein": 12}.get(name, 64)
        if name in ("Hamming", "Levenshtein"):
            hi = 2 if name == "Hamming" else 27
            q = torch.randint(0, hi, (B, d), device="cuda", generator=g).float()
            C = torch.randint(0, hi, (B, K, d), device="cuda", generator=g).float()
        else:
            q = torch.rand((B, d), device="cuda", generator=g)
            C = torch.rand((B, K, d), device="cuda", generator=g)
        fn = lambda m=D.get_metric(name): m.scores(q, C)
        print(json.dumps({"metric": name, "B": B, "K": K, "d": d, "ms": ms(torch, fn),
                          **profile(torch, fn)}), flush=True)
    # Levenshtein's insert chain: cummin against a doubling scan
    t = torch.rand((B, K, 13), device="cuda", generator=g)

    def doubling():
        x = t
        s = 1
        while s < x.shape[-1]:
            x = torch.cat([x[..., :s], torch.minimum(x[..., s:], x[..., :-s])], dim=-1)
            s *= 2
        return x

    assert torch.equal(doubling(), torch.cummin(t, dim=2).values)
    for label, fn in (("cummin", lambda: torch.cummin(t, dim=2)), ("doubling", doubling)):
        print(json.dumps({"insert_chain": label, "shape": list(t.shape), "ms": ms(torch, fn),
                          **profile(torch, fn)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
