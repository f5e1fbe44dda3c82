#!/usr/bin/env python3
"""The program's spans against ``torch.profiler``'s trace on one card.

    python3 tools/span_clock.py [--n 200000] [--d 960] [--calls 20] [--seed 5]

Three checks, one JSON line each on standard output, then one with the card's name:

* ``threads``: whether a profile started on this thread records a
  ``record_function`` opened on a thread started after it (the pipeline's
  uploader and fetcher are such threads), with torch's version;
* ``clock``: ``--calls`` traced calls of an exact ``BruteForceIndex`` (``--n``
  x ``--d`` gauss rows, 1,000 queries a call, the scan's pipelined stream)
  and of ``device_search_stream`` on a small ``Hnsw`` (50,000 x 128), each
  span record of the calling thread matched to its profiler event in order:
  the largest difference of start and of end (us), by span name;
* ``cost``: the same exact calls untimed by the profiler with the spans off
  and on (``HNSW_PROFILE``'s two states), in turns: the median wall of a
  call (ms).

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

CALLING = ("search.call", "search.prepare", "search.finish", "stream.start", "stream.wait",
           "stream.dispatch", "stream.drain")


def profiled(torch, fn):
    """(fn's value, the profiler's host events [(name, start ns, end ns)])."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        out = fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in p.profiler.kineto_results.events() if e.device_type() != cuda]
    return out, host


def threads(torch) -> dict:
    from torch.autograd.profiler import record_function

    def work():
        with record_function("probe.thread"):
            time.sleep(0.001)

    def run():
        with record_function("probe.caller"):
            t = threading.Thread(target=work)
            t.start()
            t.join()

    _, host = profiled(torch, run)
    names = {n for n, _, _ in host}
    return {"line": "threads", "torch": torch.__version__, "cuda": torch.version.cuda,
            "caller_recorded": "probe.caller" in names,
            "thread_recorded": "probe.thread" in names}


def clock(torch, label, call, calls) -> dict:
    from hnsw_tpu_torch import PROFILER

    for _ in range(3):
        call()
    PROFILER.reset()
    _, host = profiled(torch, lambda: [call() for _ in range(calls)])
    recs = PROFILER.events()
    by_name = {}
    for name in CALLING:
        prof = sorted((s, e) for n, s, e in host if n == name)
        mine = sorted((r.start_ns, r.end_ns) for r in recs if r.name == name)
        if not mine:
            continue
        pairs = list(zip(prof, mine))
        by_name[name] = {
            "records": len(mine), "events": len(prof),
            "start_us": max(abs(ps - rs) for (ps, _), (rs, _) in pairs) / 1e3,
            "end_us": max(abs(pe - re) for (_, pe), (_, re) in pairs) / 1e3}
    worst = max(max(v["start_us"], v["end_us"]) for v in by_name.values())
    calls_seen = {r.call for r in recs if r.name == "search.call"}
    workers = sum(r.name in ("stream.upload", "stream.fetch", "stream.stage", "stream.sync")
                  for r in recs)
    return {"line": "clock", "engine": label, "calls": calls, "worst_us": worst,
            "search_call_worst_us": max(by_name["search.call"]["start_us"],
                                        by_name["search.call"]["end_us"]),
            "call_ids": len(calls_seen), "worker_records": workers,
            "worker_calls_known": all(r.call in calls_seen for r in recs), "spans": by_name}


def cost(torch, call, rounds=5, per=20) -> dict:
    from hnsw_tpu_torch import PROFILER, enable_profiling

    walls = {"off": [], "on": []}
    for r in range(rounds):
        for state in (("off", "on") if r % 2 == 0 else ("on", "off")):
            enable_profiling(state == "on")
            torch.cuda.synchronize()
            for _ in range(per):
                t0 = time.perf_counter()
                call()
                walls[state].append(time.perf_counter() - t0)
            PROFILER.reset()
    enable_profiling(True)
    return {"line": "cost", "calls_each": rounds * per,
            **{f"{k}_median_ms": 1e3 * statistics.median(v) for k, v in walls.items()}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--d", type=int, default=960)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("span_clock: CUDA is not available", file=sys.stderr)
        return 2
    from hnsw_tpu_torch import BruteForceIndex, Hnsw, enable_profiling
    from hnsw_tpu_torch.bench import f32_dataset
    from hnsw_tpu_torch.ops import kernel_lib
    from hnsw_tpu_torch.ops.beam_search import device_search_stream

    kernel_lib.build_all()
    enable_profiling()
    lines = [threads(torch)]
    rng = np.random.default_rng(args.seed)
    X, Q = f32_dataset("gauss", rng, args.n, 1000, args.d, 16)
    bf = BruteForceIndex("L2", device="cuda")
    bf.parallel_insert(X)
    exact = lambda: bf.search_batch(Q, 10)  # noqa: E731
    lines.append(clock(torch, "BruteForceIndex", exact, args.calls))
    Xg, Qg = f32_dataset("gauss", rng, 50_000, 10_000, 128, 16)
    h = Hnsw(max_nb_connection=16, max_elements=len(Xg), ef_construction=64, dist="L2",
             device="cuda")
    h.parallel_insert(Xg, mode="device", batch_size=4096)
    graph = lambda: device_search_stream(h, Qg, 10, 64, batch=16384)  # noqa: E731
    lines.append(clock(torch, "device_search_stream", graph, args.calls))
    lines.append(cost(torch, exact))
    for line in lines:
        print(json.dumps(line), flush=True)
    print(json.dumps({"line": "span_clock", "card": torch.cuda.get_device_name(0), "ok": True}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
