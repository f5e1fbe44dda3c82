#!/usr/bin/env python3
"""Where the codec-score kernels of the beam loop (B1, B3, B4) spend their time.

    python3 tools/codec_variants.py [--only whole rows ...]   # one NVIDIA card, nvcc

Builds ``hnsw_tpu_torch/csrc/codec_scores.cu`` and ``codec_scores_gathered.cu``
once per variant with the measurement hooks of the sources and of
``csrc/codec_row.cuh`` and times each at the main paths' shapes: B=16384
queries, a random codec table of 200,001 blocks of M0=56 vector rows and 8 id
rows, d=128; B1 (id-carrying blocks) at E=4 and E=8, B3 (no id rows) at E=4, B4
over K=224 gathered rows. Each time is the median of 5 CUDA-event pairs around
5 launches queued back to back (the 0.48 GB a launch reads exceed the L2).

  whole        each kernel as the package builds it ("bulk" / "stream" entry)
  rows         the first port's kernels, the entry that stays for other shapes
  cast-unpack  int8 -> f32 by the plain cast instead of the byte permute
  no-math      copies and loads only: a 16-byte word is folded into one add
  no-load      the row product on whatever shared memory or registers hold:
               no copy, no barrier, no device-memory load of a row
  smem-query   the query read from shared memory in the inner loop, at the
               first port's layout (four-way bank conflict at d=128)
  prefetch     B1/B3 only: no staging; one block per query, every lane starts
               all of its 16-byte loads before the first product
  unroll-1/-4  B4 only: one or four rows per lane and step instead of two
  staged-query B1/B3 only: the query rides into the ring with its first node
               instead of being loaded by the consumer warps
  ring-4       B1/B3 only: the gather ring cut to 4 stages per block
  ring-36k     B1/B3 only: 36 KB rings (4 stages), six blocks per SM
  ring-110k    B1/B3 only: 110 KB rings (14 stages), two blocks per SM

``no-math``, ``no-load`` and ``smem-query`` compute wrong results by design. Prints the card's name and power limit, then one JSON
line per built library (ptxas's registers and spills of its kernels) and one
per measurement, with the bound of the shape (bytes over 3.35 TB/s).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

HBM_BYTES_PER_S = 3.35e12
BOTH = ("codec_scores", "codec_scores_gathered")
FUSED = ("codec_scores",)
GATHERED = ("codec_scores_gathered",)
# label -> (nvcc flags, sources, entry index)
VARIANTS = {
    "whole": ((), BOTH, 1),
    "rows": ((), BOTH, 0),
    "cast-unpack": (("-DCODEC_ROW_CAST_UNPACK",), BOTH, 1),
    "no-math": (("-DCODEC_ROW_NO_MATH",), BOTH, 1),
    "no-load": (("-DCODEC_ROW_NO_LOAD",), BOTH, 1),
    "smem-query": (("-DCODEC_ROW_SMEM_QUERY",), BOTH, 1),
    "prefetch": (("-DCODEC_SCORES_PREFETCH",), FUSED, 1),
    "unroll-1": (("-DCODEC_STREAM_UNROLL=1",), GATHERED, 1),
    "unroll-4": (("-DCODEC_STREAM_UNROLL=4",), GATHERED, 1),
    "staged-query": (("-DCODEC_BULK_STAGED_QUERY",), FUSED, 1),
    "ring-4": (("-DCODEC_RING_MAX_STAGES=4",), FUSED, 1),
    "ring-36k": (("-DCODEC_RING_SMEM=36864",), FUSED, 1),
    "ring-110k": (("-DCODEC_RING_SMEM=112640", "-DCODEC_RING_MAX_STAGES=14"), FUSED, 1),
}


def registers(log: str) -> dict:
    """{kernel<template arguments>: registers, spilled bytes} from nvcc's ptxas
    report (the mangled entry names cut down to the kernel's own)."""
    out = {}
    for block in log.split("Compiling entry function")[1:]:
        entry = re.search(r"'([^']+)'", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if entry and regs:
            name = re.search(r"\d+(codec_\w+?_kernel)I((?:L[ib]\d+E)+)", entry.group(1))
            key = (f"{name.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', name.group(2)))}>"
                   if name else entry.group(1))
            out[key] = {"registers": int(regs.group(1)),
                        "spill_stores": int(spill.group(1)) if spill else None}
    return out


def median_ms(torch, launch, pairs=5, queued=5):
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(pairs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(queued):
            launch()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / queued)
    return float(np.median(times))


def main():
    import torch
    from hnsw_tpu_torch.ops import kernel_lib

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="*", default=None, choices=list(VARIANTS),
                    help="variants to build and time (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("codec_variants: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, M0, RID, d, n = 16384, 56, 8, 128, 200_000
    cap1 = n + 1
    vec = torch.randint(-127, 128, (cap1, M0, d), generator=g, device=dev, dtype=torch.int8)
    idt = torch.randint(-1, cap1, (cap1, RID * d // 4), generator=g, device=dev,
                        dtype=torch.int32)
    tables = {RID: torch.cat([vec, idt.view(torch.int8).reshape(cap1, RID, d)], 1), 0: vec}
    del idt
    q = torch.randn((B, d), generator=g, device=dev)
    qsq = (q * q).sum(1).contiguous()
    scale = torch.full((1,), 0.0123, device=dev)
    srcs = {E: torch.randint(0, cap1, (B, E), generator=g, device=dev, dtype=torch.int32)
            for E in (4, 8)}
    K = 4 * M0
    blk = torch.randint(-127, 128, (B, K * d), generator=g, device=dev, dtype=torch.int8)
    csq = torch.rand((B, K), generator=g, device=dev) * 100.0
    stream = torch.cuda.current_stream(dev).cuda_stream
    labels = args.only or list(VARIANTS)
    with tempfile.TemporaryDirectory(prefix="codec_variants_") as tmp:
        procs = []
        built = {}  # (flags, source) -> the library: "whole" and "rows" share one
        for label in labels:  # every nvcc process at once
            flags, sources, _ = VARIANTS[label]
            for name in sources:
                if (flags, name) in built:
                    continue
                lib = os.path.join(tmp, f"{name}-{label}.so")
                cmd = [kernel_lib._nvcc(), *kernel_lib.NVCC_FLAGS, *flags, "-o", lib,
                       str(kernel_lib.CSRC / f"{name}.cu")]
                built[(flags, name)] = [lib, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
                procs.append((flags, name))
        for key in procs:
            lib, p = built[key]
            log, _ = p.communicate()
            if p.returncode:
                print(log, file=sys.stderr)
                return 1
            handle = ctypes.CDLL(lib)
            kernel_lib._bind(key[1], handle)
            built[key] = handle
            print(json.dumps({"built": key[1], "flags": list(key[0]),
                              "ptxas": registers(log)}), flush=True)
        for label in labels:
            flags, sources, entry = VARIANTS[label]
            cases = []
            if "codec_scores" in sources:
                cases += [("B1", RID, 4), ("B1", RID, 8), ("B3", 0, 4)]
            if "codec_scores_gathered" in sources:
                cases.append(("B4", None, 4))
            for kernel, rid, E in cases:
                out = torch.empty((B, E * M0), dtype=torch.float32, device=dev)
                if kernel == "B4":
                    handle = built[(flags, "codec_scores_gathered")]
                    nbytes = B * K * d + 2 * B * K * 4 + B * d * 4 + B * 4

                    def launch():
                        return handle.codec_scores_gathered_launch(
                            q.data_ptr(), blk.data_ptr(), csq.data_ptr(), qsq.data_ptr(),
                            scale.data_ptr(), B, K, d, 0, entry, out.data_ptr(), stream)
                else:
                    handle = built[(flags, "codec_scores")]
                    tbl, src = tables[rid], srcs[E]
                    ids = (torch.empty((B, E * M0), dtype=torch.int32, device=dev)
                           if rid else None)
                    nbytes = (B * E * (M0 * d + (4 * M0 if rid else 0)) + B * d * 4 + B * 4
                              + B * E * 4 + B * E * M0 * 4 * (2 if rid else 1))

                    def launch():
                        return handle.codec_scores_launch(
                            src.data_ptr(), q.data_ptr(), qsq.data_ptr(), scale.data_ptr(),
                            tbl.data_ptr(), B, E, M0, rid, d, 0, entry, out.data_ptr(),
                            ids.data_ptr() if ids is not None else None, stream)
                kernel_lib.check(launch(), f"{kernel} {label}")
                torch.cuda.synchronize()
                print(json.dumps({
                    "kernel": kernel, "variant": label, "E": E, "ms": median_ms(torch, launch),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
