#!/usr/bin/env python3
"""The device build through its round programs against the eager rounds, on
one card, at a bench size.

    python3 tools/build_programs.py [--n 1000000] [--d 128] [--batch 16384]
        [--seed 1234] [--forms program,chunked,eager]

Builds bench.py's gauss corpus (``hnsw_tpu_torch.bench.make_dataset``,
rounded to float32; ``--d`` its width) with path 1's settings (M=24, efC=400,
level scale 0.5, kept pruned links, cap 96; ``--batch`` the build batch,
16384 by default) once per form, in the order given (a
form may repeat, for runs in turns): ``program`` (the card's default: every
round through ``ops/program.py::BuildPrograms``), ``chunked`` (the same
round programs with nothing captured: every round runs their pieces
directly, one host read per ``CHUNK`` loop steps, as a key's first round
does) and ``eager`` (``round_step``, one host read per beam iteration and
descent hop). Each round runs between two synchronizes and is timed on the
host clock, after an untimed 20k-row build that warms the process. Prints
one JSON line per build (seconds, per-round ms, peak device memory, the
round programs' counts, pool, the peak each kind of part measured at its
first run and the keys left uncaptured because their captures would take
the pool past its budget, with their bytes), then one with every
build's tables and in-degrees compared with the first's bit for bit on every
real row and the traversal codec's build (row-chunked) against a one-shot
gather: each one's peak device memory above what was allocated before it,
and the blocks byte-equal. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--forms", default="program,eager")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("build_programs: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hnsw_tpu_torch import enable_profiling
    from hnsw_tpu_torch.bench import f32_dataset
    from hnsw_tpu_torch.ops import insert_rounds, program

    torch.backends.cuda.matmul.allow_tf32 = False
    enable_profiling()
    print(subprocess_card(), flush=True)
    X, _ = f32_dataset("gauss", np.random.default_rng(args.seed), args.n, 1, args.d, 16)
    forms = args.forms.split(",")
    # a short build first, so that no timed build pays the process's first
    # use of the card (the allocator's growth, the libraries' set-up)
    cs.build_path1(torch, X[:20000], args.batch)
    held, first = [], None
    for form in forms:
        if form == "eager":
            ctx, owner, name = cs.eager_rounds(), insert_rounds, "round_step"
            keep = lambda a, out: (tuple(a[3]), a[7])  # noqa: E731
        else:
            ctx = (uncaptured_rounds(program) if form == "chunked"
                   else contextlib.nullcontext())
            owner, name = program.BuildPrograms, "round"
            keep = lambda a, out: (a[1].tables(), a[1].indeg0)  # noqa: E731
        with ctx, cs.watched_rounds(torch, owner, name, -1, keep) as rec:
            h, build_s, peaks = cs.build_path1(torch, X, args.batch)
        walls = rec["walls_ms"]
        print(json.dumps({"form": form, "n": args.n, "d": args.d, "batch": args.batch,
                          "build_s": build_s, **peaks,
                          "rounds": len(walls), "rounds_s": sum(walls) / 1e3,
                          "round_ms": walls,
                          "round_programs": getattr(h, "_round_stats", None)}), flush=True)
        held.append(rec["held"])
        first = h if first is None else first
        h = None
    out = {"n": args.n, "d": args.d, "batch": args.batch, "forms": forms, "tables_equal_first": [], "first_difference": []}
    for other in held[1:]:
        equal, diff = cs.tables_equal(torch, held[0], other, args.n)
        out["tables_equal_first"].append(equal)
        out["first_difference"].append(diff)
    held = None
    # the codec check needs the index's traversal codec ("auto" declines one
    # past CODEC_MAX_BYTES, as at d = 960)
    out["codec_failures"] = (cs.phase_codec(torch, first)
                             if first.device_codec() is not None else None)
    print(json.dumps(out), flush=True)
    return 0 if all(out["tables_equal_first"]) and not out["codec_failures"] else 1


@contextlib.contextmanager
def uncaptured_rounds(program):
    """Builds in this scope run every round through the round programs with
    nothing captured: a program's run count goes back to 0 after each run,
    so every round is a first run (its pieces called directly, one host read
    per ``CHUNK`` loop steps)."""
    real = program.RoundProgram.finish

    def finish(self):
        real(self)
        self.runs = 0

    program.RoundProgram.finish = finish
    try:
        yield
    finally:
        program.RoundProgram.finish = real


def subprocess_card() -> str:
    import subprocess
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
