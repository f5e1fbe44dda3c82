"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload sift1m.batch --seed 7 --seconds 30 --trace 0

Runs on the NVIDIA card it is started on, and on nothing else: without a
card, or with fewer cards than the cell asks for, it exits 1 and prints no
result. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number of the check beside its
limit); the same numbers are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the program's kernel caches stay at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[0] = str(ROOT)  # the checkout's packages, not this folder's modules

FORBIDDEN = ("jax", "jaxlib", "flax", "hnsw_tpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell, _ = harness.cell_spec(harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} NVIDIA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    try:  # the card's name and power limit beside the run's numbers
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        card = f"nvidia-smi: {e}"
    print(f"[bench] card: {card}", file=sys.stderr)
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                      T_START)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: the port must not", file=sys.stderr)
        return 1
    for name, c in out["compared"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
