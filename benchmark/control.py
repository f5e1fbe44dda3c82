"""The check's control: the plain reference put in the program's place and
computed one precision below what the configuration states (TF32 for the
float32 configurations: ``references/<metric>.py::control``), judged by the
same numbers and limits as a run's answers. It must come out not correct.

    python3 benchmark/control.py --workload sift1m.batch --seeds 11 12 13

For each seed: the cell's corpus and query pool from the seed, the
reference's truth, the control's answers to the queries a run answers
(the whole pool; for an ingest cell ``check_queries`` over ``--rows`` rows),
and one JSON line with the numbers compared and whether they pass. The
benchmark's own runs never run it. Runs on the card only.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def control_run(cell: str, seed: int, device, rows=None, root: Path = ROOT,
                overrides: dict | None = None) -> dict:
    import numpy as np
    import torch

    from benchmark import datagen, harness, judge, references

    _, _, cfg, wl = harness.load_cell(cell, root, overrides)
    device = torch.device(device)
    X, Q = datagen.make(cfg["data"], cfg["n"], wl["pool"], cfg["d"], seed, device)
    n = min(rows or cfg["n"], cfg["n"])
    nq = wl.get("check_queries", wl["pool"])
    X, Q = X[:n], Q[:nq]
    ref = references.for_metric(cfg["metric"])
    t0 = time.perf_counter()
    truth = ref.truth(X, Q, cfg["k"])
    ids, dists = ref.control(X, Q, cfg["k"])
    judged = judge.judge(ref, X, Q, truth, np.arange(nq), ids.cpu().numpy(),
                         dists.cpu().numpy())
    checks = judge.compared(judged, cfg["recall_floor"], wl["limits"])
    return {"workload": cell, "seed": seed, "rows": n, "queries": nq,
            "correct": all(c["pass"] for c in checks.values()), "compared": checks,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rows", type=int, default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on an NVIDIA card", file=sys.stderr)
        return 1
    for seed in args.seeds:
        print(json.dumps(control_run(args.workload, seed, "cuda:0", args.rows)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
