"""One run of one cell: set-up, the measured window, the check of every
answer against the plain reference, and the result line.

Everything that belongs to one cell is found by name: the cell and its
configuration in ``BENCHMARK.json``, the configuration's sizes in its
``file``, the traffic in ``workloads/<cell>.json``, the data recipe in
``datagen/<recipe>.py``, the engine in ``engines/<engine>.py``, the entry
that drives the system in ``entries/<entry>.py``, the reference in
``references/<metric>.py`` and each metric's reader in
``metrics/<metric>.py``.

The window starts with the first call and runs calls back to back until
``seconds`` have passed; a call started before then runs to its end and
counts. A traced run (``trace``) profiles the workload's fixed run of steady
calls inside the window and reports the per-layer metrics; otherwise the
end-to-end ones. After the window the peak memory is read, the answers are
taken, the system is freed, and only then does the reference run.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import torch

from . import datagen, judge, references, tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(spec: dict, name: str) -> tuple:
    """(the cell's entry in ``BENCHMARK.json``, its configuration's entry)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    return cell, configs[cell["config"]]


def load_cell(cell_name: str, root: Path = ROOT, overrides: dict | None = None) -> tuple:
    """(``BENCHMARK.json``, the cell's entry, its configuration file, its
    workload file), with ``overrides`` replacing keys of the last two."""
    spec = load_json(root / "BENCHMARK.json")
    cell, cfg_entry = cell_spec(spec, cell_name)
    cfg = load_json(root / cfg_entry["file"])
    wl = load_json(HERE / "workloads" / f"{cell_name}.json")
    if wl["traffic"] != cell["traffic"]:
        raise SystemExit(f"{cell_name}: the workload file holds traffic {wl['traffic']!r}")
    for key, part in (("config", cfg), ("workload", wl)):
        part.update((overrides or {}).get(key, {}))
    return spec, cell, cfg, wl


def metric_specs(spec: dict, cell: str, trace: bool) -> list:
    """The metrics this cell reports: per-layer ones in a traced run,
    end-to-end ones otherwise; a metric without ``workloads`` in every cell."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_module(path: Path, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """``metrics/<name>.py``: its ``read(record)`` gives the metric or None."""
    return load_module(HERE / "metrics" / f"{name}.py",
                       "benchmark.metrics." + name.replace(".", "_"))


def window_rate(calls) -> float | None:
    """Work over the window: all the calls' work over the seconds from the
    first call's start to the last call's end."""
    if not calls:
        return None
    return sum(n for _, _, n in calls) / (calls[-1][1] - calls[0][0])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(entry, state, seconds: float, tracer=None) -> tuple:
    """The measured calls: [(start, end, work)] on the host's clock, and
    each call's info."""
    calls, infos = [], []
    deadline = time.perf_counter() + seconds
    i = 0
    while True:
        if calls and time.perf_counter() >= deadline and not (tracer and tracer.pending(i)):
            break
        if tracer:
            tracer.start(i)
        t0 = time.perf_counter()
        got = entry.call(state, i)
        t1 = time.perf_counter()
        if tracer:
            tracer.stop(i)
        if got is None:
            break
        calls.append((t0, t1, got[0]))
        infos.append(got[1])
        i += 1
    return calls, infos


def _peak(devices) -> int:
    """The peak of allocated bytes on the fullest of the cell's cards."""
    if devices[0].type != "cuda":
        return 0
    from hnsw_tpu_torch.ops import program

    return int(max(p[0] for p in program.peak_memory_by_card(devices).values()))


def run(cell_name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
        root: Path = ROOT, overrides: dict | None = None) -> dict:
    """One run of ``cell_name``; returns the result line as a dict. The
    caller has checked the device: ``device`` is the first of the cell's
    ``chips`` cards (``rig.devices`` all of them). ``overrides`` replaces keys of the
    configuration and the workload file (the CPU tests' small sizes)."""
    from hnsw_tpu_torch.ops import kernel_lib
    from hnsw_tpu_torch.utils.profiling import PROFILER, enable_profiling

    spec, cell, cfg, wl = load_cell(cell_name, root, overrides)
    device = torch.device(device)
    devices = ([torch.device("cuda", (device.index or 0) + c) for c in range(cell["chips"])]
               if device.type == "cuda" else [device])
    if device.type == "cuda":
        from hnsw_tpu_torch.ops import program

        kernel_lib.build_all()
        for dev in devices:
            program.reset_peak_memory(dev)
    X, Q = datagen.make(cfg["data"], cfg["n"], wl["pool"], cfg["d"], seed, device)
    rig = types.SimpleNamespace(config=cfg, workload=wl, device=device, devices=devices,
                                X=X, Q=Q, Xh=X.cpu().numpy(), Qh=Q.cpu().numpy())
    entry = importlib.import_module(f"benchmark.entries.{wl['entry']}")
    tracer = None
    if trace:
        enable_profiling()
        t = wl["trace"]
        tracer = tracing.Tracer(t["first"], t["calls"], device, kernel_lib.LAUNCHES,
                                lambda: dict(PROFILER.report().get("counters", {})))
    state = entry.setup(rig)
    _sync(device)
    log(f"[bench] {cell_name} seed {seed}: set-up done in {time.perf_counter() - t_start:.2f} s")
    calls, infos = window(entry, state, seconds, tracer)
    peak = _peak(devices)
    if len(calls) >= 3:  # a window that speeds up or slows down as it goes
        third = [calls[j * len(calls) // 3:(j + 1) * len(calls) // 3] for j in range(3)]
        log("[bench] mean call wall by third of the window: " + " ".join(
            f"{1e3 * sum(t1 - t0 for t0, t1, _ in c) / len(c):.3f}" for c in third) + " ms")
    if 0 < len(calls) <= 32:  # few long calls (an ingest's chunks): where each ended
        log("[bench] calls ended at " + " ".join(f"{t1 - calls[0][0]:.2f}" for _, t1, _ in calls)
            + " s")
    rec_trace = None
    if tracer is not None:
        rec_trace = tracer.record()
        traced = calls[tracer.first:tracer.last + 1]
        rec_trace["walls_s"] = sum(t1 - t0 for t0, t1, _ in traced)
        rest = calls[:tracer.first] + calls[tracer.last + 1:]
        rec_trace["untraced_wall_s"] = (sum(t1 - t0 for t0, t1, _ in rest) / len(rest)
                                        if rest else None)
        log(f"[bench] trace: {len(rec_trace['device'])} device records, "
            f"{len(rec_trace['host'])} host, read in {rec_trace['read_s']:.2f} s")
    got = entry.answers(state)
    shapes = entry.shapes(state)
    entry.release(state)
    del state, rig
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = references.for_metric(cfg["metric"])
    Xr = X[:got["rows"]]
    Qr = Q[:int(got["qidx"].max()) + 1 if len(got["qidx"]) else 1]
    truth = ref.truth(Xr, Qr, cfg["k"])
    judged = judge.judge(ref, Xr, Qr, truth, got["qidx"], got["ids"], got["dists"])
    log(f"[bench] reference and judge: {time.perf_counter() - t_ref:.2f} s over "
        f"{judged['answers']} answers")
    checks = judge.compared(judged, cfg["recall_floor"], wl["limits"])

    rec = types.SimpleNamespace(calls=calls, infos=infos, judged=judged, shapes=shapes,
                                setup_s=calls[0][0] - t_start if calls else None,
                                trace=rec_trace, config=cfg, workload=wl)
    metrics = {}
    for m in metric_specs(spec, cell_name, trace):
        value = reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": all(c["pass"] for c in checks.values()),
           "attempted": int(got["attempted"]),
           "failed": int(got.get("failed", judged["bad_rows"])),
           "metrics": metrics, "device": dev_info}
    if rec_trace is not None:
        dev_info["busy_s"] = rec_trace["busy_s"]
        dev_info["window_s"] = rec_trace["window_s"]
        out["breakdown"] = tracing.breakdown(rec_trace)
    out["compared"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return out
