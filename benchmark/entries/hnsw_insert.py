"""Ingest a fixed job into an ``Hnsw`` that starts empty: call ``i``
inserts the corpus' next ``chunk`` rows in order through the device build
(``parallel_insert(mode="device")``, the navigability repair included) and
synchronizes, until the workload's ``rows`` are in; then the window ends,
so every run does the same work. The deadline is only a cap: a job that
outlasts it stops after the chunk in flight. After the window the index is
searched at the configuration's ef with ``check_queries`` of the pool, and
those answers are judged over the rows inserted.

Set-up builds and drops an index of ``warm_rows`` rows through the same
calls, so the window finds the kernels built and loaded. The build's CUDA
graphs are keyed on each call's row count, and every call captures its own:
that is the program's work on every insert, and ``build_capture_s`` reads
it."""

from __future__ import annotations

import types

import numpy as np
import torch

from ..engines import Hnsw


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(run):
    cfg, wl = run.config, run.workload
    if wl["rows"] > len(run.Xh):
        raise ValueError("the job holds more rows than the corpus")
    warm = Hnsw.empty(cfg, run.device)
    for s in range(0, wl["warm_rows"], wl["chunk"]):
        Hnsw.insert(warm, cfg, run.Xh[s:min(s + wl["chunk"], wl["warm_rows"])], s)
    del warm
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return types.SimpleNamespace(h=Hnsw.empty(cfg, run.device), cfg=cfg, Xh=run.Xh[:wl["rows"]],
                                 Qh=run.Qh, chunk=wl["chunk"], device=run.device,
                                 check=wl["check_queries"], done=0)


def call(st, i: int):
    s = st.done
    if s >= len(st.Xh):
        return None
    rows = st.Xh[s:s + st.chunk]
    Hnsw.insert(st.h, st.cfg, rows, s)
    _sync(st.device)
    st.done += len(rows)
    stats = getattr(st.h, "_round_stats", None)
    return len(rows), (dict(stats) if stats else None)


def answers(st) -> dict:
    from hnsw_tpu_torch.ops.beam_search import device_search_stream

    s, k = st.cfg["search"], st.cfg["k"]
    q = st.Qh[:st.check]
    if len(st.h):
        ids, dists = device_search_stream(st.h, q, k, s["ef"], batch=len(q),
                                          expand=s["expand"])
    else:  # nothing was inserted: no answer
        ids, dists = np.full((len(q), k), -1, np.int64), np.full((len(q), k), np.inf, np.float32)
    return {"qidx": np.arange(len(q)), "ids": Hnsw.rows(st.h, ids), "dists": dists,
            "rows": st.done, "attempted": st.done, "failed": st.done - len(st.h)}


def shapes(st) -> dict:
    return {}


def release(st):
    st.h.drop_programs()
    st.h = None
