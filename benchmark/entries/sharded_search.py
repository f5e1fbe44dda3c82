"""Closed loop of searches of a ``ShardedHnsw`` built in set-up from the
whole corpus over the cell's cards (``rig.devices``, one shard a card):
call ``i`` hands the pool's next ``per_call`` queries to
``ShardedHnsw.search_stream`` at the configuration's ef, k and expand and
the workload's ``stream_batch``, and waits for the ids and distances on the
host (``loop.QueryLoop``). Each batch fans out to every shard, runs the
shards' search programs chunk by chunk in lockstep, and merges on the first
card.

The traced run's tracer synchronises only the first card. That is sound
here: each call ends in a host fetch of the merged answers, and the merge on
the first card copies every shard's results from its card after that card's
stream has produced them, so a call's end waits on all four cards."""

from __future__ import annotations

from .. import engines
from ..loop import QueryLoop


def setup(run):
    cfg, batch = run.config, run.workload["stream_batch"]
    s = cfg["search"]
    k, ef, expand = cfg["k"], s["ef"], s["expand"]
    qdtype = None if s["query_dtype"] == "f32" else s["query_dtype"]
    sh = engines.built(cfg, run.Xh, run.devices)
    st = QueryLoop(run, sh, lambda q: sh.search_stream(q, k, ef, expand=expand, batch=batch,
                                                       query_dtype=qdtype))
    st.expand = expand
    return st


def call(st, i: int):
    return st.call(i)


def answers(st) -> dict:
    return {**st.answers(), "rows": len(st.engine)}


def shapes(st) -> dict:
    sh = st.engine
    return {"B": st.per, "E": st.expand, "d": sh.shards[0]._dim, "shards": sh.n_shards}


def release(st):
    for c in st.engine._programs:
        c.clear()
    st.engine = None
