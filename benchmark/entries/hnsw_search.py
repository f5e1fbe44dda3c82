"""Closed loop of searches of an ``Hnsw`` built in set-up from the whole
corpus: call ``i`` hands the pool's next ``per_call`` queries to
``device_search_stream``, the pipelined batch entry, at the configuration's
ef, k and expand and the workload's ``stream_batch``, and waits for the ids
and distances on the host (``loop.QueryLoop``)."""

from __future__ import annotations

from .. import engines
from ..loop import QueryLoop


def _searcher(run, h):
    from hnsw_tpu_torch.ops.beam_search import device_search_stream

    cfg, batch = run.config, run.workload["stream_batch"]
    s = cfg["search"]
    k, ef, expand = cfg["k"], s["ef"], s["expand"]
    qdtype = None if s["query_dtype"] == "f32" else s["query_dtype"]
    return lambda q: device_search_stream(h, q, k, ef, batch=batch, expand=expand,
                                          query_dtype=qdtype)


def setup(run):
    h = engines.built(run.config, run.Xh, run.device)
    st = QueryLoop(run, h, _searcher(run, h))
    st.expand = run.config["search"]["expand"]
    return st


def call(st, i: int):
    return st.call(i)


def answers(st) -> dict:
    return {**st.answers(), "rows": len(st.engine)}


def shapes(st) -> dict:
    h = st.engine
    codec = h.device_codec()
    return {"B": st.per, "E": st.expand, "d": h._dim,
            **({"M0": codec.M0, "rid": codec.id_rows} if codec is not None else {})}


def release(st):
    st.engine.drop_programs()
    st.engine = None
