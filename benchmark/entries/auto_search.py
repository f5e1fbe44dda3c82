"""Closed loop of ``search_batch`` calls on the configuration's engine built
in set-up from the whole corpus (``AutoIndex``: whichever engine it chooses
for the corpus): call ``i`` hands the pool's next ``per_call`` queries over
and waits for the ids and distances on the host (``loop.QueryLoop``)."""

from __future__ import annotations

import sys

from .. import engines
from ..loop import QueryLoop


def setup(run):
    a = engines.built(run.config, run.Xh, run.device)
    print(f"[bench] engine: {getattr(a, 'engine_name', type(a).__name__)}", file=sys.stderr)
    k = run.config["k"]
    st = QueryLoop(run, a, lambda q: a.search_batch(q, k))
    st.n, st.d = run.Xh.shape
    return st


def call(st, i: int):
    return st.call(i)


def answers(st) -> dict:
    return {**st.answers(), "rows": st.n}


def shapes(st) -> dict:
    return {"B": st.per, "N": st.n, "d": st.d, "k": st.k}


def release(st):
    eng = st.engine.engine
    if hasattr(eng, "drop_programs"):
        eng.drop_programs()
    st.engine = None
