"""A closed loop of searches over a query pool, shared by the search
entries: call ``i`` hands the pool's next ``per_call`` queries (the pool
cycled in order) to ``search`` and keeps its ids and distances, on the host.
Construction runs the workload's ``warm_calls`` and forgets their answers."""

from __future__ import annotations

import numpy as np

from . import engines


class QueryLoop:
    def __init__(self, run, engine, search):
        wl = run.workload
        self.per, self.pool = wl["per_call"], wl["pool"]
        if self.pool % self.per:
            raise ValueError("the query pool must hold a whole number of calls")
        self.cfg, self.k, self.Qh = run.config, run.config["k"], run.Qh
        self.engine, self.search, self.out = engine, search, []
        for i in range(wl["warm_calls"]):
            self.call(i)
        self.out.clear()

    def call(self, i: int):
        s = (i * self.per) % self.pool
        self.out.append(self.search(self.Qh[s:s + self.per]))
        return self.per, None

    def answers(self) -> dict:
        """Every answer of the window: its query's place in the pool, its ids
        as corpus rows, its distances, and the queries attempted."""
        n = len(self.out)
        qidx = ((np.arange(n)[:, None] * self.per + np.arange(self.per)) % self.pool).reshape(-1)
        ids = (np.concatenate([o[0] for o in self.out]) if n
               else np.zeros((0, self.k), np.int64))
        dists = (np.concatenate([o[1] for o in self.out]) if n
                 else np.zeros((0, self.k), np.float32))
        return {"qidx": qidx, "ids": engines.rows(self.cfg, self.engine, ids), "dists": dists,
                "attempted": n * self.per}
