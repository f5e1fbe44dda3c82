"""Judge every answer of a run against the plain reference.

An answer is one query's k (corpus row, distance) pairs as the program
returned them. Three numbers come out, each held to a limit:

* ``bad_rows``: answers with a missing or out-of-range id, an id twice, a
  distance that is not finite, or distances out of ascending order (limit 0);
* ``recall_at_10``: over all answers, the share of the true top-k that they
  hold; a returned row counts when it is in the reference's top-k or ties
  its k-th distance in fp64 (to 1e-6 relative), each row once;
* ``dist_gap``: the widest gap between a returned distance and the fp64
  distance of the row returned (``reference.gap``).

Rows the reference already ranked carry their fp64 distance from it; the
others are gathered and computed in fp64. Answers go to the device in blocks.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 16
TIE_RTOL = 1e-6


def judge(ref, X, Q, truth, qidx, ids, dists, block: int = BLOCK) -> dict:
    """``truth`` = (ids, d2) of ``ref.truth`` for the rows of ``Q``;
    ``qidx`` [A] the query row of each answer, ``ids`` [A, k] corpus rows (-1:
    none), ``dists`` [A, k] the distances returned (numpy)."""
    dev = X.device
    n = X.shape[0]
    t_ids, t_d2 = truth
    k = t_ids.shape[1]
    kth = t_d2[:, k - 1]
    xsq, qsq = ref.norms(X), ref.norms(Q)
    hits, bad, gap_max = 0, 0, 0.0
    for s in range(0, len(qidx), block):
        qi = torch.as_tensor(qidx[s:s + block], device=dev)
        I = torch.as_tensor(ids[s:s + block], device=dev).to(torch.int64)
        D = torch.as_tensor(dists[s:s + block], device=dev)
        valid = (I >= 0) & (I < n)
        Iv = torch.where(valid, I, 0)
        dup = torch.zeros_like(valid)
        for j in range(1, k):
            dup[:, j] = ((I[:, j:j + 1] == I[:, :j]) & valid[:, :j]).any(1)
        finite = torch.isfinite(D)
        ordered = (D[:, 1:] >= D[:, :-1]).all(1)
        bad += int((~valid.all(1) | dup.any(1) | ~finite.all(1) | ~ordered).sum())
        T, Td2 = t_ids[qi], t_d2[qi]
        eq = I[:, :, None] == T[:, None, :]
        member = eq.any(2)
        d2 = torch.where(eq, Td2[:, None, :], torch.zeros((), dtype=Td2.dtype,
                                                           device=dev)).sum(2)
        r, c = torch.nonzero(valid & ~member, as_tuple=True)
        if len(r):
            d2[r, c] = ref.pair_d2(X, Q, qi[r], I[r, c])
        hit = valid & ~dup & (member | (d2 <= kth[qi][:, None] * (1 + TIE_RTOL)))
        hits += int(hit.sum())
        ok = valid & finite
        if bool(ok.any()):
            g = ref.gap(D, d2, qsq[qi][:, None], xsq[Iv])
            gap_max = max(gap_max, float(g[ok].max()))
    answers = len(qidx)
    return {"answers": answers, "recall_at_10": hits / max(1, answers * k),
            "bad_rows": bad, "dist_gap": gap_max}


def compared(judged: dict, floor: float, limits: dict) -> dict:
    """Each number compared with its limit, in the order printed."""
    return {"bad_rows": {"value": judged["bad_rows"], "limit": 0, "pass": judged["bad_rows"] == 0},
            "recall_at_10": {"value": judged["recall_at_10"], "limit": floor,
                             "pass": judged["recall_at_10"] >= floor},
            "dist_gap": {"value": judged["dist_gap"], "limit": limits["dist_gap"],
                         "pass": judged["dist_gap"] <= limits["dist_gap"]}}

