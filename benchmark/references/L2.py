"""Plain L2 reference: exact top-k by brute force, in blocks of queries.

First stage: float32 scores |x|^2 - 2 q.x with TF32 off keep ``POOL``
candidates a query. Second stage: those candidates' squared distances in
float64 in the direct form sum((x - q)^2), sorted; the k-th of them is the
true k-th distance. The pool is wide enough when its farthest candidate lies
beyond the k-th distance by more than the first stage's rounding, which
``truth`` checks for every query and raises otherwise.
"""

from __future__ import annotations

import torch

from . import exact_fp32, tf32

POOL = 64
# the first stage's rounding, over the terms |q|^2 + |x|^2: a few float32 ulps
F32_TERMS = 1e-5
SCORE_BYTES = 1 << 31   # one block's [queries, N] float32 scores


def _qblock(n: int) -> int:
    return max(1, min(4096, SCORE_BYTES // (4 * max(n, 1))))


def norms(X) -> torch.Tensor:
    """|x|^2 of every row in float64, in row blocks."""
    out = torch.empty(X.shape[0], dtype=torch.float64, device=X.device)
    for s in range(0, X.shape[0], 65536):
        x = X[s:s + 65536].double()
        out[s:s + 65536] = (x * x).sum(1)
    return out


def pair_d2(X, Q, qi, ids) -> torch.Tensor:
    """fp64 squared distance of query row ``qi[j]`` to corpus row
    ``ids[j]``, for every j (1-D index tensors on X's device)."""
    diff = X[ids].double() - Q[qi].double()
    return (diff * diff).sum(-1)


def gap(dist, d2, qsq, xsq) -> torch.Tensor:
    """How far a returned L2 distance lies from the fp64 one: |dist^2 - d2|
    over the terms |q|^2 + |x|^2 that the norm form sums (a float32 engine
    reads a few 1e-7 here, whatever form it takes)."""
    return (dist.double() ** 2 - d2).abs() / (qsq + xsq)


def truth(X, Q, k: int, pool: int = POOL):
    """(ids [nq, k] int64, d2 [nq, k] float64) of the exact top-k of every
    row of Q over X, ascending, on X's device."""
    n, nq = X.shape[0], Q.shape[0]
    pool = min(pool, n)
    xsq = (X * X).sum(1)
    xmax = float(norms(X).max())
    out_i = torch.empty(nq, k, dtype=torch.int64, device=X.device)
    out_d = torch.empty(nq, k, dtype=torch.float64, device=X.device)
    qb = _qblock(n)
    with exact_fp32():
        for s in range(0, nq, qb):
            q = Q[s:s + qb]
            sc = torch.addmm(xsq[None, :], q, X.T, alpha=-2.0)
            v, cand = torch.topk(sc, pool, dim=1, largest=False, sorted=True)
            del sc
            b = q.shape[0]
            rows = torch.arange(b, device=X.device).repeat_interleave(pool)
            d2 = pair_d2(X, q, rows, cand.reshape(-1)).reshape(b, pool)
            d2s, order = torch.sort(d2, dim=1, stable=True)
            out_d[s:s + b] = d2s[:, :k]
            out_i[s:s + b] = torch.gather(cand, 1, order[:, :k])
            if pool < n:
                qsq = (q.double() ** 2).sum(1)
                far = v[:, -1].double() + qsq
                short = far <= d2s[:, k - 1] + F32_TERMS * (qsq + xmax)
                if bool(short.any()):
                    raise RuntimeError(f"reference: a pool of {pool} does not certify the "
                                       f"top-{k} of {int(short.sum())} queries")
    return out_i, out_d


def control(X, Q, k: int):
    """The check's control: the top-k of the same first stage computed with
    TF32 on (the precision below float32), distances from the norm form:
    (ids [nq, k] int64, dists [nq, k] float32)."""
    n, nq = X.shape[0], Q.shape[0]
    xsq = (X * X).sum(1)
    out_i = torch.empty(nq, k, dtype=torch.int64, device=X.device)
    out_d = torch.empty(nq, k, dtype=torch.float32, device=X.device)
    qb = _qblock(n)
    with tf32():
        for s in range(0, nq, qb):
            q = Q[s:s + qb]
            sc = torch.addmm(xsq[None, :], q, X.T, alpha=-2.0)
            v, ids = torch.topk(sc, k, dim=1, largest=False, sorted=True)
            out_d[s:s + q.shape[0]] = torch.sqrt(torch.clamp_min(v + (q * q).sum(1, keepdim=True), 0.0))
            out_i[s:s + q.shape[0]] = ids
    return out_i, out_d
