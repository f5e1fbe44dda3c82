"""Distance metrics — counterpart of ``hnsw_tpu/ops/distances.py``.

The metric inventory of the reference's ``anndists`` crate: L1, L2, Cosine,
Dot (pre-normalized vectors), Hamming, Jaccard, Hellinger, Jeffreys,
JensenShannon, Levenshtein (u16 strings, zero-padded), user metrics
(``UserMetric``, the ``DistPtr`` analog) and NoDist (the metric of a
graph-only reload: host side only, every distance 0). Each ``Metric`` carries
the numpy oracle (``np_batch``, ``brute_force``; fp64) and the torch forms

  * ``scores(q, C)``        : ``[B,d] x [B,K,d] -> [B,K]`` (gathered candidates)
  * ``matmul_scores(q, X)`` : ``[B,d] x [N,d] -> [B,N]`` (one matmul; L1 and
    the inner-product metrics)

The score forms are plain PyTorch, as they are plain ``jnp`` programs in the
JAX package (no Pallas kernel computes them there). Levenshtein keeps the JAX
package's batched dynamic program: nonzero symbols compacted to the front, one
step per query symbol over ``[B, K, d+1]``, the insert chain as a running
minimum (by doubling: ``torch.cummin`` gives the same values 16x slower at
the build's shapes, on an H100 80GB HBM3 at 700 W: ``tools/metric_scores.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

_EPS = 1e-10


# --------------------------------------------------------------------------- numpy ---

def _np_f(x):
    return np.asarray(x, dtype=np.float64)


def np_l1(q, X):
    return np.abs(_np_f(q)[..., None, :] - _np_f(X)[None, ...]).sum(-1) if q.ndim == 2 else np.abs(_np_f(q) - _np_f(X)).sum(-1)


def np_nodist(q, X):
    q, X = np.asarray(q), np.asarray(X)
    return np.zeros(X.shape[:-1] if q.ndim == 1 else (q.shape[0], X.shape[0]))


def np_l2(q, X):
    d = _np_f(q)[..., None, :] - _np_f(X)[None, ...] if q.ndim == 2 else _np_f(q) - _np_f(X)
    return np.sqrt((d * d).sum(-1))


def np_dot(q, X):
    s = _np_f(q) @ _np_f(X).T if q.ndim == 2 else (_np_f(q) * _np_f(X)).sum(-1)
    return 1.0 - s


def np_cosine(q, X):
    qf, Xf = _np_f(q), _np_f(X)
    nq = np.linalg.norm(qf, axis=-1)
    nx = np.linalg.norm(Xf, axis=-1)
    if q.ndim == 2:
        s = qf @ Xf.T
        denom = nq[:, None] * nx[None, :]
    else:
        s = (qf * Xf).sum(-1)
        denom = nq * nx
    return 1.0 - np.where(denom > 0, s / np.maximum(denom, _EPS), 0.0)


def np_hamming(q, X):
    if q.ndim == 2:
        return (q[:, None, :] != X[None, :, :]).mean(-1).astype(np.float64)
    return (np.asarray(q) != np.asarray(X)).mean(-1).astype(np.float64)


def np_jaccard(q, X):
    qf, Xf = _np_f(q), _np_f(X)
    if q.ndim == 2:
        mn = np.minimum(qf[:, None, :], Xf[None, :, :]).sum(-1)
        mx = np.maximum(qf[:, None, :], Xf[None, :, :]).sum(-1)
    else:
        mn = np.minimum(qf, Xf).sum(-1)
        mx = np.maximum(qf, Xf).sum(-1)
    return 1.0 - np.where(mx > 0, mn / np.maximum(mx, _EPS), 0.0)


def np_hellinger(q, X):
    sq = np.sqrt(np.maximum(_np_f(q), 0.0))
    sx = np.sqrt(np.maximum(_np_f(X), 0.0))
    d = sq[..., None, :] - sx[None, ...] if q.ndim == 2 else sq - sx
    return np.sqrt(np.maximum(0.5 * (d * d).sum(-1), 0.0))


def np_jeffreys(q, X):
    qf = np.maximum(_np_f(q), _EPS)
    xf = np.maximum(_np_f(X), _EPS)
    if q.ndim == 2:
        diff = qf[:, None, :] - xf[None, :, :]
        lg = np.log(qf)[:, None, :] - np.log(xf)[None, :, :]
        return (diff * lg).sum(-1)
    return ((qf - xf) * (np.log(qf) - np.log(xf))).sum(-1)


def np_jensenshannon(q, X):
    qf = _np_f(q)
    xf = _np_f(X)
    if q.ndim == 2:
        qf = qf[:, None, :]
        xf = xf[None, :, :]
    m = 0.5 * (qf + xf)
    # xlogy-style: 0*log(0/m) = 0
    t1 = np.where(qf > 0, qf * (np.log(np.maximum(qf, _EPS)) - np.log(np.maximum(m, _EPS))), 0.0)
    t2 = np.where(xf > 0, xf * (np.log(np.maximum(xf, _EPS)) - np.log(np.maximum(m, _EPS))), 0.0)
    return np.sqrt(np.maximum(0.5 * (t1 + t2).sum(-1), 0.0))


def np_levenshtein_pair(a, b) -> float:
    """Edit distance on integer sequences (the reference uses u16 code points).
    Zero entries are padding and are stripped, so the metric works on
    right-padded fixed-width arrays."""
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    a = a[a != 0] if a.size and (a == 0).any() else a
    b = b[b != 0] if b.size and (b == 0).any() else b
    la, lb = len(a), len(b)
    if la == 0:
        return float(lb)
    if lb == 0:
        return float(la)
    prev = np.arange(lb + 1, dtype=np.int64)
    cur = np.empty(lb + 1, dtype=np.int64)
    for i in range(1, la + 1):
        cur[0] = i
        sub = prev[:-1] + (b != a[i - 1])
        # rolling row; the min over inserts is a sequential scan
        np.minimum(sub, prev[1:] + 1, out=cur[1:])
        for j in range(1, lb + 1):
            if cur[j - 1] + 1 < cur[j]:
                cur[j] = cur[j - 1] + 1
        prev, cur = cur, prev
    return float(prev[lb])


def np_levenshtein(q, X):
    if q.ndim == 2:
        return np.array([[np_levenshtein_pair(a, b) for b in X] for a in q], dtype=np.float64)
    return np.array([np_levenshtein_pair(q, b) for b in X] if X.ndim == 2 else np_levenshtein_pair(q, X))


# --------------------------------------------------------------------------- torch ---

def _f32(x):
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def scores_l1(q, C):
    return (_f32(q)[:, None, :] - _f32(C)).abs().sum(-1)


def scores_l2(q, C):
    d = _f32(q)[:, None, :] - _f32(C)
    return torch.sqrt(torch.clamp_min((d * d).sum(-1), 0.0))


def scores_dot(q, C):
    return 1.0 - torch.einsum("bd,bkd->bk", _f32(q), _f32(C))


def scores_cosine(q, C):
    qf, cf = _f32(q), _f32(C)
    s = torch.einsum("bd,bkd->bk", qf, cf)
    denom = torch.linalg.norm(qf, dim=-1)[:, None] * torch.linalg.norm(cf, dim=-1)
    return 1.0 - torch.where(denom > 0, s / torch.clamp_min(denom, _EPS), 0.0)


def scores_hamming(q, C):
    # times the f32 reciprocal, as XLA lowers the mean
    return (q[:, None, :] != C).sum(-1, dtype=torch.float32) * (1.0 / C.shape[-1])


def scores_jaccard(q, C):
    qf, cf = _f32(q)[:, None, :], _f32(C)
    mn = torch.minimum(qf, cf).sum(-1)
    mx = torch.maximum(qf, cf).sum(-1)
    return 1.0 - torch.where(mx > 0, mn / torch.clamp_min(mx, _EPS), 0.0)


def scores_hellinger(q, C):
    d = (torch.sqrt(torch.clamp_min(_f32(q), 0.0))[:, None, :]
         - torch.sqrt(torch.clamp_min(_f32(C), 0.0)))
    return torch.sqrt(torch.clamp_min(0.5 * (d * d).sum(-1), 0.0))


def scores_jeffreys(q, C):
    qf = torch.clamp_min(_f32(q), _EPS)[:, None, :]
    cf = torch.clamp_min(_f32(C), _EPS)
    return ((qf - cf) * (torch.log(qf) - torch.log(cf))).sum(-1)


def scores_jensenshannon(q, C):
    qf = _f32(q)[:, None, :]
    cf = _f32(C)
    lm = torch.log(torch.clamp_min(0.5 * (qf + cf), _EPS))
    t1 = torch.where(qf > 0, qf * (torch.log(torch.clamp_min(qf, _EPS)) - lm), 0.0)
    t2 = torch.where(cf > 0, cf * (torch.log(torch.clamp_min(cf, _EPS)) - lm), 0.0)
    return torch.sqrt(torch.clamp_min(0.5 * (t1 + t2).sum(-1), 0.0))


def _prefix_min(x):
    """Running minimum along the last axis by doubling: log2(n) minima of the
    row with itself shifted, the same exact values as ``torch.cummin``, whose
    CUDA scan takes 16x longer on rows this short (10.2 against 0.64 ms on
    [4096, 256, 13], H100 80GB HBM3 at 700 W, ``tools/metric_scores.py``)."""
    s = 1
    while s < x.shape[-1]:
        x = torch.cat([x[..., :s], torch.minimum(x[..., s:], x[..., :-s])], dim=-1)
        s *= 2
    return x


def _compact(x):
    """Nonzero entries first along the last axis, their order kept (stable)."""
    order = torch.sort((x == 0).to(torch.uint8), dim=-1, stable=True).indices
    return torch.gather(x, -1, order)


def scores_levenshtein(q, C):
    """Batched edit distance ``[B,d] x [B,K,d] -> [B,K]``, the form of
    ``np_levenshtein_pair`` for every pair at once (zero entries are padding).

    The row update ``cur[j] = min(t[j], cur[j-1] + 1)`` unrolls to
    ``cur[j] = j + min_{l<=j}(t[l] - l)``: a running minimum (``_prefix_min``),
    so each of the ``d`` steps is elementwise over ``[B, K, d+1]``. Nonzero
    symbols are compacted to the front; row ``la`` of each query is kept when
    the loop passes it and column ``lb`` of each candidate read with one
    gather. Values are integers <= 2d, exact in f32."""
    q = _f32(q)
    C = _f32(C)
    B, d = q.shape
    K = C.shape[1]
    A = _compact(q)
    Cv = _compact(C)
    la = (q != 0).sum(-1)  # [B]
    lb = (C != 0).sum(-1)  # [B,K]
    ar = torch.arange(d + 1, dtype=torch.float32, device=q.device)
    prev = ar.expand(B, K, d + 1)
    res = prev
    for i in range(1, d + 1):
        sub = prev[..., :-1] + (Cv != A[:, i - 1, None, None]).to(torch.float32)
        t = torch.minimum(sub, prev[..., 1:] + 1.0)
        t_full = torch.cat([torch.full((B, K, 1), float(i), device=q.device), t], dim=-1)
        cur = ar + _prefix_min(t_full - ar)  # j = 0 costs i
        res = torch.where((la == i)[:, None, None], cur, res)
        prev = cur
    return torch.gather(res, -1, lb[..., None])[..., 0]


def matmul_scores_l1(q, X, x_sqnorms=None):
    return (_f32(q)[:, None, :] - _f32(X)[None, :, :]).abs().sum(-1)


def matmul_scores_l2(q, X, x_sqnorms=None):
    qf, xf = _f32(q), _f32(X)
    if x_sqnorms is None:
        x_sqnorms = (xf * xf).sum(-1)
    sq = (qf * qf).sum(-1)
    g = qf @ xf.T
    return torch.sqrt(torch.clamp_min(sq[:, None] - 2.0 * g + x_sqnorms[None, :], 0.0))


def matmul_scores_dot(q, X, x_sqnorms=None):
    return 1.0 - _f32(q) @ _f32(X).T


def matmul_scores_cosine(q, X, x_sqnorms=None):
    qf, xf = _f32(q), _f32(X)
    nx = torch.sqrt(x_sqnorms) if x_sqnorms is not None else torch.linalg.norm(xf, dim=-1)
    nq = torch.linalg.norm(qf, dim=-1)
    denom = nq[:, None] * nx[None, :]
    return 1.0 - torch.where(denom > 0, (qf @ xf.T) / torch.clamp_min(denom, _EPS), 0.0)


# ------------------------------------------------------------------------- registry ---

@dataclasses.dataclass(frozen=True)
class Metric:
    """One distance metric, in all the forms the engine needs."""

    name: str
    np_batch: Callable  # (q[d] or [B,d], X[N,d]) -> [N] / [B,N] float64
    scores: Optional[Callable] = None  # (q[B,d], C[B,K,d]) -> [B,K] f32
    matmul_scores: Optional[Callable] = None  # (q[B,d], X[N,d], sqnorms?) -> [B,N]
    needs_normalized: bool = False  # Dot assumes pre-L2-normalized inputs
    pair_loop: bool = False  # np_batch loops over pairs in Python (Levenshtein, user)

    def pair(self, a, b) -> float:
        a = np.asarray(a)
        b = np.asarray(b)
        return float(self.np_batch(a, b[None, :])[0]) if b.ndim == 1 else float(self.np_batch(a, b))

    def pairs(self, A, B) -> np.ndarray:
        """Distances between rows ``A[i]`` and ``B[i]``, float64 ``[n]``. A
        vectorized oracle takes the diagonal of its ``[n, n]`` block; one that
        loops in Python is called on the ``n`` pairs alone (same values)."""
        if self.pair_loop:
            return np.array([self.pair(a, b) for a, b in zip(A, B)], dtype=np.float64)
        return np.diagonal(self.np_batch(A, B)).astype(np.float64)

    def brute_force(self, queries, X):
        """Exact [B,N] distance matrix on host (test oracle)."""
        q = np.asarray(queries)
        return self.np_batch(q if q.ndim == 2 else q[None, :], np.asarray(X))


# User metrics with a torch form, by name. Device code resolves a metric by
# name (``scores_gathered`` and the build take ``metric.name``), so a
# ``UserMetric`` that carries ``scores`` or ``matmul_scores`` registers here and
# ``get_metric`` falls back to this dict after the builtin table. One binding
# per name per process: rebinding a name to another function would make the
# same name score two ways, hence the conflict error below.
_USER_METRICS: dict = {}


class UserMetric(Metric):
    """A user-supplied distance — analog of the reference's ``DistPtr`` /
    ``DistCFFI`` (reference ``src/hnswio.rs:1483-1507``, ``src/libext.rs:643-655``):
    wraps a Python pair function ``fn(a, b) -> float``.

    Device tier: pass ``scores`` (torch, ``[B,d] x [B,K,d] -> [B,K]``) and the
    metric runs the batched build and search on the card; optionally also
    ``matmul_scores`` (``[B,d] x [N,d] (+ sqnorms) -> [B,N]``), which the exact
    engine and the pivot entry use. Without ``scores`` the index runs the
    serial host path (``mode="auto"``). Names must be unique per process when
    a torch form is attached."""

    def __init__(self, fn: Callable, name: str = "DistPtr",
                 scores: Optional[Callable] = None,
                 matmul_scores: Optional[Callable] = None):
        def batch(q, X):
            q = np.asarray(q)
            X = np.asarray(X)
            if q.ndim == 2:
                return np.array([[fn(a, b) for b in X] for a in q], dtype=np.float64)
            return np.array([fn(q, b) for b in X], dtype=np.float64)

        object.__setattr__(self, "name", name)
        object.__setattr__(self, "np_batch", batch)
        object.__setattr__(self, "scores", scores)
        object.__setattr__(self, "matmul_scores", matmul_scores)
        object.__setattr__(self, "needs_normalized", False)
        object.__setattr__(self, "pair_loop", True)
        object.__setattr__(self, "_fn", fn)
        if scores is not None or matmul_scores is not None:
            if name in DISTANCES:
                raise ValueError(f"user metric name {name!r} shadows a builtin")
            prev = _USER_METRICS.get(name)
            if prev is not None and (prev.scores, prev.matmul_scores,
                                     prev._fn) != (scores, matmul_scores, fn):
                raise ValueError(
                    f"user metric name {name!r} is already registered with a "
                    "different function; device code resolves metrics by name "
                    "— pick a unique name per metric")
            _USER_METRICS[name] = self


DISTANCES = {
    "L1": Metric("L1", np_l1, scores_l1, matmul_scores_l1),
    "L2": Metric("L2", np_l2, scores_l2, matmul_scores_l2),
    "Cosine": Metric("Cosine", np_cosine, scores_cosine, matmul_scores_cosine),
    "Dot": Metric("Dot", np_dot, scores_dot, matmul_scores_dot, needs_normalized=True),
    "Hamming": Metric("Hamming", np_hamming, scores_hamming),
    "Jaccard": Metric("Jaccard", np_jaccard, scores_jaccard),
    "Hellinger": Metric("Hellinger", np_hellinger, scores_hellinger),
    "Jeffreys": Metric("Jeffreys", np_jeffreys, scores_jeffreys),
    "JensenShannon": Metric("JensenShannon", np_jensenshannon, scores_jensenshannon),
    "Levenshtein": Metric("Levenshtein", np_levenshtein, scores_levenshtein, pair_loop=True),
    "NoDist": Metric("NoDist", np_nodist),
}
# aliases matching the reference's struct names (DistL2 etc.)
for _n in list(DISTANCES):
    DISTANCES["Dist" + _n] = DISTANCES[_n]


def get_metric(dist) -> Metric:
    """Resolve a metric from a name (``"L2"``/``"DistL2"``, or a registered
    ``UserMetric``'s), a ``Metric``, or a Python callable (a bare
    ``UserMetric``, serial path only)."""
    if isinstance(dist, Metric):
        return dist
    if callable(dist):
        return UserMetric(dist)
    try:
        return DISTANCES[dist]
    except KeyError:
        pass
    try:
        return _USER_METRICS[dist]
    except KeyError:
        raise ValueError(f"unknown distance {dist!r}; known: {sorted(set(DISTANCES))}") from None


def l2_normalize(x):
    x = np.asarray(x, dtype=np.float32)
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, _EPS)
