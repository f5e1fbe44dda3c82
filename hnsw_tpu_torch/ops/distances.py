"""Distance metrics — counterpart of ``hnsw_tpu/ops/distances.py``.

Ported: the three inner-product metrics the main paths serve (L2, Dot,
Cosine), L1 (the dump format's integer-vector tests use it) and NoDist (the
metric of a graph-only reload: host side only, every distance 0): the
``Metric`` record, the numpy oracles (``np_batch``, ``brute_force``) and the
torch score forms

  * ``scores(q, C)``        : ``[B,d] x [B,K,d] -> [B,K]`` (gathered candidates)
  * ``matmul_scores(q, X)`` : ``[B,d] x [N,d] -> [B,N]`` (one matmul)

The other six metrics (Hamming, Jaccard, Hellinger, Jeffreys, JensenShannon,
Levenshtein) and ``UserMetric`` are still to be ported
(ROADMAP.md, queue A: "Other metrics and UserMetric"); ``get_metric`` names that
queue when asked for one of them.
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

    def pair(self, a, b) -> float:
        a = np.asarray(a)
        b = np.asarray(b)
        return float(self.np_batch(a, b[None, :])[0]) if b.ndim == 1 else float(self.np_batch(a, b))

    def brute_force(self, queries, X):
        """Exact [B,N] distance matrix on host (test oracle)."""
        q = np.asarray(queries)
        return self.np_batch(q if q.ndim == 2 else q[None, :], np.asarray(X))


DISTANCES = {
    "L1": Metric("L1", np_l1, scores_l1, matmul_scores_l1),
    "NoDist": Metric("NoDist", np_nodist),
    "L2": Metric("L2", np_l2, scores_l2, matmul_scores_l2),
    "Cosine": Metric("Cosine", np_cosine, scores_cosine, matmul_scores_cosine),
    "Dot": Metric("Dot", np_dot, scores_dot, matmul_scores_dot, needs_normalized=True),
}
for _n in list(DISTANCES):
    DISTANCES["Dist" + _n] = DISTANCES[_n]

# metrics of the JAX package that this port does not carry yet
_PENDING = ("Hamming", "Jaccard", "Hellinger", "Jeffreys", "JensenShannon",
            "Levenshtein")


def get_metric(dist) -> Metric:
    """Resolve a metric from a name (``"L2"``/``"DistL2"``) or a ``Metric``."""
    if isinstance(dist, Metric):
        return dist
    if isinstance(dist, str):
        m = DISTANCES.get(dist)
        if m is not None:
            return m
        base = dist[4:] if dist.startswith("Dist") else dist
        if base in _PENDING:
            raise NotImplementedError(
                f"distance {dist!r} is not ported to hnsw_tpu_torch yet; it is "
                "queued in ROADMAP.md (section A, 'Other metrics and UserMetric')")
    if callable(dist):
        raise NotImplementedError(
            "user metrics (UserMetric) are not ported to hnsw_tpu_torch yet; they "
            "are queued in ROADMAP.md (section A, 'Other metrics and UserMetric')")
    raise ValueError(f"unknown distance {dist!r}; known: {sorted(set(DISTANCES))}")


def l2_normalize(x):
    x = np.asarray(x, dtype=np.float32)
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, _EPS)
