"""The ``gauss`` recipe of ``hnsw_tpu_torch/bench.py::make_dataset``, drawn
with a ``torch.Generator`` on the device instead of NumPy's: ``intrinsic``
standard-normal dimensions through a fixed random map ``A`` (scaled by
1/sqrt(intrinsic)) plus ``noise`` times a standard-normal vector in the full
``d`` (the SIFT/GloVe regime of low intrinsic dimension)."""

from __future__ import annotations

import math

import torch

from ..references import exact_fp32


def make(g: torch.Generator, n: int, nq: int, d: int, device, intrinsic: int, noise: float):
    """(X [n, d], Q [nq, d]) float32 on ``device``."""
    with exact_fp32():
        A = torch.randn(intrinsic, d, generator=g, device=device) / math.sqrt(intrinsic)
        X = torch.randn(n, intrinsic, generator=g, device=device) @ A
        X.add_(torch.randn(n, d, generator=g, device=device), alpha=noise)
        Q = torch.randn(nq, intrinsic, generator=g, device=device) @ A
        Q.add_(torch.randn(nq, d, generator=g, device=device), alpha=noise)
    return X, Q
