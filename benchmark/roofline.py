"""Peaks of the card and the least time a kernel's work can take on it.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit (copied from
``chip_smoke.py``). A bound is the larger of bytes over the memory's rate and
operations over the peak for their type; each input byte counts once, each
output byte once, whatever the kernel reads again.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def bound_s(nbytes: float, flops: float, peak_flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


def b1_bound_s(B: int, E: int, M0: int, rid: int, d: int) -> float:
    """One launch of the fused codec scores (B1; B3 where ``rid`` is 0):
    ``B`` queries each score the ``M0`` int8 rows of ``d`` bytes of ``E``
    expanded nodes, with their ``M0`` int32 neighbour ids where the blocks
    carry id rows; f32 queries, norms and node ids in, f32 scores (and int32
    ids) out. Operations: the dot product and |c|^2, two FMAs an element, on
    the CUDA cores (``chip_smoke.py::codec_rows``)."""
    gathered = B * E * (M0 * d + (4 * M0 if rid else 0))
    nbytes = gathered + B * d * 4 + B * 4 + B * E * 4 + B * E * M0 * 4 * (2 if rid else 1)
    return bound_s(nbytes, 4 * B * E * M0 * d, F32_FLOPS)


def b2_bound_s(B: int, N: int, d: int, k: int) -> float:
    """One launch of the exact scan (B2) of ``B`` queries over ``N`` rows of
    ``d`` (N unpadded, from the problem's shape): 2 B N d operations at the
    bf16 peak, against the corpus read once in bf16, the queries, and k
    (row, distance) pairs a query out."""
    return bound_s(2 * N * d + 4 * B * d + 8 * B * k, 2 * B * N * d, BF16_FLOPS)
