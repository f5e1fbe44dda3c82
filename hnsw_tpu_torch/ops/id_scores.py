"""Scores of each query against the rows its ids name: ``[B, d]`` queries,
``[N, d]`` vectors, ``[B, K]`` ids -> ``[B, K]`` distances, +INF where an id
is negative.

The JAX package (and the port before this module) gathers the rows into a
``[B, K, d]`` copy and scores the copy (``distances.scores_gathered``):
``id_scores_plain`` is that expression. On the card ``id_scores`` launches
``csrc/id_scores.cu`` instead, which reads each named row once from the table
and writes one float per id, so the copy never reaches device memory. It
replaces no TPU kernel; it is bound by the bytes of the valid ids' rows (see
the source).

The route follows the inputs alone (``id_scores_entry``): a CUDA table in
float32 (entry ``"f32"``) or bfloat16 (``"bf16"``) under a metric of the
inner product family (L2, Dot, Cosine) takes the kernel, at any d, any row
stride and any alignment (the kernel picks its loads from them); the CPU and
every other metric or dtype take the plain version. A call on a CUDA table
that takes the plain version bumps the ``PROFILER`` counter
``id_scores.plain``; the kernel's launches are ``kernel_lib.LAUNCHES
["id_scores"]``, by entry ``id_scores.f32`` / ``id_scores.bf16``.

The kernel's arithmetic is the plain version's in kind (f32 products and
sums; bf16 rows against the bf16-rounded query; |x|^2 from ``sqnorms`` for
L2, the row's own norm for Cosine) in another summation order, so the two
agree to rounding on the card; on the CPU the plain version runs and the
scores are bit for bit those of the expression it replaced.
"""

from __future__ import annotations

import torch

from ..utils.profiling import PROFILER
from . import kernel_lib
from .distances import COSINE_NAMES, DOT_NAMES, L2_NAMES, scores_gathered

INF = float("inf")
FORMS = {**dict.fromkeys(L2_NAMES, 0), **dict.fromkeys(DOT_NAMES, 1),
         **dict.fromkeys(COSINE_NAMES, 2)}
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the plain version's copy, [B, PLAIN_COPY // d, d] at a time
PLAIN_COPY = 1 << 21


def id_scores_entry(metric: str, dtype):
    """The kernel entry that scores a table of ``dtype`` rows under
    ``metric`` on the card (``"f32"`` or ``"bf16"``), or None where the plain
    version does."""
    if metric not in FORMS or dtype not in DTYPES:
        return None
    return DTYPES[dtype]


def id_scores_plain(metric: str, q, vectors, sqnorms, ids):
    """Plain PyTorch version: the rows gathered (ids clamped into the table)
    and scored by ``scores_gathered``, +INF where ``ids < 0``; the copy is
    made ``PLAIN_COPY // d`` columns of ids at a time."""
    safe = torch.clamp(ids, 0, vectors.shape[0] - 1).long()
    chunk = max(1, PLAIN_COPY // max(1, vectors.shape[-1]))
    sc = torch.cat([scores_gathered(metric, q, vectors[safe[:, s:s + chunk]],
                                    sqnorms[safe[:, s:s + chunk]])
                    for s in range(0, max(1, ids.shape[1]), chunk)], dim=1)
    return torch.where(ids >= 0, sc, INF)


def id_scores(metric: str, q, vectors, sqnorms, ids):
    """``[B, K]`` scores of ``q [B, d]`` against ``vectors[ids]`` (``ids`` any
    integer dtype; ``< 0`` scores +INF, ``>= N`` is clamped to row ``N - 1``).
    A CUDA table that ``id_scores_entry`` takes launches the kernel (its rows
    must have unit stride); every other input takes ``id_scores_plain``."""
    entry = None
    if vectors.device.type == "cuda":
        entry = id_scores_entry(metric, vectors.dtype)
        if entry is None:
            PROFILER.add("id_scores.plain")
    if entry is None:
        return id_scores_plain(metric, q, vectors, sqnorms, ids)
    B, K = ids.shape
    N, d = vectors.shape
    if vectors.stride(1) != 1:
        raise ValueError(f"id_scores reads rows of unit stride; got strides "
                         f"{tuple(vectors.stride())}")
    dev = vectors.device
    q = q.to(device=dev, dtype=torch.float32).contiguous()
    if q.data_ptr() % 16:
        q = q.clone()  # the kernel reads the query in 16-byte words
    if q.shape != (B, d):
        raise ValueError(f"query shape {tuple(q.shape)} != {(B, d)}")
    sqnorms = sqnorms.to(device=dev, dtype=torch.float32).contiguous()
    ids = ids.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    lib = kernel_lib.load("id_scores")
    # the library launches on the current card: the tensors' own, whatever
    # card the caller has current
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel_lib.launch(
            "id_scores", entry, lib.id_scores_launch,
            q.data_ptr(), vectors.data_ptr(), sqnorms.data_ptr(), ids.data_ptr(),
            B, K, N, d, vectors.stride(0), FORMS[metric],
            kernel_lib.ID_SCORES_ENTRIES.index(entry), out.data_ptr(), stream,
            card=dev.index)
    return out
