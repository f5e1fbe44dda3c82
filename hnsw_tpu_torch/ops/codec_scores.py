"""Codec scores for the beam loop — kernels B1, B3 and B4.

Counterpart of ``hnsw_tpu/ops/pallas_scores.py``: ``codec_scores`` replaces
``pallas_fused_codec_scores_ids`` (B1, id-carrying blocks) and
``pallas_fused_codec_scores`` (B3, ``id_rows == 0``), which are one CUDA kernel
here (``csrc/codec_scores.cu``) with the id copy switched by ``RID > 0``;
``codec_scores_gathered`` replaces ``pallas_codec_scores`` (B4,
``csrc/codec_scores_gathered.cu``), the scores over blocks the caller has
already gathered.

Fused (B1/B3): for each query and each of its E expanded nodes the node's
int8 block ``[M0 + RID, d]`` is read from the ``[cap1, M0 + RID, d]`` codec
table, dequantized by ``scale`` and scored against the f32 query (L2 via the
norm trick with |c|^2 recomputed from the block, Dot as ``1 - ip``, Cosine as
``1 - ip / |q|`` over pre-normalized blocks). Id-carrying blocks also yield
the nodes' neighbour ids, decoded to int32.

Gathered (B4): the same three forms over ``blk [B, K*d]`` int8 rows, with the
rows' squared norms read from ``csq`` as given (the codec's ``blocks_sq``)
instead of recomputed, so B4 and B1 agree to rounding, not bit for bit.
``scores_codec(allow_fused=False)`` is its caller.

Bound on the H100, all three: bytes (B*E*M0 int8 rows of d bytes, and as many
int32 ids when the blocks carry them; B4 also reads csq). The three kernels
share one row product, ``csrc/codec_row.cuh`` (the query in registers, |c|^2 by
``__dp4a``, the three forms' epilogue). Each wrapper has two kernel entries,
chosen here from the shapes alone, never after a failed build or launch:

- ``codec_entry``: ``"bulk"`` (``d`` a multiple of 16 up to ``BULK_MAX_D`` whose
  gather ring fits in shared memory): persistent blocks, one bulk asynchronous
  copy per expanded node into a ring of stages; else ``"rows"``, one block per
  query reading its rows itself (any ``d``).
- ``gathered_entry``: ``"stream"`` (same ``d``): register query, a
  software-pipelined loop of 16-byte streaming loads; else ``"rows"``.

A base address that is not 16-byte aligned also takes ``"rows"``.
``kernel_lib.LAUNCHES["codec_scores_ids.bulk"]`` etc. count the launches of
each entry. See the kernel sources for the designs.
"""

from __future__ import annotations

import torch

from . import kernel_lib

FORMS = {"l2": 0, "dot": 1, "cosine": 2}

# The register-query row product holds at most two 16-byte words of a row per
# lane (``codec_row::MAX_NCH``): 32 lanes x 2 x 16 bytes.
BULK_MAX_D = 1024
SMEM_LIMIT = 232448     # bytes of shared memory a block may use on sm_90
_STAGE_ALIGN = 128      # the ring's stages start on 128-byte boundaries


def codec_stage_bytes(d: int, M0: int, rid: int) -> int:
    """Bytes one bulk copy moves for one expanded node: the ``M0`` vector rows
    and, for id-carrying blocks, the ``4 * M0`` id bytes behind them rounded
    up to the copy's 16-byte unit. The rounded copy stays inside the node's
    block, whose id rows hold ``rid * d >= 4 * M0`` bytes."""
    return M0 * d + (-(-4 * M0 // 16) * 16 if rid else 0)


def codec_entry(d: int, M0: int, rid: int) -> str:
    """Which kernel entry ``codec_scores`` takes on the card for this codec
    geometry: ``"bulk"`` when rows are whole 16-byte words (``d % 16 == 0``,
    ``d <= BULK_MAX_D``), the copy stays inside the block and a ring of two
    stages fits in shared memory, else ``"rows"``. A choice by shape: the
    entry it names either launches or raises."""
    if d <= 0 or d % 16 or d > BULK_MAX_D or M0 <= 0:
        return "rows"
    stage = codec_stage_bytes(d, M0, rid)
    stride = -(-stage // _STAGE_ALIGN) * _STAGE_ALIGN
    if stage > (M0 + rid) * d or 2 * (stride + 16) > SMEM_LIMIT:
        return "rows"
    return "bulk"


def gathered_entry(d: int) -> str:
    """Which kernel entry ``codec_scores_gathered`` takes on the card:
    ``"stream"`` when rows are whole 16-byte words (``d % 16 == 0``, ``d <=
    BULK_MAX_D``), else ``"rows"``."""
    return "stream" if d > 0 and d % 16 == 0 and d <= BULK_MAX_D else "rows"


def _aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def codec_scores_plain(src, q, qsn, scale, blocks, M0: int, form: str = "l2"):
    """Plain PyTorch version of the kernel, same contract.

    Args:
      src: [B, E] int32 expanded node ids (valid rows of ``blocks``).
      q: [B, d] f32 queries.
      qsn: [B, 1] f32 — |q|^2 for "l2", |q| for "cosine"; unused for "dot".
      scale: 0-d f32 tensor, the dequantization multiplier.
      blocks: [cap1, M0 + RID, d] int8 codec table.
      M0: vector rows per block; the trailing RID rows (if any) carry ids.

    Returns (scores [B, E*M0] f32, ids [B, E*M0] int32 or None when RID == 0).
    """
    B, E = src.shape
    RID = blocks.shape[1] - M0
    d = blocks.shape[2]
    g = blocks[src.long()]  # [B, E, M0+RID, d] int8
    blk = g[:, :, :M0].to(torch.float32)
    sc = scale.to(torch.float32)
    ip = (blk * q.to(torch.float32)[:, None, None, :]).sum(-1).reshape(B, E * M0) * sc
    if form == "l2":
        csq = (blk * blk).sum(-1).reshape(B, E * M0) * (sc * sc)
        out = torch.sqrt(torch.clamp_min(qsn - 2.0 * ip + csq, 0.0))
    elif form == "dot":
        out = 1.0 - ip
    else:
        out = 1.0 - ip / torch.clamp_min(qsn, 1e-20)
    if RID == 0:
        return out, None
    idb = g[:, :, M0:].reshape(B, E, RID * d).contiguous()
    ids = idb.view(torch.int32)[:, :, :M0].reshape(B, E * M0)
    return out, ids


def codec_scores(src, q, qsn, scale, blocks, M0: int, form: str = "l2", *,
                 entry: str | None = None):
    """Scores (and, for id-carrying blocks, neighbour ids) of the expanded
    nodes' neighbourhoods. CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise). ``entry`` names the kernel entry instead of
    ``codec_entry`` (kernel comparisons); one that does not take the shape
    raises."""
    if blocks.device.type != "cuda":
        return codec_scores_plain(src, q, qsn, scale, blocks, M0, form)
    B, E = src.shape
    cap1, rows, d = blocks.shape
    RID = rows - M0
    if blocks.dtype != torch.int8 or not blocks.is_contiguous():
        raise ValueError("codec_scores kernel takes a contiguous int8 block table")
    if RID < 0 or (RID > 0 and RID * d < 4 * M0) or (RID > 0 and d % 4):
        raise ValueError(f"bad codec geometry M0={M0} rows={rows} d={d}")
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}")
    dev = blocks.device
    src = src.to(device=dev, dtype=torch.int32).contiguous()
    q = q.to(device=dev, dtype=torch.float32).contiguous()
    qsn = qsn.to(device=dev, dtype=torch.float32).reshape(B).contiguous()
    scale = scale.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    if q.shape != (B, d):
        raise ValueError(f"query shape {tuple(q.shape)} != {(B, d)}")
    out = torch.empty((B, E * M0), dtype=torch.float32, device=dev)
    ids = (torch.empty((B, E * M0), dtype=torch.int32, device=dev)
           if RID > 0 else None)
    if entry is None:
        entry = codec_entry(d, M0, RID) if _aligned16(q, blocks) else "rows"
    lib = kernel_lib.load("codec_scores")
    # the library launches on the current card: the tensors' own, whatever
    # card the caller has current
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel_lib.launch(
            "codec_scores_ids" if RID > 0 else "codec_scores", entry,
            lib.codec_scores_launch,
            src.data_ptr(), q.data_ptr(), qsn.data_ptr(), scale.data_ptr(),
            blocks.data_ptr(), B, E, M0, RID, d, FORMS[form],
            kernel_lib.CODEC_ENTRIES.index(entry), out.data_ptr(),
            ids.data_ptr() if ids is not None else None, stream, card=dev.index)
    return out, ids


def codec_scores_gathered_plain(q, blk, csq, qsn, scale, form: str = "l2"):
    """Plain PyTorch version of the gathered-blocks kernel, same contract.

    Args:
      q: [B, d] f32 queries.
      blk: [B, K*d] int8 — the gathered neighbourhood rows, flattened.
      csq: [B, K] f32 — the rows' quantized squared norms (read for "l2" only).
      qsn: [B, 1] f32 — |q|^2 for "l2", |q| for "cosine"; unused for "dot".
      scale: 0-d f32 tensor, the dequantization multiplier.

    Returns scores [B, K] f32.
    """
    B, d = q.shape
    K = csq.shape[1]
    b = blk.reshape(B, K, d).to(torch.float32)
    ip = (b * q.to(torch.float32)[:, None, :]).sum(-1) * scale.to(torch.float32)
    if form == "l2":
        return torch.sqrt(torch.clamp_min(qsn - 2.0 * ip + csq, 0.0))
    if form == "dot":
        return 1.0 - ip
    return 1.0 - ip / torch.clamp_min(qsn, 1e-20)


def codec_scores_gathered(q, blk, csq, qsn, scale, form: str = "l2", *,
                          entry: str | None = None):
    """Scores [B, K] of pre-gathered int8 codec rows (any B, K, d). CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise). ``entry`` names the kernel entry instead of ``gathered_entry``
    (kernel comparisons); one that does not take the shape raises."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}")
    if blk.device.type != "cuda":
        return codec_scores_gathered_plain(q, blk, csq, qsn, scale, form)
    B, d = q.shape
    K = csq.shape[1]
    if blk.dtype != torch.int8 or blk.numel() != B * K * d:
        raise ValueError(f"codec_scores_gathered takes int8 rows [B, K*d]; got "
                         f"{blk.dtype} {tuple(blk.shape)} for B={B} K={K} d={d}")
    dev = blk.device
    blk = blk.contiguous()
    q = q.to(device=dev, dtype=torch.float32).contiguous()
    csq = csq.to(device=dev, dtype=torch.float32).contiguous()
    qsn = qsn.to(device=dev, dtype=torch.float32).reshape(B).contiguous()
    scale = scale.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    if entry is None:
        entry = gathered_entry(d) if _aligned16(q, blk) else "rows"
    lib = kernel_lib.load("codec_scores_gathered")
    # the library launches on the current card: the tensors' own, whatever
    # card the caller has current
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel_lib.launch(
            "codec_scores_gathered", entry, lib.codec_scores_gathered_launch,
            q.data_ptr(), blk.data_ptr(), csq.data_ptr(), qsn.data_ptr(),
            scale.data_ptr(), B, K, d, FORMS[form],
            kernel_lib.GATHERED_ENTRIES.index(entry), out.data_ptr(), stream, card=dev.index)
    return out
