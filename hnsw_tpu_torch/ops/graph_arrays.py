"""Device-resident dense graph snapshot and the int8 traversal codec.

Counterpart of ``hnsw_tpu/ops/graph_arrays.py``. ``GraphArrays`` and
``BeamCodec`` are dataclasses of tensors (the JAX package's pytrees):

  * ``vectors    : f32[cap1, dim]``   — row ``cap1-1`` is a reserved sink row
  * ``sqnorms    : f32[cap1]``
  * ``levels     : i32[cap1]``        — insertion level per point (-1 = none)
  * ``layer_ids  : tuple of i32[cap1, width_l]`` — per-layer ids, -1 padded
  * ``pivot_ids  : i32[P]`` or None   — entry pivots scanned by one matmul

``BeamCodec`` keeps the JAX layout the parity tests pin: int8 scale
``amax/127``, blocks ``[cap1, M0 + id_rows, d]`` whose trailing ``id_rows``
hold the node's int32 layer-0 ids as bytes (-1 padded, ``M0 + id_rows`` a
multiple of 8 as in the JAX codec), and ``blocks_sq``. The blocks are built
as the JAX codec builds them (``_gather_blocks``, ``graph_arrays.py:37-74``):
allocated once and filled in row chunks of about ``CODEC_CHUNK_BYTES``, since
a one-shot gather holds twice the final array at once (16.4 GB for 8.2 GB of
blocks at 1M rows, M0 = 56, 8 id rows). Dropped TPU habit: the padding of M0
to a multiple of 8 (Mosaic tiling). The codec's M0 is the layer table's
width; tables of width 2*M are already 8-aligned whenever M % 4 == 0, where
the two layouts agree byte for byte.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Bytes of one row chunk of the codec's block build (the JAX codec's ~512 MB).
CODEC_CHUNK_BYTES = 1 << 29


@dataclasses.dataclass
class BeamCodec:
    """Neighbourhood-blocked int8 traversal store for the beam layer: one
    block row per node holds its layer-0 neighbours' quantized vectors (and
    their ids), so an expanded node costs one contiguous read instead of M0
    scattered vector rows. Callers re-score the final beam exactly
    (``exact_rerank``)."""

    blocks: torch.Tensor  # [cap1, M0 + id_rows, d] int8 (or [cap1, M0, d] bf16)
    blocks_sq: torch.Tensor  # [cap1, M0] f32
    scale: torch.Tensor  # [] f32 dequantization multiplier
    M0: int = 0
    dim: int = 0
    metric_name: str = "L2"
    id_rows: int = 0

    SUPPORTED = ("L2", "DistL2", "Dot", "DistDot", "Cosine", "DistCosine")

    @classmethod
    def build(cls, g: "GraphArrays", kind: str = "i8", layer: int = 0,
              width: Optional[int] = None) -> "BeamCodec":
        """Build from a graph snapshot. ``width`` keeps the first ``width``
        table columns (rows are distance-sorted: the nearest links); callers
        traverse the identically sliced table (``search_program`` does)."""
        if g.metric_name not in cls.SUPPORTED:
            raise ValueError(f"codec unsupported for metric {g.metric_name}")
        return cls._build(g, kind, layer, width)

    @classmethod
    def _build(cls, g: "GraphArrays", kind: str, layer: int,
               width: Optional[int]) -> "BeamCodec":
        tbl = g.layer_ids[layer]
        if width is not None and width < tbl.shape[1]:
            tbl = tbl[:, :width]
        cap1, M0 = tbl.shape
        d = g.vectors.shape[1]
        v = g.vectors.to(torch.float32)
        if g.metric_name in ("Cosine", "DistCosine"):
            nrm = torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=True), 1e-20))
            v = v / nrm
        if kind == "bf16":
            vq = v.to(torch.bfloat16)
            scale = torch.tensor(1.0, dtype=torch.float32, device=v.device)
            vf = vq.to(torch.float32)
            qsq = (vf * vf).sum(-1)
        else:
            amax = torch.clamp_min(v.abs().max(), 1e-12)
            qscale = 127.0 / amax
            vq = torch.clamp(torch.round(v * qscale), -127, 127).to(torch.int8)
            scale = (amax / 127.0).to(torch.float32)
            qi = vq.to(torch.int32)
            qsq = (qi * qi).sum(-1).to(torch.float32) * (scale * scale)
        # id rows (int8 kind with d % 128 == 0, as the JAX codec lays them
        # out): the node's M0 table ids as int32 bytes, -1 padded to whole
        # [r_id, d] rows with M0 + r_id a multiple of 8
        r_id = 0
        if kind != "bf16" and d % 128 == 0:
            r_id = _round_up(M0 + max(1, -(-(M0 * 4) // d)), 8) - M0
        blocks = torch.empty((cap1, M0 + r_id, d), dtype=vq.dtype, device=v.device)
        blocks_sq = torch.empty((cap1, M0), dtype=torch.float32, device=v.device)
        chunk_rows = max(1, CODEC_CHUNK_BYTES // ((M0 + r_id) * d * vq.element_size()))
        for s in range(0, cap1, chunk_rows):
            e = min(s + chunk_rows, cap1)
            safe = torch.clamp(tbl[s:e], 0, cap1 - 1).long()
            blocks[s:e, :M0] = vq[safe]
            blocks_sq[s:e] = qsq[safe]
            if r_id:
                idp = torch.full((e - s, r_id * d // 4), -1, dtype=torch.int32,
                                 device=v.device)
                idp[:, :M0] = tbl[s:e]
                blocks[s:e, M0:] = idp.view(torch.int8).reshape(e - s, r_id, d)
        return cls(blocks=blocks, blocks_sq=blocks_sq, scale=scale,
                   M0=M0, dim=d, metric_name=g.metric_name, id_rows=r_id)

    @property
    def nbytes(self) -> int:
        return (self.blocks.numel() * self.blocks.element_size()
                + self.blocks_sq.numel() * 4)


# Pivot-start threshold: below it the greedy upper-layer descent is already
# cheap; above it one matmul over the pivot set gives a better entry.
PIVOT_MIN_POINTS = 32_768

_PIVOT_METRICS = ("L2", "DistL2", "Dot", "DistDot", "Cosine", "DistCosine")


def compute_pivots(hnsw, layer0_ids, n: int):
    """The entry-pivot set a search snapshot of ``hnsw`` will use, or None:
    the level>=1 points plus a component-aware fill (~n/64, capped at 16k).
    Shared with ``Hnsw.ensure_navigable`` so the repair's reachability
    guarantee covers exactly the seeds search starts from."""
    pivot_count = getattr(hnsw, "_pivot_count", None)
    has_matmul = (hnsw.metric.name in _PIVOT_METRICS
                  or hnsw.metric.matmul_scores is not None)  # L1, user metrics
    if pivot_count == 0 or n < PIVOT_MIN_POINTS or not has_matmul:
        return None
    from .components import select_pivots
    base = np.flatnonzero(hnsw._level[:n] >= 1)
    need = (min(16_384, max(len(base), n // 64)) if pivot_count is None
            else int(pivot_count))
    pv = select_pivots(hnsw._level, layer0_ids, n, need, device=hnsw.device)
    return pv if len(pv) >= 8 else None


@dataclasses.dataclass
class GraphArrays:
    """Snapshot of an index on its device (search path)."""

    vectors: torch.Tensor  # [cap1, dim] f32 (or bf16, set_device_dtype)
    sqnorms: torch.Tensor  # [cap1] f32
    levels: torch.Tensor  # [cap1] i32
    layer_ids: tuple  # tuple of [cap1, width_l] i32
    layer_dists: tuple  # tuple of [cap1, width_l] f32 (empty for search-only)
    entry: int = 0
    pivot_ids: Optional[torch.Tensor] = None  # [P] i32, or None
    n: int = 0
    cap1: int = 0
    entry_level: int = 0
    layer_nonempty: tuple = ()
    metric_name: str = "L2"
    version: int = -1

    @property
    def num_layers(self) -> int:
        return len(self.layer_ids)

    @classmethod
    def from_host(cls, hnsw, with_dists: bool = False,
                  device_dtype=torch.float32) -> "GraphArrays":
        """Snapshot a host index (``hnsw_tpu_torch.models.hnsw.Hnsw``) to
        tensors on ``hnsw.device``."""
        dev = hnsw.device
        n = hnsw._nb_point
        dim = hnsw._dim or 1
        cap1 = _round_up(max(n, 8), 8) + 1  # +1 sink row
        v = np.zeros((cap1, dim), np.float32)
        if n:
            v[:n] = np.asarray(hnsw._data[:n], np.float32)
        levels = np.full(cap1, -1, np.int32)
        levels[:n] = hnsw._level[:n]
        max_layer = max(hnsw._layers.keys(), default=0)
        lids, ldists = [], []
        for l in range(max_layer + 1):
            t = hnsw._layers.get(l)
            w = hnsw._layer_width(l)
            if t is not None:
                w = max(w, t.width)  # repaired graphs carry reserve columns
            ids = np.full((cap1, w), -1, np.int32)
            dd = np.full((cap1, w), np.inf, np.float32)
            if t is not None:
                ids[:n, : t.width] = t.ids[:n]
                dd[:n, : t.width] = t.dists[:n]
            lids.append(torch.as_tensor(ids, device=dev))
            ldists.append(torch.as_tensor(dd, device=dev))
        vf = torch.as_tensor(v, device=dev)
        vec = vf.to(device_dtype)
        vv = vec.to(torch.float32)
        nonempty = tuple(bool(hnsw.get_layer_nb_point(l) > 0) for l in range(max_layer + 1))
        pv = compute_pivots(hnsw, lids[0], n)
        pivots = torch.as_tensor(pv, dtype=torch.int32, device=dev) if pv is not None else None
        return cls(
            vectors=vec,
            sqnorms=(vv * vv).sum(-1),
            levels=torch.as_tensor(levels, device=dev),
            layer_ids=tuple(lids),
            layer_dists=tuple(ldists) if with_dists else (),
            entry=int(hnsw._entry if hnsw._entry >= 0 else 0),
            pivot_ids=pivots,
            n=n,
            cap1=cap1,
            entry_level=hnsw.get_max_level_observed(),
            layer_nonempty=nonempty,
            metric_name=hnsw.metric.name,
            version=hnsw._version,
        )
