"""Exact L2 top-k scan — kernels B2 and B5 and their host parts.

Counterpart of ``hnsw_tpu/ops/pallas_topk.py``: ``scan_packed`` replaces the
packed Pallas tile kernel (``_tile_kernel_packed``, reached through
``pallas_l2_topk(packed=True)``), ``scan_unpacked`` the unpacked one
(``_tile_kernel``, ``packed=False``), ``l2_topk`` replaces ``pallas_l2_topk``
(the decode, overfetch and f32 refine around either kernel), ``pad_corpus``
is the same permuted padding, and ``l2_topk_stream`` replaces
``pallas_l2_topk_stream`` (replaying ``l2_topk`` as a captured program,
``ops/program.py::ScanProgram``, as the reference runs it jitted).

The scan keeps, per (span of ``acc`` tiles, query, lane group), the two
smallest packed distances: the candidate's local row offset rides in the low
LB mantissa bits of the f32 distance, so int32 order is distance order and
the identity travels with the value. The decode contract is the JAX
package's, so the plain version takes the JAX parameters ``(tn, group, acc)``
and agrees with ``pallas_l2_topk``. The unpacked scan (``packed=False``, for
callers that cannot give mantissa bits to the index) keeps the same cells but
full f32 values of ``|x|^2 - 2 q.x`` and the global row ids as a second
output; ``|q|^2`` joins after the top-k.

Card geometry (re-derived for the H100; the TPU's ``pick_tn`` VMEM sizing is
gone): the CUDA kernels fix G = 128 lane groups per tile (``tn = 128 *
group``) and about ``SCAN_SPANS`` spans per corpus, so the candidate buffer
stays at ``spans * 2 * 128`` words per query. Bound on the H100: operations
(see ``csrc/scan_topk.cu``).

Each kernel has three entries; the wrapper names one from dtype and ``d``
alone (``scan_entry``), never after a failed build or launch. ``"wgmma"``,
the tensor-core tile product of ``csrc/scan_tile.cuh``, takes bf16 queries
and corpus at any ``d`` up to ``WGMMA_MAX_D``; its grid is ``B/128 x spans``
blocks (224 at B = 2048 over the 200k corpus). ``"tf32x3"`` takes f32 queries
and corpus (the full-precision scan, ``l2_topk(Xscan=None)``) at the same
depths: the same tile product in its K-looped layout, each 32-column box of
f32 rows split in shared memory into tf32 parts ``x = hi + lo``
(``tf32_split``) and ``q.x`` summed from three tf32 products ``qh xh + qh xl
+ ql xh`` (``tf32x3_dots``). TF32 alone would keep 10 mantissa bits; the
three products keep about 22, within a few f32 roundings of an f32 product,
at three passes of the TF32 rate (495 TFLOP/s) against one pass of the f32
FMA rate (67). ``"simt"``, the first register-tiled f32-FMA kernel, is named by
no wrapper any more: it asks for shared memory that grows with ``d`` and
cannot launch past d = 842 packed, 715 unpacked (``scan_smem``);
``chip_smoke.py`` times it as the others' "was". ``kernel_lib.LAUNCHES
["scan_topk.wgmma"]`` etc. count the launches of each entry.

The tensor-core entry runs one of two layouts of the same product, also
chosen from ``d`` alone (``scan_layout``): for bf16 the query tile resident
in shared memory up to ``RESIDENT_MAX_D``, the depth walked in 128-byte boxes
above; f32 is always K-looped. Its step (``scan_depth``) is 16 columns for
bf16 (one wgmma step: the bf16 copies carry zero columns up to it, which
change no ``q.x``, while ``|x|^2`` comes from the f32 rows; ``l2_topk`` pads
the queries to the copy's width) and 4 for f32: the f32 rows need only the
tensor map's 16-byte row stride, a last wgmma step past ``d`` reading the
map's zero fill, so the f32 scan runs on the f32 corpus itself with no copy
at every d % 4 == 0 (a copy at any other d would be the whole corpus again;
``scan_copy`` makes one only there).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernel_lib
from ..utils.profiling import PROFILER

SCAN_TN = 2048
SCAN_GROUP = 16   # G = SCAN_TN // SCAN_GROUP = 128 lanes (the kernel's width)
SCAN_SPANS = 16   # spans per corpus: output blocks of the packed keep-2 buffer

_INT_MAX = 0x7FFFFFFF


def scan_acc(n_rows: int, tn: int = SCAN_TN, spans: int = SCAN_SPANS) -> int:
    """Tiles per span so that a padded corpus of ``n_rows`` splits into about
    ``spans`` spans."""
    n_tiles = max(1, n_rows // tn)
    return max(1, -(-n_tiles // spans))


def _geometry(N: int, tn: int, group: int, acc: int):
    if N % tn:
        raise ValueError("pad X to a multiple of tn (pad_corpus)")
    G = tn // group
    n_tiles = N // tn
    acc = max(1, min(int(acc), n_tiles))
    n_blocks = -(-n_tiles // acc)
    LB = max(1, (group * acc - 1).bit_length())
    return G, n_tiles, acc, n_blocks, LB


# Largest (padded) d of the resident layout, by ``packed``: the query tile,
# two stages of the ring and the epilogue's own bytes must fit in 227 KB of
# shared memory (``scan_tile::pick_stages``; the unpacked epilogue keeps 64 KB
# of id words). Above it the K-looped layout, whose ring holds 128-byte boxes
# whatever d is.
RESIDENT_MAX_D = {True: 256, False: 192}
# Largest d the scan takes on the card, bf16 or f32. The K-looped layout has
# no shared-memory limit on d, but every block reads its [128 x d] query tile
# again from L2 for each 128-row sub-tile: 1 MB a block at d = 4096 in bf16
# (2 MB in f32), 16 MB for a 2048-query batch's 16 tiles, a third of the
# card's 50 MB L2 beside the streaming corpus. Whether that is a real limit
# is not measured. Checked on the card up to d = 1536 (``chip_smoke.py``'s
# kernels phase). Above it no entry launches (the JAX package answers there).
WGMMA_MAX_D = 4096
# the launch functions' ``layout`` argument is the index into these
SCAN_LAYOUTS = ("resident", "kloop")
# columns of the scan's step, by dtype: a wgmma step (bf16), the tensor map's
# 16-byte row stride (f32)
SCAN_STEP = {torch.bfloat16: 16, torch.float32: 4}
# the CUDA entry of each scan dtype (``scan_entry``)
SCAN_DTYPE_ENTRY = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}
# bytes of shared memory a block may use on sm_90 (``scan_tile::SMEM_LIMIT``)
SMEM_LIMIT = 232448


def scan_depth(d: int, dtype=torch.bfloat16) -> int:
    """Columns of a scan copy of ``d``-column rows: ``d`` rounded up to the
    scan's step for ``dtype`` (``SCAN_STEP``)."""
    step = SCAN_STEP[dtype]
    return -(-int(d) // step) * step


def scan_copy(X, dtype=torch.bfloat16):
    """The scan-precision copy of rows ``X`` [n, d] (corpus or queries) in
    ``dtype``, bf16 or f32, with zero columns up to ``scan_depth(d, dtype)``;
    any other dtype as it is. An f32 ``X`` whose ``d`` is already a step is
    returned itself (no copy)."""
    d = X.shape[1]
    if dtype not in SCAN_STEP or d == scan_depth(d, dtype):
        return X.to(dtype)
    out = torch.zeros((X.shape[0], scan_depth(d, dtype)), dtype=dtype, device=X.device)
    out[:, :d] = X
    return out


def scan_entry(dtype, d: int, packed: bool = True) -> str:
    """Which kernel entry a CUDA scan of this dtype and depth takes:
    ``"wgmma"`` for bf16, ``"tf32x3"`` for f32, each at every ``d`` up to
    ``WGMMA_MAX_D`` (the copies padded to ``scan_depth(d, dtype)``). A choice
    by shape: the entry it names either launches or raises; past
    ``WGMMA_MAX_D`` it raises here, for both dtypes."""
    if dtype not in SCAN_DTYPE_ENTRY:
        raise ValueError(f"the CUDA scan takes bf16 or f32; got {dtype}")
    if not 0 < scan_depth(d, dtype) <= WGMMA_MAX_D:
        raise ValueError(f"the CUDA scan takes 0 < d <= {WGMMA_MAX_D} (WGMMA_MAX_D) in bf16 "
                         f"and in f32; got d={d}: no entry launches past it")
    return SCAN_DTYPE_ENTRY[dtype]


def scan_layout(d: int, packed: bool = True, dtype=torch.bfloat16) -> str:
    """The tensor-core entry's layout for a scan of depth ``d``: for bf16
    ``"resident"`` (query tile in shared memory, the two warpgroups in turns)
    up to ``RESIDENT_MAX_D[packed]``, ``"kloop"`` (128-byte boxes) above; f32
    (``tf32x3``) always ``"kloop"``."""
    if dtype == torch.float32:
        return "kloop"
    return "resident" if scan_depth(d) <= RESIDENT_MAX_D[bool(packed)] else "kloop"


def scan_smem(entry: str, d: int, packed: bool = True, layout: str | None = None):
    """``(bytes, stages)``: the dynamic shared memory a launch of ``entry``
    (in ``layout``, by default ``scan_layout``'s) at depth ``d`` asks for and
    its ring's stages, as the launch functions compute them
    (``scan_tile::pick_stages`` / ``pick_kloop_stages``; ``simt``, no ring:
    the queries [d][64] and a [32][129] staging tile in f32, plus |q|^2
    (packed) or B5's id words [32][256]). A launch refuses more than
    ``SMEM_LIMIT`` bytes, or fewer than two stages (then the bytes are those
    two would need)."""
    if entry == "simt":
        return (d * 64 + 32 * 129 + (64 if packed else 32 * 256)) * 4, 0
    f32 = entry == "tf32x3"
    layout = layout or scan_layout(d, packed, torch.float32 if f32 else torch.bfloat16)
    box = 128 * 128  # one TMA box: 128 rows x 128 bytes
    if layout == "resident":  # the query tile, then stages of [tile, 128 |x|^2]
        tile = -(-d // 64) * box
        fixed = 1024 + tile + (0 if packed else 64 * 256 * 4) + 8 * 9
        step, stages = tile + 512, 4
    else:  # stages of [query box, corpus box]; f32's lo area; the epilogue's bytes
        fixed = 1024 + (2 * box if f32 else 0) + (1 if packed else 2) * 64 * 256 * 4 + 8 * 16
        step, stages = 2 * box, 8
    while stages >= 2 and fixed + stages * step > SMEM_LIMIT:
        stages -= 1
    return fixed + max(stages, 2) * step, stages


def _check_card_geometry(G: int, tn: int, group: int, qs, Xs, packed: bool):
    """Raises on what the CUDA scan does not take; returns the entry and the
    index of its layout (the launch functions' ``entry`` and ``layout``)."""
    if G != 128:
        raise ValueError(f"the CUDA scan runs 128 lane groups (tn = 128 * group); "
                         f"got tn={tn} group={group}")
    if Xs.dtype not in (torch.bfloat16, torch.float32) or qs.dtype != Xs.dtype:
        raise ValueError("the CUDA scan takes bf16 or f32 queries and corpus "
                         "of one type")
    d = qs.shape[1]
    if Xs.shape[1] != d:
        raise ValueError(f"queries of {d} columns against a corpus of {Xs.shape[1]}")
    entry = scan_entry(Xs.dtype, d, packed)
    if d != scan_depth(d, Xs.dtype):
        raise ValueError(f"the {entry} scan steps {SCAN_STEP[Xs.dtype]} columns: pad the "
                         f"copies to scan_depth(d) = {scan_depth(d, Xs.dtype)} columns "
                         f"(scan_copy); got d={d}")
    return entry, SCAN_LAYOUTS.index(scan_layout(d, packed, Xs.dtype))


# Columns of one TMA box of the bf16 tensor-core kernels: the K-looped layout
# sums each box's product in f32 (``csrc/scan_tile.cuh``), and the plain
# versions sum q.x the same way.
SCAN_BOX = 64
# Columns of one TMA box of the ``tf32x3`` entry (128 bytes of f32)
TF32_BOX = 32


def box_dots(qs, Xs):
    """q.x of every query and row, [B, N] f32, as the K-looped kernels sum it:
    f32 sums of the products over each 64-column box, the boxes' sums added in
    f32 (the resident layout and the f32-FMA entry chain one sum; up to d =
    256 the two orders stay within the scans' tolerances). One f32 sum over
    hundreds of columns drifts further from the exact value than the kernels'
    box sums do (``tools/scan_accuracy.py``). For f32 inputs this is the full
    f32 product the ``tf32x3`` entry is held to (on the card with
    ``torch.backends.cuda.matmul.allow_tf32`` False, its default)."""
    qf, xf = qs.to(torch.float32), Xs.to(torch.float32)
    g = qf[:, :SCAN_BOX] @ xf[:, :SCAN_BOX].T
    for c in range(SCAN_BOX, qs.shape[1], SCAN_BOX):
        g += qf[:, c:c + SCAN_BOX] @ xf[:, c:c + SCAN_BOX].T
    return g


def tf32_split(x):
    """``(hi, lo)`` of f32 ``x`` as the ``tf32x3`` entry splits each box in
    shared memory: ``hi`` is ``x`` truncated to tf32 (the box as loaded: the
    tensor cores ignore an f32 word's low 13 bits), and ``lo`` is the rest
    ``x - hi``, exact in f32, rounded to tf32 as ``cvt.rna.tf32.f32`` does (to
    nearest, ties away from zero: the magnitude sits in the low 31 bits, so
    adding half a tf32 ulp and clearing the low 13 bits does it for either
    sign). Both hold tf32's bits; ``hi + lo`` is within half a tf32 ulp of the
    rest, 2^-22 of ``x``."""
    x = x.to(torch.float32).contiguous()
    hi = (x.view(torch.int32) & ~0x1FFF).view(torch.float32)
    rest = (x - hi).view(torch.int32)
    return hi, ((rest + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32x3_dots(qs, Xs):
    """A CPU model of the ``tf32x3`` entry's q.x, [B, N] f32: per 32-column
    box, ``ql xh + qh xl + qh xh`` of the tf32 parts (``tf32_split``; each
    product of two tf32 values is exact in f32), the box sums added in f32.
    The kernel sums each box in the tensor core's own order; the tests hold
    this model to an fp64 evaluation."""
    qh, ql = tf32_split(qs)
    xh, xl = tf32_split(Xs)
    g = None
    for c in range(0, qs.shape[1], TF32_BOX):
        s = slice(c, c + TF32_BOX)
        box = ql[:, s] @ xh[:, s].T + qh[:, s] @ xl[:, s].T + qh[:, s] @ xh[:, s].T
        g = box if g is None else g + box
    return g


def scan_packed_plain(qs, Xs, xsq, tn: int, group: int, acc: int):
    """Plain PyTorch version of the scan kernel: packed int32
    ``[n_blocks, B, 2G]`` (per lane group: smallest, then second smallest).

    ``qs``/``Xs`` are the scan-precision query and corpus (bf16 or f32); the
    inner products are f32 products of those values summed per 64-column box
    (``box_dots``)."""
    B, d = qs.shape
    N = Xs.shape[0]
    G, n_tiles, acc, n_blocks, LB = _geometry(N, tn, group, acc)
    qf = qs.to(torch.float32)
    qsq = (qf * qf).sum(1, keepdim=True)
    g = box_dots(qs, Xs)  # [B, N]
    d2 = torch.clamp_min(xsq.to(torch.float32)[None, :] + qsq - 2.0 * g, 0.0)
    ai = d2.contiguous().view(torch.int32).reshape(B, n_tiles, group, G)
    t = torch.arange(n_tiles, device=qs.device) % acc
    s = torch.arange(group, device=qs.device)
    loc = (t[:, None] * group + s[None, :]).to(torch.int32)[None, :, :, None]
    ai = (ai & ~((1 << LB) - 1)) | loc
    pad = n_blocks * acc - n_tiles
    if pad:
        ai = torch.cat([ai, torch.full((B, pad, group, G), _INT_MAX,
                                       dtype=torch.int32, device=qs.device)], 1)
    ai = ai.reshape(B, n_blocks, acc * group, G)
    m1 = ai.min(2).values
    m2 = torch.where(ai == m1[:, :, None, :], _INT_MAX, ai).min(2).values
    return torch.cat([m1, m2], -1).permute(1, 0, 2).contiguous()


def scan_packed(qs, Xs, xsq, tn: int, group: int, acc: int):
    """The scan kernel: CPU tensors take the plain version, CUDA tensors
    launch the kernel (or raise). Same contract as ``scan_packed_plain``."""
    if Xs.device.type != "cuda":
        return scan_packed_plain(qs, Xs, xsq, tn, group, acc)
    B, d = qs.shape
    N = Xs.shape[0]
    G, n_tiles, acc, n_blocks, LB = _geometry(N, tn, group, acc)
    entry, layout = _check_card_geometry(G, tn, group, qs, Xs, packed=True)
    dev = Xs.device
    qs = qs.to(dev).contiguous()
    Xs = Xs.contiguous()
    xsq = xsq.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((n_blocks, B, 2 * G), dtype=torch.int32, device=dev)
    lib = kernel_lib.load("scan_topk")
    # the library launches on the current card: the tensors' own, whatever
    # card the caller has current
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel_lib.launch("scan_topk", entry, lib.scan_topk_launch, qs.data_ptr(),
                          Xs.data_ptr(), xsq.data_ptr(), B, N, d, tn, group, acc, LB,
                          int(Xs.dtype == torch.bfloat16),
                          kernel_lib.SCAN_ENTRIES.index(entry), layout, out.data_ptr(),
                          stream, card=dev.index)
    return out


def scan_unpacked_plain(qs, Xs, xsq, tn: int, group: int, acc: int):
    """Plain PyTorch version of the unpacked scan kernel: ``(outd f32, outi
    int32)``, each ``[n_blocks, B, 2G]`` (per lane group: smallest, then second
    smallest of ``|x|^2 - 2 q.x`` — no ``|q|^2``, no clamp — and their global
    row ids).

    Ties follow the Pallas kernel exactly: inside a tile the lowest group
    position wins either place; across the tiles of a span the earlier tile
    keeps first place, and second place goes to the loser of the first-place
    round over an equal second of the winner's side."""
    B, d = qs.shape
    N = Xs.shape[0]
    G, n_tiles, acc, n_blocks, _ = _geometry(N, tn, group, acc)
    dev = qs.device
    g = box_dots(qs, Xs)  # [B, N]
    a = (xsq.to(torch.float32)[None, :] - 2.0 * g).reshape(B, n_tiles, group, G)
    idx = torch.arange(group, device=dev, dtype=torch.int32)[None, None, :, None]
    m1 = a.min(2).values
    am1 = torch.where(a == m1[:, :, None, :], idx, group).min(2).values
    masked = torch.where(idx == am1[:, :, None, :], torch.inf, a)
    m2 = masked.min(2).values
    am2 = torch.where(masked == m2[:, :, None, :], idx, group).min(2).values
    am2 = torch.clamp_max(am2, group - 1)  # all-inf group
    col = torch.arange(G, device=dev, dtype=torch.int32)[None, None, :]
    base = (torch.arange(n_tiles, device=dev, dtype=torch.int32) * tn)[None, :, None]
    i1 = base + am1 * G + col
    i2 = base + am2 * G + col
    pad = n_blocks * acc - n_tiles
    if pad:  # ragged last span: tiles that do not exist are never merged
        m1, m2 = (torch.cat([x, x.new_full((B, pad, G), torch.inf)], 1) for x in (m1, m2))
        i1, i2 = (torch.cat([x, x.new_zeros((B, pad, G))], 1) for x in (i1, i2))
    m1, m2, i1, i2 = (x.reshape(B, n_blocks, acc, G) for x in (m1, m2, i1, i2))
    a1, a2, ia1, ia2 = m1[:, :, 0], m2[:, :, 0], i1[:, :, 0], i2[:, :, 0]
    blk0 = torch.arange(n_blocks, device=dev) * acc
    for t in range(1, acc):
        b1, b2, ib1, ib2 = m1[:, :, t], m2[:, :, t], i1[:, :, t], i2[:, :, t]
        live = ((blk0 + t) < n_tiles)[None, :, None]
        swap = b1 < a1
        hi = torch.where(swap, a1, b1)      # the loser of the first-place round
        lo2 = torch.where(swap, b2, a2)     # the winner side's second
        n2 = torch.minimum(hi, lo2)
        in2 = torch.where(hi <= lo2, torch.where(swap, ia1, ib1),
                          torch.where(swap, ib2, ia2))
        n1 = torch.where(swap, b1, a1)
        in1 = torch.where(swap, ib1, ia1)
        a1, ia1 = torch.where(live, n1, a1), torch.where(live, in1, ia1)
        a2, ia2 = torch.where(live, n2, a2), torch.where(live, in2, ia2)
    outd = torch.cat([a1, a2], -1).permute(1, 0, 2).contiguous()
    outi = torch.cat([ia1, ia2], -1).permute(1, 0, 2).contiguous()
    return outd, outi


def scan_unpacked(qs, Xs, xsq, tn: int, group: int, acc: int):
    """The unpacked scan kernel: CPU tensors take the plain version, CUDA
    tensors launch the kernel (or raise). Same contract as
    ``scan_unpacked_plain``; the kernel may pick the other id only where two
    candidates of a cell tie."""
    if Xs.device.type != "cuda":
        return scan_unpacked_plain(qs, Xs, xsq, tn, group, acc)
    B, d = qs.shape
    N = Xs.shape[0]
    G, n_tiles, acc, n_blocks, _ = _geometry(N, tn, group, acc)
    entry, layout = _check_card_geometry(G, tn, group, qs, Xs, packed=False)
    if acc * group > 65536:
        raise ValueError(f"the unpacked CUDA scan holds a span's row offsets in "
                         f"16 bits (acc * group <= 65536); got acc={acc} group={group}")
    dev = Xs.device
    qs = qs.to(dev).contiguous()
    Xs = Xs.contiguous()
    xsq = xsq.to(device=dev, dtype=torch.float32).contiguous()
    outd = torch.empty((n_blocks, B, 2 * G), dtype=torch.float32, device=dev)
    outi = torch.empty((n_blocks, B, 2 * G), dtype=torch.int32, device=dev)
    lib = kernel_lib.load("scan_topk_unpacked")
    # the library launches on the current card: the tensors' own, whatever
    # card the caller has current
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel_lib.launch(
            "scan_topk_unpacked", entry, lib.scan_topk_unpacked_launch,
            qs.data_ptr(), Xs.data_ptr(), xsq.data_ptr(), B, N, d, tn, group, acc,
            int(Xs.dtype == torch.bfloat16), kernel_lib.SCAN_ENTRIES.index(entry), layout,
            outd.data_ptr(), outi.data_ptr(), stream, card=dev.index)
    return outd, outi


def _decode(vals, cols, tn: int, group: int, acc: int, LB: int, N: int):
    """packed int32 + column -> (d2 f32 rounded down, global row id int64)."""
    G = tn // group
    mask = (1 << LB) - 1
    dval = (vals & ~mask).contiguous().view(torch.float32)
    loc = (vals & mask).to(torch.int64)
    cols = cols.to(torch.int64)
    block = cols // (2 * G)
    lane = (cols % (2 * G)) % G
    ids = (block * acc + loc // group) * tn + (loc % group) * G + lane
    return dval, torch.clamp_max(ids, N - 1)


def refine_width(k: int, overfetch: int, n_cand: int) -> int:
    """Finalists the refine re-scores: ``k + overfetch`` rounded up to a
    multiple of 32, at least 32, at most the ``n_cand`` candidates the scan
    kept (the JAX package's width, ``pallas_topk.py:246,308``). A recall
    contract, not a tile shape: on clustered corpora at large norms the bf16
    scan's order is coarse, and 18 finalists at k=10 lose about 1% of the
    top-10 that 32 keep."""
    return min(max(32, -(-(k + overfetch) // 32) * 32), n_cand)


def l2_topk(q, X, xsq, k: int, tn: int = SCAN_TN, group: int = SCAN_GROUP,
            refine: bool = True, Xscan=None, overfetch: int = 8,
            acc: int = 8, plain: bool = False, packed: bool = True):
    """Exact L2 top-k over a padded corpus: (dists [B,k] f32, ids [B,k] int64)
    ascending. ``X`` [Np, d] f32 padded by ``pad_corpus``; ``Xscan`` an
    optional reduced-precision copy (bf16) used only by the scan.

    With ``refine`` the scan keeps ``refine_width(k, overfetch)`` finalists
    and re-scores them in f32 with the direct |q - x|^2 form. ``packed=False``
    takes the unpacked scan (kernel B5): first-stage distances keep all their
    mantissa bits, at twice the candidate bytes. ``plain=True`` runs the
    scan's plain version whatever the device (kernel comparisons)."""
    B, d = q.shape
    N = X.shape[0]
    G, n_tiles, acc, n_blocks, LB = _geometry(N, tn, group, acc)
    qf = q.to(device=X.device, dtype=torch.float32)
    Xs = X if Xscan is None else Xscan
    qs = qf.to(Xs.dtype)
    if Xs.shape[1] > d:  # the copy's zero columns (scan_copy)
        qs = torch.nn.functional.pad(qs, (0, Xs.shape[1] - d))
    if packed:
        scan = scan_packed_plain if plain else scan_packed
        cv = scan(qs, Xs, xsq, tn, group, acc).permute(1, 0, 2).reshape(B, -1)
    else:
        scan = scan_unpacked_plain if plain else scan_unpacked
        outd, outi = scan(qs, Xs, xsq, tn, group, acc)
        cv = outd.permute(1, 0, 2).reshape(B, -1)
        ci = outi.permute(1, 0, 2).reshape(B, -1)
    kk = k if not refine else refine_width(k, overfetch, cv.shape[1])
    vals, pos = torch.topk(cv, kk, dim=1, largest=False, sorted=True)
    if packed:
        dval, ids = _decode(vals, pos, tn, group, acc, LB, N)
        first = dval  # carries |q|^2
    else:
        ids = torch.gather(ci, 1, pos).to(torch.int64)
        first = vals  # |x|^2 - 2 q.x: |q|^2 joins only now
        dval = vals + (qf * qf).sum(-1, keepdim=True)
    if not refine:
        return torch.sqrt(torch.clamp_min(dval, 0.0)), ids
    xv = X[ids].to(torch.float32)  # [B, kk, d] — finalists only
    diff = xv - qf[:, None, :]
    d2 = (diff * diff).sum(-1)
    # padding rows are zero vectors with a faked 3e38 sqnorm: re-mask them by
    # their first-stage score
    d2 = torch.where(first >= 1e37, torch.inf, d2)
    d2s, pos2 = torch.sort(d2, dim=1, stable=True)
    out_ids = torch.gather(ids, 1, pos2[:, :k])
    return torch.sqrt(torch.clamp_min(d2s[:, :k], 0.0)), out_ids


def pad_corpus(X: np.ndarray, tn: int = SCAN_TN, shuffle: bool | None = None,
               seed: int = 0x5EED):
    """Pad X to a multiple of ``tn`` rows; padding rows get a huge |x|^2 so
    they never enter the top-k. Returns (Xp, xsq, perm) where ``perm`` maps
    scan row -> original row.

    ``shuffle`` (default: on above one tile) stores the corpus in a fixed
    random row order: each keep-2 cell groups rows congruent mod G within a
    span, so a corpus whose ids correlate with geometry (cluster-ordered
    ingestion) would pile near-duplicates into shared cells and lose true
    neighbours; the permutation restores the iid collision odds."""
    N, d = X.shape
    Np = -(-max(N, tn) // tn) * tn
    if shuffle is None:
        shuffle = N > tn
    Xp = np.zeros((Np, d), np.float32)
    if shuffle:
        perm = np.random.default_rng(seed).permutation(N)
        np.take(X, perm, axis=0, out=Xp[:N])
    else:
        perm = np.arange(N)
        Xp[:N] = X
    xsq = np.empty(Np, np.float32)
    for s in range(0, N, 65536):  # chunked fp64 accumulation
        c = Xp[s:min(s + 65536, N)].astype(np.float64)
        xsq[s:min(s + 65536, N)] = (c * c).sum(-1).astype(np.float32)
    xsq[N:] = np.float32(3.0e38)
    return Xp, xsq, perm


def scan_program(programs, X, xsq, batch: int, dtype, *, Xscan=None, **static):
    """The ``ScanProgram`` of ``l2_topk`` for a batch of ``batch`` queries of
    ``dtype`` over this corpus and these static arguments (``k, tn, group,
    acc, overfetch, packed``), found in or built into the ``ProgramCache``
    ``programs``."""
    from .program import ScanProgram, call_key

    return programs.get(None, call_key((X, xsq, Xscan), batch, dtype, X.device, **static),
                        lambda: ScanProgram(X, xsq, batch, dtype, X.device, Xscan=Xscan,
                                            **static))


def l2_topk_stream(queries: np.ndarray, X, xsq, k: int, *, tn: int = SCAN_TN,
                   group: int = SCAN_GROUP, Xscan=None, overfetch: int = 8,
                   acc: int = 8, batch: int = 2048, query_dtype=None,
                   packed: bool = True, programs=None):
    """Pipelined exact-scan serving over a host query stream (upload of batch
    i+1 and fetch of batch i-1 overlap the scan of batch i; see
    ``ops/stream.py``). ``packed`` as in ``l2_topk``. Each batch replays the
    scan's program (``ops/program.py::ScanProgram``, a CUDA graph on the
    card) found in, or built into, the ``ProgramCache`` ``programs``;
    without one, a program is built for this call and dropped after it. The
    tail batch is padded to the batch shape, so one program serves the
    stream. Returns (dists [nq, k] f32, ids [nq, k] int64 — scan row
    indices)."""
    from .program import ProgramCache
    from .stream import pipelined_stream, upload_batch, fetch_host

    q = np.asarray(queries, np.float32)
    if q.ndim == 1:
        q = q[None, :]
    if query_dtype in ("f16", "float16", np.float16):
        q = q.astype(np.float16)
    elif query_dtype not in (None, "f32", "float32", np.float32):
        raise ValueError(f"unsupported query_dtype {query_dtype!r}")
    nq = q.shape[0]
    out_d = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int64)
    work = [(s, min(s + batch, nq)) for s in range(0, nq, batch)]
    dev = X.device
    # built before the stream's threads start: a capture must not overlap
    # their copies
    with PROFILER.span("search.prepare"):
        prog = scan_program(ProgramCache() if programs is None else programs, X, xsq, batch,
                            torch.from_numpy(q[:0]).dtype, k=k, tn=tn, group=group,
                            Xscan=Xscan, overfetch=overfetch, acc=acc, packed=packed)

    def _upload(w):
        ws, we = w
        qb = q[ws:we]
        if we - ws < batch:  # pad the tail to the batch shape
            qb = np.concatenate([qb, np.repeat(qb[-1:], batch - (we - ws), 0)])
        return upload_batch(qb, dev)

    def _dispatch(w, staged):
        return fetch_host(prog.run(staged.wait()))

    def _fetch(w, out):
        ws, we = w
        dd, ii = out.get()
        out_d[ws:we] = dd[: we - ws]
        out_i[ws:we] = ii[: we - ws]

    pipelined_stream(work, _upload, _dispatch, _fetch)
    return out_d, out_i
