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

Each kernel has two entries, chosen here from dtype and ``d`` alone
(``scan_entry``), never after a failed build or launch: ``"wgmma"``, the
tensor-core tile product of ``csrc/scan_tile.cuh`` (bf16 queries and corpus,
``d`` a multiple of 16 that fits its shared-memory ring), whose grid is
``B/128 x spans`` blocks (224 at B = 2048 over the 200k corpus); and
``"simt"``, the register-tiled f32-FMA kernel (``B/64 x spans`` blocks), for
f32 inputs (whose contract is full f32: TF32 would keep 10 mantissa bits) and
every other ``d``. ``kernel_lib.LAUNCHES["scan_topk.wgmma"]`` etc. count the
launches of each entry.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernel_lib

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


# Largest d the tensor-core entry takes: the query tile, two stages of the
# ring and the epilogue's own bytes must fit in 227 KB of shared memory
# (``scan_tile::pick_stages``). The unpacked epilogue keeps 64 KB of id words.
WGMMA_MAX_D = {True: 256, False: 192}  # keyed by ``packed``


def scan_entry(dtype, d: int, packed: bool = True) -> str:
    """Which kernel entry a CUDA scan of this dtype and depth takes:
    ``"wgmma"`` for bf16 with ``d`` a multiple of 16 up to
    ``WGMMA_MAX_D[packed]``, else ``"simt"``. A choice by shape: the entry it
    names either launches or raises."""
    if dtype == torch.bfloat16 and d % 16 == 0 and 0 < d <= WGMMA_MAX_D[bool(packed)]:
        return "wgmma"
    return "simt"


def _check_card_geometry(G: int, tn: int, group: int, qs, Xs, packed: bool) -> str:
    """Raises on what the CUDA scan does not take; returns the entry."""
    if G != 128:
        raise ValueError(f"the CUDA scan runs 128 lane groups (tn = 128 * group); "
                         f"got tn={tn} group={group}")
    if Xs.dtype not in (torch.bfloat16, torch.float32) or qs.dtype != Xs.dtype:
        raise ValueError("the CUDA scan takes bf16 or f32 queries and corpus "
                         "of one type")
    return scan_entry(Xs.dtype, qs.shape[1], packed)


def scan_packed_plain(qs, Xs, xsq, tn: int, group: int, acc: int):
    """Plain PyTorch version of the scan kernel: packed int32
    ``[n_blocks, B, 2G]`` (per lane group: smallest, then second smallest).

    ``qs``/``Xs`` are the scan-precision query and corpus (bf16 or f32); the
    inner products are f32 products of those values, as the kernel's."""
    B, d = qs.shape
    N = Xs.shape[0]
    G, n_tiles, acc, n_blocks, LB = _geometry(N, tn, group, acc)
    qf = qs.to(torch.float32)
    qsq = (qf * qf).sum(1, keepdim=True)
    g = qf @ Xs.to(torch.float32).T  # [B, N]
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
    entry = _check_card_geometry(G, tn, group, qs, Xs, packed=True)
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
                          kernel_lib.SCAN_ENTRIES.index(entry), out.data_ptr(), stream,
                          card=dev.index)
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
    g = qs.to(torch.float32) @ Xs.to(torch.float32).T  # [B, N]
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
    entry = _check_card_geometry(G, tn, group, qs, Xs, packed=False)
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
            int(Xs.dtype == torch.bfloat16), kernel_lib.SCAN_ENTRIES.index(entry),
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
    prog = scan_program(ProgramCache() if programs is None else programs, X, xsq, batch,
                        torch.from_numpy(q[:0]).dtype, k=k, tn=tn, group=group, Xscan=Xscan,
                        overfetch=overfetch, acc=acc, packed=packed)

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
