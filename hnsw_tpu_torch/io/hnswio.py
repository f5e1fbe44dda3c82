"""Persistence — counterpart of ``hnsw_tpu/io/hnswio.py``: the reference's
dump format, byte for byte, plus the flat ``.npz`` snapshot.

A dump is two files, ``<basename>.hnsw.graph`` + ``<basename>.hnsw.data`` (reference
``src/hnswio.rs:4-7``). All integers are little-endian; ``usize`` is u64. Layout
(format v4, reference ``src/hnswio.rs:46-65,878-919,1063-1115,1303-1341``):

graph file:
  u32 MAGICDESCR_4 | u8 dumpmode | u8 max_nb_connection | f64 level_scale |
  u8 nb_layer (== 16) | u64 ef_construction | u64 nb_point | u64 dimension |
  u64 len + distname bytes | u64 len + typename bytes
  u8 nb_layer, then for each layer 0..16:
      u32 MAGICLAYER | u64 nb_point_in_layer
      per point (rank order): u32 MAGICPOINT | u64 origin_id | (Full: u8 layer,
      i32 rank) | for each of the 16 layers: u64 nbg | per neighbor
      (u64 d_id | Full: u8 layer, i32 rank | f32 distance)
  u64 entry origin_id | (Full: u8 layer, i32 rank)

data file:
  u32 MAGICDATAP | u64 dimension
  per point: u32 MAGICDATAP | u64 origin_id | u64 byte_len | raw vector bytes

Files are the state the two packages share: either package reads the other's
dumps and snapshots. Full dumps and reloads of ``NATIVE_IO_MIN_POINTS`` points
or more take the native C++ tier (``ffi/``: flat-array handoff, one buffered
pass), as in the JAX package; ``HNSW_TPU_NATIVE_IO=0`` turns that off. Where
the JAX package falls back to its Python route on any native error, the port
takes the Python route only on a machine without g++: a native build or load
that fails there raises. ``ROUTES`` counts the route each dump and reload
took. The Python route lays the records out with numpy — every field's byte
offset is computed for all points at once and the fields are scattered into
(or gathered from) one byte buffer — where the JAX package makes one
``struct`` call per field. The bytes are the same on every route.

The native snapshot (``save_native``/``load_native``) is a plain ``.npz`` of
the flat arrays.
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct
from typing import Optional

import numpy as np

from ..ffi import NativeHnsw, native_available
from ..models.hnsw import Hnsw, NB_LAYER_MAX
from ..utils.rng import DEFAULT_SEED

MAGICPOINT = 0x000A678F
MAGICDESCR_2 = 0x002A677F
MAGICDESCR_3 = 0x002A6771
MAGICDESCR_4 = 0x002A6779
MAGICLAYER = 0x000A676F
MAGICDATAP = 0xA67F0000

_RUST_TYPE = {"float32": "f32", "float64": "f64", "int32": "i32",
              "uint32": "u32", "uint16": "u16", "uint8": "u8"}
_NP_TYPE = {v: k for k, v in _RUST_TYPE.items()}
_DIST_PREFIX = "anndists::dist::distances::"


def rust_dist_name(metric_name: str) -> str:
    short = metric_name if metric_name.startswith("Dist") else "Dist" + metric_name
    return _DIST_PREFIX + short


def short_dist_name(full: str) -> str:
    s = full.rsplit("::", 1)[-1]
    return s[4:] if s.startswith("Dist") else s


@dataclasses.dataclass
class Description:
    """Dump header — mirrors reference ``Description`` (``src/hnswio.rs:846-930``)."""

    format_version: int
    dumpmode: int
    max_nb_connection: int
    level_scale: float
    nb_layer: int
    ef: int
    nb_point: int
    dimension: int
    distname: str
    t_name: str

    def get_typename(self) -> str:
        return self.t_name

    def get_dimension(self) -> int:
        return self.dimension


def _w(f, fmt, *vals):
    f.write(struct.pack("<" + fmt, *vals))


def _r(f, fmt):
    size = struct.calcsize("<" + fmt)
    buf = f.read(size)
    if len(buf) != size:
        raise EOFError("truncated dump file")
    return struct.unpack("<" + fmt, buf)


def write_description(f, d: Description):
    if not (0 < d.max_nb_connection <= 255):
        # the header stores M as a u8; the reference silently truncates 256 -> 0
        # (``src/hnsw.rs:823-825`` casts ``as u8``) — we reject instead
        raise ValueError("max_nb_connection must be in [1, 255] to dump (u8 header field)")
    _w(f, "I", MAGICDESCR_4)
    _w(f, "B", d.dumpmode)
    _w(f, "B", d.max_nb_connection)
    _w(f, "d", d.level_scale)
    if d.nb_layer != NB_LAYER_MAX:
        raise ValueError("nb_layer must equal NB_LAYER_MAX for dump")
    _w(f, "B", d.nb_layer)
    _w(f, "Q", d.ef)
    _w(f, "Q", d.nb_point)
    _w(f, "Q", d.dimension)
    name = d.distname.encode()
    _w(f, "Q", len(name))
    f.write(name)
    tname = d.t_name.encode()
    _w(f, "Q", len(tname))
    f.write(tname)


def read_description(f) -> Description:
    (magic,) = _r(f, "I")
    if magic not in (MAGICDESCR_2, MAGICDESCR_3, MAGICDESCR_4):
        raise ValueError(f"bad description magic 0x{magic:08x}")
    version = {MAGICDESCR_2: 2, MAGICDESCR_3: 3, MAGICDESCR_4: 4}[magic]
    (dumpmode,) = _r(f, "B")
    (max_nb_connection,) = _r(f, "B")
    level_scale = _r(f, "d")[0] if version == 4 else 1.0 / np.log(max(max_nb_connection, 2))
    (nb_layer,) = _r(f, "B")
    (ef,) = _r(f, "Q")
    (nb_point,) = _r(f, "Q")
    (dimension,) = _r(f, "Q")
    (nlen,) = _r(f, "Q")
    if nlen > 256:
        raise ValueError("distance name too long — corrupt dump?")
    distname = f.read(nlen).decode()
    (tlen,) = _r(f, "Q")
    if tlen > 256:
        raise ValueError("type name too long — corrupt dump?")
    t_name = f.read(tlen).decode()
    return Description(version, dumpmode, max_nb_connection, level_scale, nb_layer,
                       ef, nb_point, dimension, distname, t_name)


def load_description(path) -> Description:
    """Standalone header parse — reference ``load_description``
    (``src/hnswio.rs:937-1042``)."""
    with open(path, "rb") as f:
        return read_description(f)


# Full dumps and reloads of this many points or more take the native tier.
NATIVE_IO_MIN_POINTS = 5_000
_NATIVE_METRICS = ("L1", "L2", "Cosine", "Dot", "Hamming", "Jaccard",
                   "Hellinger", "Jeffreys", "JensenShannon", "Levenshtein")
ROUTES = {"file_dump.native": 0, "file_dump.python": 0,
          "load_hnsw.native": 0, "load_hnsw.python": 0}


def _native_io_enabled() -> bool:
    return (os.environ.get("HNSW_TPU_NATIVE_IO", "1") not in ("0", "false")
            and native_available())


def graph_path(dirpath, basename):
    return os.path.join(dirpath, basename + ".hnsw.graph")


def data_path(dirpath, basename):
    return os.path.join(dirpath, basename + ".hnsw.data")


# --------------------------------------------------- fields at computed offsets ------

def _put(buf: np.ndarray, pos: np.ndarray, values, dtype):
    """Write ``values`` (as little-endian ``dtype``) into the byte buffer at
    the byte offsets ``pos`` (unaligned), one byte column at a time."""
    v = np.ascontiguousarray(values, dtype=dtype)
    cols = v.view(np.uint8).reshape(len(v), v.dtype.itemsize)
    for k in range(cols.shape[1]):
        buf[pos + k] = cols[:, k]


def _get(buf: np.ndarray, pos: np.ndarray, dtype) -> np.ndarray:
    """Read one little-endian ``dtype`` value at each byte offset ``pos``."""
    dt = np.dtype(dtype)
    cols = np.empty((len(pos), dt.itemsize), np.uint8)
    for k in range(dt.itemsize):
        cols[:, k] = buf[pos + k]
    return cols.view(dt).ravel()


def _data_record_dtype(dtype: np.dtype, dim: int, version: int = 4) -> np.dtype:
    fields = [("magic", "<u4"), ("origin", "<u8"), ("blen", "<u8")]
    if version == 2:
        # v2 data records are bincode-serialized Vec<T>: u64 element count +
        # raw LE elements (reference src/hnswio.rs:1156-1172)
        fields.append(("cnt", "<u8"))
    fields.append(("v", dtype, (dim,)))
    return np.dtype(fields)  # packed: no alignment padding


# ------------------------------------------------------------------------- dump ------

def file_dump(hnsw: Hnsw, dirpath, basename: str, mode: str = "Full") -> str:
    """Dump to ``<dir>/<basename>.hnsw.{graph,data}`` — reference ``AnnT::file_dump``
    (``src/api.rs:70-94``); ``mode`` is ``"Full"`` or ``"Light"`` (no PointIds
    in the records). When the live index is mmap-backed the basename is
    uniquified instead of clobbering a possibly-mapped file (reference
    ``src/hnswio.rs:150-185``). Returns the basename used."""
    dirpath = str(dirpath)
    if hnsw.datamap_opt and os.path.exists(graph_path(dirpath, basename)):
        basename = f"{basename}-{np.random.randint(1, 2**31)}"
    full = mode == "Full"
    n = hnsw._nb_point
    if hnsw._entry < 0:
        raise ValueError("cannot dump an empty index (no entry point)")
    if hnsw._data is None:
        raise ValueError("cannot dump an index that holds no vectors "
                         "(graph-only reload)")
    if (full and n >= NATIVE_IO_MIN_POINTS and hnsw.metric.name in _NATIVE_METRICS
            and hnsw.dtype.name in _RUST_TYPE and _native_io_enabled()):
        NativeHnsw.from_hnsw(hnsw).file_dump(dirpath, basename)
        ROUTES["file_dump.native"] += 1
        return basename
    ROUTES["file_dump.python"] += 1
    d = Description(
        format_version=4, dumpmode=1 if full else 0,
        max_nb_connection=hnsw.max_nb_connection,
        level_scale=hnsw.get_level_scale(), nb_layer=NB_LAYER_MAX,
        ef=hnsw.ef_construction, nb_point=n, dimension=hnsw._dim or 0,
        distname=rust_dist_name(hnsw.metric.name),
        t_name=_RUST_TYPE.get(hnsw.dtype.name, hnsw.dtype.name),
    )
    head = io.BytesIO()
    write_description(head, d)
    _w(head, "B", NB_LAYER_MAX)
    head = head.getvalue()

    order = hnsw._iteration_order()  # layer 0 upward, rank order within layer
    level = hnsw._level[order].astype(np.int64)
    rank = hnsw._rank_in_layer[order]
    origin = hnsw._origin[:n].astype(np.uint64)
    in_layer = np.bincount(level, minlength=NB_LAYER_MAX)
    if (len(in_layer) != NB_LAYER_MAX
            or (in_layer != hnsw._layer_npoints[:NB_LAYER_MAX]).any()):
        raise ValueError("per-layer point counts disagree with the points' levels")

    # byte layout: a point record is its header, then for each of the 16
    # layers a u64 count followed by that many neighbour records
    p_hdr = 4 + 8 + (5 if full else 0)
    nb_rec = 8 + (5 if full else 0) + 4
    counts = np.zeros((n, NB_LAYER_MAX), np.int64)
    for l, t in hnsw._layers.items():
        counts[:, l] = t.counts[order]
    before = np.cumsum(counts, axis=1) - counts  # neighbours in lower layers
    p_len = p_hdr + 8 * NB_LAYER_MAX + nb_rec * counts.sum(1)
    p_end = np.cumsum(p_len)
    l_hdr = 4 + 8
    p_start = len(head) + l_hdr * (level + 1) + p_end - p_len
    first = np.concatenate([[0], np.cumsum(in_layer)])  # first point of layer l
    body = np.concatenate([[0], p_end])
    l_start = len(head) + l_hdr * np.arange(NB_LAYER_MAX) + body[first[:-1]]
    tail = len(head) + l_hdr * NB_LAYER_MAX + int(body[-1])
    buf = np.zeros(tail + 8 + (5 if full else 0), np.uint8)
    buf[:len(head)] = np.frombuffer(head, np.uint8)
    _put(buf, l_start, np.full(NB_LAYER_MAX, MAGICLAYER), "<u4")
    _put(buf, l_start + 4, in_layer, "<u8")
    _put(buf, p_start, np.full(n, MAGICPOINT), "<u4")
    _put(buf, p_start + 4, origin[order], "<u8")
    if full:
        _put(buf, p_start + 12, level, "u1")
        _put(buf, p_start + 13, rank, "<i4")
    c_pos = p_start[:, None] + p_hdr + 8 * np.arange(NB_LAYER_MAX) + nb_rec * before
    _put(buf, c_pos.ravel(), counts.ravel(), "<u8")
    for l, t in hnsw._layers.items():
        live = np.arange(t.width)[None, :] < counts[:, l][:, None]
        pi, pj = np.nonzero(live)  # dump position of the point, column
        nbr = t.ids[order][pi, pj]
        pos = c_pos[pi, l] + 8 + nb_rec * pj
        _put(buf, pos, origin[nbr], "<u8")
        if full:
            _put(buf, pos + 8, hnsw._level[nbr], "u1")
            _put(buf, pos + 9, hnsw._rank_in_layer[nbr], "<i4")
        _put(buf, pos + nb_rec - 4, t.dists[order][pi, pj], "<f4")
    entry = np.array([tail])
    _put(buf, entry, origin[[hnsw._entry]], "<u8")
    if full:
        _put(buf, entry + 8, hnsw._level[[hnsw._entry]], "u1")
        _put(buf, entry + 9, hnsw._rank_in_layer[[hnsw._entry]], "<i4")

    recs = np.empty(n, _data_record_dtype(hnsw.dtype, d.dimension))
    recs["magic"] = MAGICDATAP
    recs["origin"] = origin[order]
    recs["blen"] = d.dimension * hnsw.dtype.itemsize
    recs["v"] = hnsw._data[order]
    with open(graph_path(dirpath, basename), "wb") as g, \
            open(data_path(dirpath, basename), "wb") as dt:
        buf.tofile(g)
        _w(dt, "I", MAGICDATAP)
        _w(dt, "Q", d.dimension)
        recs.tofile(dt)
    return basename


# ------------------------------------------------------------------------- reload ----

@dataclasses.dataclass
class ReloadOptions:
    """Reference ``ReloadOptions`` (``src/hnswio.rs:87-133``). ``datamap=True`` keeps
    vector data as a zero-copy strided view over the (memory-mapped) data file;
    ``mmap_threshold`` is the number of most-recently-dumped points to materialize in
    RAM (upper layers load last, so they stay resident, matching the reference's
    policy note ``Changes.md:36-37``)."""

    datamap: bool = False
    mmap_threshold: int = 0


def _lookup(sorted_keys: np.ndarray, order: np.ndarray, keys: np.ndarray,
            what: str) -> np.ndarray:
    """Positions (through ``order``) of ``keys`` in ``sorted_keys``; the last
    of equal keys wins, as a dict filled in file order would have it."""
    at = np.searchsorted(sorted_keys, keys, side="right") - 1
    if len(keys) and ((at < 0).any() or (sorted_keys[np.maximum(at, 0)] != keys).any()):
        raise ValueError(f"dump names {what} that it does not hold")
    return order[at]


def _as_python_route(hnsw: Hnsw):
    """Give a native reload the tables the Python route gives: no table for a
    layer without links (``to_hnsw`` makes one for every level), and each row
    ordered by (distance, index) (the C++ reader sorts by distance alone,
    leaving equal distances in no fixed order; only rows holding a tie are
    re-sorted)."""
    n = hnsw._nb_point
    for l in [l for l, t in hnsw._layers.items() if not t.counts[:n].any()]:
        del hnsw._layers[l]
    for t in hnsw._layers.values():
        d = t.dists[:n]
        rows = np.flatnonzero(((d[:, 1:] == d[:, :-1]) & np.isfinite(d[:, 1:])).any(1))
        if len(rows):
            ids, dd = t.ids[rows], t.dists[rows]
            o = np.lexsort((ids, dd), axis=1)
            t.ids[rows] = np.take_along_axis(ids, o, 1)
            t.dists[rows] = np.take_along_axis(dd, o, 1)


class HnswIo:
    """Stateful reloader — reference ``HnswIo`` (``src/hnswio.rs:300-364``). Owns the
    optional mmap, so keep it alive as long as the reloaded index when using
    ``datamap`` (reference lifetime note ``src/hnswio.rs:265-267``)."""

    def __init__(self, dirpath, basename: str, options: Optional[ReloadOptions] = None):
        self.dir = str(dirpath)
        self.basename = basename
        self.options = options or ReloadOptions()
        self._mmap = None

    def set_options(self, options: ReloadOptions):
        self.options = options

    def load_description(self) -> Description:
        return load_description(graph_path(self.dir, self.basename))

    def load_hnsw(self, dist=None, dtype=None, graph_only: bool = False,
                  device=None) -> Hnsw:
        """Rebuild an index from a dump — reference ``HnswIo::load_hnsw``
        (``src/hnswio.rs:431-524``). ``graph_only=True`` is the ``NoData``/``NoDist``
        reload (topology without vectors). Handles Full and Light dumps (the
        reference's readers branch on dumpmode, ``src/hnswio.rs:1074-1090``):
        Light records carry no PointIds, so points take their (layer, rank) from
        file position and neighbors resolve by external id. ``device`` is the
        reloaded index's (``None``: the card), as for ``Hnsw(...)``."""
        gpath = graph_path(self.dir, self.basename)
        dpath = data_path(self.dir, self.basename)
        pre = load_description(gpath)
        if (not graph_only and not self.options.datamap and dtype is None
                and (dist is None or isinstance(dist, str))
                and pre.nb_point >= NATIVE_IO_MIN_POINTS and pre.t_name in _NP_TYPE
                and short_dist_name(pre.distname) in _NATIVE_METRICS
                and _native_io_enabled()):
            return self._load_native(pre, dist, device)
        ROUTES["load_hnsw.python"] += 1
        with open(gpath, "rb") as g:
            raw = g.read()
        f = io.BytesIO(raw)
        descr = read_description(f)
        if dist is not None:
            from ..ops.distances import get_metric
            want = get_metric(dist).name
            got = short_dist_name(descr.distname)
            if not graph_only and want != got and got != "NoDist":
                raise ValueError(f"distance mismatch: dump has {got}, requested {want}")
        dist = dist if dist is not None else short_dist_name(descr.distname)
        if graph_only:
            dist = "NoDist"
        np_dtype = dtype or _NP_TYPE.get(descr.t_name, "float32")
        full = descr.dumpmode == 1
        hnsw = Hnsw(max_nb_connection=descr.max_nb_connection,
                    max_elements=max(descr.nb_point, 8),
                    max_layer=descr.nb_layer, ef_construction=descr.ef,
                    dist=dist, dtype=np_dtype, seed=DEFAULT_SEED,
                    level_scale=descr.level_scale, device=device)
        # reference hardcodes these on reload (src/hnswio.rs:507-518)
        hnsw.extend_candidates = True
        hnsw.keep_pruned = False
        if descr.dimension > 0:
            if self.options.datamap and not graph_only:
                # _data becomes a lazy mmap view in _load_data — don't
                # materialize a [cap, dim] dense array just to throw it away
                hnsw._dim = int(descr.dimension)
            else:
                hnsw._set_dim(descr.dimension)
        hnsw._ensure_cap(descr.nb_point)
        (nb_layer,) = _r(f, "B")

        # pass 1: walk the records for the point headers and the byte offset
        # and value of every neighbour count (the only sequential part: a
        # record's length depends on its counts)
        p_hdr = struct.Struct("<IQBi" if full else "<IQ")
        l_hdr = struct.Struct("<IQ")
        u64 = struct.Struct("<Q")
        nb_rec = 8 + (5 if full else 0) + 4
        pos = f.tell()
        origins, c_pos, c_val, in_layer = [], [], [], []
        try:
            for layer in range(nb_layer):
                magic, nb_in_layer = l_hdr.unpack_from(raw, pos)
                pos += l_hdr.size
                if magic != MAGICLAYER:
                    raise ValueError("bad layer magic")
                in_layer.append(nb_in_layer)
                for rk in range(nb_in_layer):
                    hd = p_hdr.unpack_from(raw, pos)
                    pos += p_hdr.size
                    if hd[0] != MAGICPOINT:
                        raise ValueError("bad point magic")
                    if full and hd[2:] != (layer, rk):
                        raise ValueError(f"point id mismatch: {hd[2:]} != {(layer, rk)}")
                    origins.append(hd[1])
                    for _l in range(NB_LAYER_MAX):
                        (nbg,) = u64.unpack_from(raw, pos)
                        c_pos.append(pos)
                        c_val.append(nbg)
                        pos += 8 + nbg * nb_rec
            if pos > len(raw):
                raise EOFError("truncated dump file")
            ep = struct.unpack_from("<QBi" if full else "<Q", raw, pos)
        except struct.error:
            raise EOFError("truncated dump file") from None
        n = len(origins)
        if n != descr.nb_point:
            raise ValueError(f"dump header announces {descr.nb_point} points, "
                             f"its layers hold {n}")
        first = np.concatenate([[0], np.cumsum(in_layer)]).astype(np.int64)
        hnsw._origin[:n] = np.array(origins, np.uint64).astype(np.int64)
        for layer, nb_in_layer in enumerate(in_layer):
            s, e = first[layer], first[layer + 1]
            hnsw._level[s:e] = layer  # Light: the PointId is the file position
            hnsw._rank_in_layer[s:e] = np.arange(nb_in_layer)
            hnsw._layer_npoints[layer] = nb_in_layer
        hnsw._nb_point = n
        o_order = np.argsort(hnsw._origin[:n], kind="stable")
        o_sorted = hnsw._origin[:n][o_order]

        def by_pid(lv, rk):
            lv, rk = lv.astype(np.int64), rk.astype(np.int64)
            if len(lv) and ((lv >= len(in_layer)).any() or (rk < 0).any()
                            or (rk >= np.asarray(in_layer, np.int64)[
                                np.minimum(lv, len(in_layer) - 1)]).any()):
                raise ValueError("dump names a PointId that it does not hold")
            return first[lv] + rk

        if full:
            lv, rk = np.array([ep[1]]), np.array([ep[2]])
            ok = lv[0] < len(in_layer) and 0 <= rk[0] < in_layer[lv[0]]
            hnsw._entry = int(by_pid(lv, rk)[0]) if ok else -1
        else:
            at = np.searchsorted(o_sorted, np.int64(np.uint64(ep[0])), side="right") - 1
            found = at >= 0 and o_sorted[at] == np.int64(np.uint64(ep[0]))
            hnsw._entry = int(o_order[at]) if found else -1

        # pass 2: gather every layer's neighbour records at once, resolve
        # PointIds (Full) / external ids (Light) and sort each list by
        # (distance, index) (reference src/hnswio.rs:720-737)
        buf = np.frombuffer(raw, np.uint8)
        c_pos = np.array(c_pos, np.int64).reshape(n, NB_LAYER_MAX)
        c_val = np.array(c_val, np.int64).reshape(n, NB_LAYER_MAX)
        for l in range(NB_LAYER_MAX):
            cnt = c_val[:, l]
            total = int(cnt.sum())
            if total == 0:
                continue
            owner = np.repeat(np.arange(n), cnt)
            start = np.cumsum(cnt) - cnt
            col = np.arange(total) - start[owner]
            p = c_pos[owner, l] + 8 + nb_rec * col
            dd = _get(buf, p + nb_rec - 4, "<f4")
            if full:
                nbr = by_pid(_get(buf, p + 8, "u1"), _get(buf, p + 9, "<i4"))
            else:
                nbr = _lookup(o_sorted, o_order, _get(buf, p, "<u8").astype(np.int64),
                              "a neighbour id")
            o = np.lexsort((nbr, dd, owner))
            t = hnsw._layer_table(l)
            # rows wider than the M-derived default are kept intact: repaired
            # graphs carry reserve columns, and truncating here would drop the
            # repair links on reload. The repair grows a table 8 columns at a
            # time and the dump does not store the width, so a widened table
            # comes back at the next multiple of 8: the width it was built
            # with, and with it the codec's block geometry.
            if int(cnt.max()) > t.width:
                t.grow_width(-(-int(cnt.max()) // 8) * 8)
            t.ids[owner, col] = nbr[o]
            t.dists[owner, col] = dd[o]
            t.counts[:n] = cnt
        if not graph_only and descr.dimension > 0:
            self._load_data(hnsw, dpath, descr)
        hnsw._version += 1
        return hnsw

    def _load_native(self, descr: Description, dist, device) -> Hnsw:
        """The native route of ``load_hnsw``: the C++ reader, then the
        flat-array export (``NativeHnsw.to_hnsw``, which widens tables as the
        Python route does), then the Python route's table layout."""
        if dist is not None:
            from ..ops.distances import get_metric
            want, got = get_metric(dist).name, short_dist_name(descr.distname)
            if want != got:
                raise ValueError(f"distance mismatch: dump has {got}, requested {want}")
        h = NativeHnsw.load(self.dir, self.basename).to_hnsw(device=device)
        _as_python_route(h)
        # reference hardcodes these on reload (src/hnswio.rs:507-518)
        h.extend_candidates = True
        h.keep_pruned = False
        h._version += 1
        ROUTES["load_hnsw.native"] += 1
        return h

    def load_hnsw_with_dist(self, dist, dtype=None, device=None) -> Hnsw:
        """Reload with an explicit distance instance (reference
        ``load_hnsw_with_dist``, ``src/hnswio.rs:531-613``)."""
        return self.load_hnsw(dist=dist, dtype=dtype, device=device)

    def _load_data(self, hnsw: Hnsw, dpath: str, descr: Description):
        from .datamap import DataMap
        if self.options.datamap and descr.format_version == 2:
            raise ValueError("datamap reload needs fixed-size records (format >= 3); "
                             "v2 bincode data records carry a length prefix")
        n = hnsw._nb_point
        if self.options.datamap:
            dm = DataMap(self.dir, self.basename, dtype=hnsw.dtype)
            self._mmap = dm
            ids = dm.ids()
            o = np.argsort(ids, kind="stable")
            perm = _lookup(ids[o], o, hnsw._origin[:n], "a point without a data record")
            # partial residency (reference src/hnswio.rs:675-692): _data becomes a
            # lazy view over the mmap; only the last `threshold` records (upper
            # layers, dumped last) are materialized in RAM, searches/uploads read
            # through the map, and post-reload inserts land in a RAM overlay.
            hnsw._data = dm.lazy_data(perm, hnsw._cap,
                                      threshold=self.options.mmap_threshold)
            hnsw.set_datamap(True)
            return
        with open(dpath, "rb") as f:
            (magic,) = _r(f, "I")
            if magic != MAGICDATAP:
                raise ValueError("bad data file magic")
            (dim,) = _r(f, "Q")
            if dim != descr.dimension:
                raise ValueError("data dimension mismatch")
            rec_dt = _data_record_dtype(hnsw.dtype, int(dim), descr.format_version)
            recs = np.fromfile(f, rec_dt, count=n)
        if len(recs) != n:
            raise EOFError("truncated data file")
        if (recs["magic"] != MAGICDATAP).any():
            raise ValueError("bad data record magic")
        if (recs["blen"] != rec_dt.itemsize - 20).any():
            raise ValueError("data record length does not match the dimension")
        rec_origin = recs["origin"].astype(np.int64)
        o = np.argsort(rec_origin, kind="stable")
        hnsw._data[:n] = recs["v"][_lookup(rec_origin[o], o, hnsw._origin[:n],
                                           "a point without a data record")]


# -------------------------------------------------------------- native snapshot ------

def save_native(hnsw: Hnsw, path: str):
    """Fast flat-array snapshot (.npz) — everything round-trips exactly."""
    n = hnsw._nb_point
    arrays = {
        "data": hnsw._data[:n] if hnsw._data is not None else np.zeros((0, 0), hnsw.dtype),
        "origin": hnsw._origin[:n], "level": hnsw._level[:n],
        "rank": hnsw._rank_in_layer[:n], "layer_npoints": hnsw._layer_npoints,
        "meta": np.array([hnsw.max_nb_connection, hnsw.max_layer, hnsw.ef_construction,
                          hnsw._entry, n, int(hnsw.extend_candidates), int(hnsw.keep_pruned)],
                         np.int64),
        "level_scale": np.float64(hnsw.get_level_scale()),
        "metric": np.array(hnsw.metric.name),
        "dtype": np.array(hnsw.dtype.name),
    }
    for l, t in hnsw._layers.items():
        arrays[f"l{l}_ids"] = t.ids[:n]
        arrays[f"l{l}_dists"] = t.dists[:n]
        arrays[f"l{l}_counts"] = t.counts[:n]
    np.savez_compressed(path, **arrays)


def load_native(path: str, device=None) -> Hnsw:
    """Reload a ``save_native`` snapshot onto ``device`` (``None``: the card)."""
    with np.load(path, allow_pickle=False) as z:
        M, max_layer, ef, entry, n, ext, keep = (int(x) for x in z["meta"])
        hnsw = Hnsw(max_nb_connection=M, max_elements=max(n, 8), max_layer=max_layer,
                    ef_construction=ef, dist=str(z["metric"]), dtype=str(z["dtype"]),
                    level_scale=float(z["level_scale"]), device=device)
        hnsw.extend_candidates = bool(ext)
        hnsw.keep_pruned = bool(keep)
        data = z["data"]
        if data.size:
            hnsw._set_dim(data.shape[1])
            hnsw._ensure_cap(n)
            hnsw._data[:n] = data
        else:
            hnsw._ensure_cap(n)
        hnsw._origin[:n] = z["origin"]
        hnsw._level[:n] = z["level"]
        hnsw._rank_in_layer[:n] = z["rank"]
        hnsw._layer_npoints[:] = z["layer_npoints"]
        hnsw._entry = entry
        hnsw._nb_point = n
        for key in z.files:
            if key.endswith("_ids") and key.startswith("l"):
                l = int(key[1:-4])
                t = hnsw._layer_table(l)
                ids = z[key]
                w = ids.shape[1]
                t.grow_width(w)  # repaired (widened) snapshot
                t.ids[:n, :w] = ids
                t.dists[:n, :w] = z[f"l{l}_dists"]
                t.counts[:n] = z[f"l{l}_counts"]
    hnsw._version += 1
    return hnsw
