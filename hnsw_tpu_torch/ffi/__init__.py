"""Native runtime tier: a multithreaded C++ graph builder behind a C ABI —
counterpart of ``hnsw_tpu/ffi/``.

``hnsw_core.cpp`` and ``hnsw_tpu.h`` here are the port's own copies of the
JAX package's sources, byte for byte (a test holds them equal). The library
builds with g++ at first use, as the JAX package's does: compiled with
``-ffast-math`` and linked without it (linking with it pulls in
``crtfastmath.o``, which turns flush-to-zero on for the whole process when
the library loads). It lands in ``build/hnsw_tpu_torch/`` at the repo root,
named by a hash of the sources, the flags and the host CPU (``-march=native``
code built on one CPU may not run on another), and is written to a temporary
name first and moved into place, so processes that build at the same moment
never load a half-written file.

The surface mirrors the JAX package's under the same names: opaque index
handles with insert / search / filtered and parallel variants and custom
distances (ctypes callbacks, kept alive as long as the handle), the typed
surface (f32/f64/i32/u32/u16/u8), the reference-format dump and its three
reloads, and the flat-array handoff to and from the port's ``Hnsw``
(``from_hnsw`` / ``to_hnsw``). One difference: ``to_hnsw`` gives a layer
widened past its default (a repaired graph) the next multiple of 8 columns,
the width ``io/hnswio.py``'s reader gives it, so an index reloads to the same
tables whichever route reads it.
"""

from __future__ import annotations

import ctypes as C
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops.kernel_lib import BUILD_DIR

_HERE = Path(__file__).resolve().parent
SOURCES = ("hnsw_core.cpp", "hnsw_tpu.h")
COMPILE_FLAGS = ("-O3", "-march=native", "-ffast-math", "-funroll-loops", "-DNDEBUG",
                 "-std=c++17", "-fPIC")
LINK_FLAGS = ("-shared", "-pthread")
_lock = threading.Lock()
_lib = None

DIST_FN_T = C.CFUNCTYPE(C.c_float, C.POINTER(C.c_float), C.POINTER(C.c_float),
                        C.c_uint64)
FILTER_FN_T = C.CFUNCTYPE(C.c_int, C.c_int64)


class DescriptionFFI(C.Structure):
    """C-struct dump header, filled by ``hnsw_load_description`` — the
    reference's ``DescriptionFFI`` (``src/libext.rs:1121-1232``)."""

    _fields_ = [
        ("format_version", C.c_int32),
        ("dumpmode", C.c_int32),
        ("max_nb_connection", C.c_int32),
        ("nb_layer", C.c_int32),
        ("level_scale", C.c_double),
        ("ef_construction", C.c_uint64),
        ("nb_point", C.c_uint64),
        ("dimension", C.c_uint64),
        ("distname", C.c_char * 64),
        ("t_name", C.c_char * 16),
    ]


def native_available() -> bool:
    """Whether this machine can build the native tier (g++ on the PATH)."""
    return shutil.which("g++") is not None


def _cpu_tag() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return platform.processor().encode()


def lib_path() -> Path:
    """Where the library for these sources, flags and CPU lives."""
    h = hashlib.sha1()
    for name in SOURCES:
        h.update((_HERE / name).read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    h.update(_cpu_tag())
    return BUILD_DIR / f"libhnsw_core-{h.hexdigest()[:12]}.so"


def _build_so() -> Path:
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native tier builds with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    obj, tmp = out.with_suffix(f".{tag}.o"), out.with_suffix(f".{tag}.tmp")
    try:
        for cmd in ([cxx, "-c", *COMPILE_FLAGS, "-o", str(obj), str(_HERE / SOURCES[0])],
                    [cxx, *LINK_FLAGS, "-o", str(tmp), str(obj)]):
            p = subprocess.run(cmd, capture_output=True, text=True)
            if p.returncode != 0:
                raise RuntimeError(f"g++ failed building the native tier:\n{p.stderr}")
        os.replace(tmp, out)
    finally:
        for f in (obj, tmp):
            if f.exists():
                f.unlink()
    return out


_TYPED = {"float32": "f32", "float64": "f64", "int32": "i32",
          "uint32": "u32", "uint16": "u16", "uint8": "u8"}


def native_lib():
    """Load (building if needed) the native core; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = C.CDLL(str(_build_so()))
        _bind(lib)
        _lib = lib
        return lib


def _bind(lib):
    lib.hnsw_init.restype = C.c_void_p
    lib.hnsw_init.argtypes = [C.c_uint64, C.c_uint64, C.c_uint64, C.c_uint64, C.c_char_p]
    lib.hnsw_init_ptrdist.restype = C.c_void_p
    lib.hnsw_init_ptrdist.argtypes = [C.c_uint64, C.c_uint64, C.c_uint64, C.c_uint64,
                                      DIST_FN_T]
    lib.hnsw_drop.argtypes = [C.c_void_p]
    lib.hnsw_set_extend_candidates.argtypes = [C.c_void_p, C.c_int]
    lib.hnsw_set_keeping_pruned.argtypes = [C.c_void_p, C.c_int]
    lib.hnsw_modify_level_scale.argtypes = [C.c_void_p, C.c_double]
    lib.hnsw_nb_points.restype = C.c_uint64
    lib.hnsw_nb_points.argtypes = [C.c_void_p]
    lib.hnsw_dim.restype = C.c_uint64
    lib.hnsw_dim.argtypes = [C.c_void_p]
    lib.hnsw_entry_point.restype = C.c_int64
    lib.hnsw_entry_point.argtypes = [C.c_void_p]
    lib.hnsw_max_level_used.restype = C.c_int32
    lib.hnsw_max_level_used.argtypes = [C.c_void_p]
    lib.hnsw_layer_count.restype = C.c_int64
    lib.hnsw_layer_count.argtypes = [C.c_void_p, C.c_int32]
    lib.hnsw_level_scale.restype = C.c_double
    lib.hnsw_level_scale.argtypes = [C.c_void_p]
    lib.hnsw_export_meta.argtypes = [C.c_void_p, C.POINTER(C.c_int64),
                                     C.POINTER(C.c_int32), C.POINTER(C.c_int32)]
    lib.hnsw_layer_max_row.restype = C.c_int64
    lib.hnsw_layer_max_row.argtypes = [C.c_void_p, C.c_int32]
    lib.hnsw_export_layer_w.argtypes = [C.c_void_p, C.c_int32, C.c_int64,
                                        C.POINTER(C.c_int32), C.POINTER(C.c_float)]
    # the typed surface (element-type parity with the reference's per-type FFI)
    for suf in _TYPED.values():
        f = getattr(lib, f"hnsw_init_{suf}")
        f.restype = C.c_void_p
        f.argtypes = [C.c_uint64, C.c_uint64, C.c_uint64, C.c_uint64, C.c_char_p]
        getattr(lib, f"hnsw_insert_{suf}").argtypes = [
            C.c_void_p, C.c_void_p, C.c_uint64, C.c_int64]
        getattr(lib, f"hnsw_parallel_insert_{suf}").argtypes = [
            C.c_void_p, C.c_void_p, C.c_uint64, C.c_uint64, C.POINTER(C.c_int64), C.c_int]
        g = getattr(lib, f"hnsw_search_{suf}")
        g.restype = C.c_uint64
        g.argtypes = [C.c_void_p, C.c_void_p, C.c_uint64, C.c_uint64,
                      C.POINTER(C.c_int64), C.POINTER(C.c_float)]
        g = getattr(lib, f"hnsw_search_filter_{suf}")
        g.restype = C.c_uint64
        g.argtypes = [C.c_void_p, C.c_void_p, C.c_uint64, C.c_uint64, FILTER_FN_T,
                      C.POINTER(C.c_int64), C.POINTER(C.c_float)]
        getattr(lib, f"hnsw_parallel_search_{suf}").argtypes = [
            C.c_void_p, C.c_void_p, C.c_uint64, C.c_uint64, C.c_uint64, C.c_int,
            C.POINTER(C.c_int64), C.POINTER(C.c_float)]
        getattr(lib, f"hnsw_export_data_{suf}").argtypes = [C.c_void_p, C.c_void_p]
        f = getattr(lib, f"hnsw_import_{suf}")
        f.restype = C.c_void_p
        f.argtypes = [C.c_uint64, C.c_uint64, C.c_uint64, C.c_char_p, C.c_double,
                      C.c_uint64, C.c_uint64, C.c_void_p, C.POINTER(C.c_int64),
                      C.POINTER(C.c_int32), C.POINTER(C.c_int32), C.c_int64, C.c_int32,
                      C.POINTER(C.c_int64), C.POINTER(C.c_void_p), C.POINTER(C.c_void_p),
                      C.c_int, C.c_int]
    lib.hnsw_load_ptrdist.restype = C.c_void_p
    lib.hnsw_load_ptrdist.argtypes = [C.c_char_p, C.c_char_p, DIST_FN_T]
    lib.hnsw_init_log.argtypes = [C.c_int32]
    lib.hnsw_file_dump.restype = C.c_int32
    lib.hnsw_file_dump.argtypes = [C.c_void_p, C.c_char_p, C.c_char_p]
    lib.hnsw_load.restype = C.c_void_p
    lib.hnsw_load.argtypes = [C.c_char_p, C.c_char_p]
    lib.hnsw_element_type.restype = C.c_int32
    lib.hnsw_element_type.argtypes = [C.c_void_p]
    lib.hnsw_load_description.restype = C.c_int32
    lib.hnsw_load_description.argtypes = [C.c_char_p, C.c_char_p, C.POINTER(DescriptionFFI)]
    lib.hnsw_load_graph_only.restype = C.c_void_p
    lib.hnsw_load_graph_only.argtypes = [C.c_char_p, C.c_char_p]


def init_native_log(level: int = 1):
    """The native tier's verbosity (0 silent, 1 info, 2 debug) — the
    reference's ``init_rust_log`` (``src/libext.rs:1237-1240``); also set by
    the ``HNSW_NATIVE_LOG`` environment variable."""
    native_lib().hnsw_init_log(int(level))


def load_hnsw_description(path, basename: str) -> DescriptionFFI:
    """A dump's header through the C ABI, without loading the index."""
    lib = native_lib()
    d = DescriptionFFI()
    rc = lib.hnsw_load_description(str(path).encode(), basename.encode(), C.byref(d))
    if rc != 0:
        raise IOError(f"native description load failed (rc={rc}) for {path}/{basename}")
    return d


def _fp(a: np.ndarray):
    return a.ctypes.data_as(C.POINTER(C.c_float))


def _ip64(a: np.ndarray):
    return a.ctypes.data_as(C.POINTER(C.c_int64))


def _ip32(a: np.ndarray):
    return a.ctypes.data_as(C.POINTER(C.c_int32))


def _dist_callback(dist_fn):
    return DIST_FN_T(lambda a, b, n: float(
        dist_fn(np.ctypeslib.as_array(a, (n,)), np.ctypeslib.as_array(b, (n,)))))


class NativeHnsw:
    """An index of the native core behind its opaque handle — the
    reference's ``HnswApi*`` handles (``src/libext.rs:38-101``)."""

    def __init__(self, max_nb_connection=16, max_elements=10_000, max_layer=16,
                 ef_construction=200, dist="L2", dist_fn=None, dtype=np.float32):
        self.lib = native_lib()
        self._keepalive = []  # callbacks the handle holds for its lifetime
        self.dtype = np.dtype(dtype)
        if self.dtype.name not in _TYPED:
            raise ValueError(f"unsupported native element type {self.dtype}")
        self._suf = _TYPED[self.dtype.name]
        if dist_fn is not None:
            if self.dtype != np.float32:
                raise ValueError("custom distances are f32-only on the native tier")
            cb = _dist_callback(dist_fn)
            self._keepalive.append(cb)
            self.h = self.lib.hnsw_init_ptrdist(max_nb_connection, ef_construction,
                                                max_elements, max_layer, cb)
            self.dist_name = "DistPtr"
        else:
            self.h = getattr(self.lib, f"hnsw_init_{self._suf}")(
                max_nb_connection, ef_construction, max_elements, max_layer,
                str(dist).encode())
            self.dist_name = str(dist)
        if not self.h:
            raise ValueError("native init failed (check max_nb_connection <= 256)")
        self.M = max_nb_connection
        self.max_layer = max_layer
        self.ef_construction = ef_construction

    @classmethod
    def _wrap(cls, lib, handle, dtype, M, max_layer, ef_construction, dist_name):
        self = cls.__new__(cls)
        self.lib, self.h, self._keepalive = lib, handle, []
        self.dtype = np.dtype(dtype)
        self._suf = _TYPED[self.dtype.name]
        self.M, self.max_layer = M, max_layer
        self.ef_construction, self.dist_name = ef_construction, dist_name
        return self

    def _fn(self, name):
        return getattr(self.lib, f"hnsw_{name}_{self._suf}")

    @staticmethod
    def _dp(a):
        return C.c_void_p(a.ctypes.data)

    def __del__(self):
        try:
            if getattr(self, "h", None):
                self.lib.hnsw_drop(self.h)
                self.h = None
        except Exception:
            pass

    def set_extend_candidates(self, flag: bool):
        self.lib.hnsw_set_extend_candidates(self.h, int(flag))

    def set_keeping_pruned(self, flag: bool):
        self.lib.hnsw_set_keeping_pruned(self.h, int(flag))

    def modify_level_scale(self, f: float):
        self.lib.hnsw_modify_level_scale(self.h, float(f))

    def insert(self, v, data_id: int):
        v = np.ascontiguousarray(v, self.dtype)
        self._fn("insert")(self.h, self._dp(v), v.shape[-1], int(data_id))

    def parallel_insert(self, X, ids, n_threads: int = 0):
        X = np.ascontiguousarray(X, self.dtype)
        ids = np.ascontiguousarray(ids, np.int64)
        self._fn("parallel_insert")(self.h, self._dp(X), X.shape[0], X.shape[1],
                                    _ip64(ids), int(n_threads))

    def search(self, q, knbn: int, ef: int, filter_fn=None):
        q = np.ascontiguousarray(q, self.dtype)
        out_i = np.full(knbn, -1, np.int64)
        out_d = np.full(knbn, np.inf, np.float32)
        if filter_fn is None:
            k = self._fn("search")(self.h, self._dp(q), knbn, ef, _ip64(out_i), _fp(out_d))
        else:
            cb = FILTER_FN_T(lambda i: 1 if filter_fn(int(i)) else 0)
            k = self._fn("search_filter")(self.h, self._dp(q), knbn, ef, cb,
                                          _ip64(out_i), _fp(out_d))
        return out_i[:k], out_d[:k]

    def parallel_search(self, Q, knbn: int, ef: int, n_threads: int = 0):
        Q = np.ascontiguousarray(Q, self.dtype)
        nq = Q.shape[0]
        out_i = np.full((nq, knbn), -1, np.int64)
        out_d = np.full((nq, knbn), np.inf, np.float32)
        self._fn("parallel_search")(self.h, self._dp(Q), nq, knbn, ef, int(n_threads),
                                    _ip64(out_i), _fp(out_d))
        return out_i, out_d

    def __len__(self):
        return int(self.lib.hnsw_nb_points(self.h))

    def file_dump(self, path, basename: str) -> str:
        """Reference-format dump straight from the native core — the same bytes
        as ``io/hnswio.py``'s writer."""
        rc = self.lib.hnsw_file_dump(self.h, str(path).encode(), basename.encode())
        if rc != 0:
            raise IOError(f"native dump failed (rc={rc})")
        return basename

    @classmethod
    def _wrap_loaded(cls, lib, h, path, basename) -> "NativeHnsw":
        """Wrap a reloaded handle with its element type, and M, efC and the
        distance from the dump's header, so that ``to_hnsw()`` is faithful."""
        from ..io.hnswio import short_dist_name
        tcode = int(lib.hnsw_element_type(h))
        d = load_hnsw_description(path, basename)
        return cls._wrap(lib, h, ["float32", "float64", "int32", "uint32", "uint16",
                                  "uint8"][tcode], d.max_nb_connection, d.nb_layer,
                         d.ef_construction, short_dist_name(d.distname.decode()))

    @classmethod
    def load(cls, path, basename: str) -> "NativeHnsw":
        """Reload a Full or Light v2/v3/v4 dump (C ABI ``hnsw_load``). A DistPtr
        dump raises: reload it with :meth:`load_ptrdist`."""
        lib = native_lib()
        h = lib.hnsw_load(str(path).encode(), basename.encode())
        if not h:
            raise IOError(f"native load failed for {path}/{basename}")
        return cls._wrap_loaded(lib, h, path, basename)

    @classmethod
    def load_ptrdist(cls, path, basename: str, dist_fn) -> "NativeHnsw":
        """Reload a DistPtr dump with the caller's distance function (reference
        ``load_hnsw_with_dist``, ``src/hnswio.rs:531-613``); f32 only."""
        lib = native_lib()
        cb = _dist_callback(dist_fn)
        h = lib.hnsw_load_ptrdist(str(path).encode(), basename.encode(), cb)
        if not h:
            raise IOError(f"native ptrdist load failed for {path}/{basename}")
        self = cls._wrap_loaded(lib, h, path, basename)
        self._keepalive.append(cb)  # the index calls it for its lifetime
        return self

    @classmethod
    def load_graph_only(cls, path, basename: str) -> "NativeHnsw":
        """NoData reload: topology and metadata, no vectors (reference
        ``libext.rs:446-451``). Searches answer nothing; the exports, the
        metadata and ``to_hnsw()`` work."""
        lib = native_lib()
        h = lib.hnsw_load_graph_only(str(path).encode(), basename.encode())
        if not h:
            raise IOError(f"native graph-only load failed for {path}/{basename}")
        return cls._wrap_loaded(lib, h, path, basename)

    @classmethod
    def from_hnsw(cls, h) -> "NativeHnsw":
        """Import a port ``Hnsw`` through the flat-array C ABI
        (``hnsw_import_*``), the inverse of :meth:`to_hnsw`. Rows keep their
        stored order, so ``file_dump`` of the result writes the bytes the
        Python writer writes."""
        lib = native_lib()
        n = h._nb_point
        if n == 0:
            raise ValueError("cannot import an empty index")
        dt = np.dtype(h.dtype)
        if dt.name not in _TYPED:
            raise ValueError(f"unsupported native element type {dt}")
        data = np.ascontiguousarray(np.asarray(h._data[:n], dtype=dt))
        origin = np.ascontiguousarray(h._origin[:n], np.int64)
        level = np.ascontiguousarray(h._level[:n], np.int32)
        rank = np.ascontiguousarray(h._rank_in_layer[:n], np.int32)
        L = max(h._layers.keys(), default=-1) + 1
        widths = np.zeros(max(L, 1), np.int64)
        lid_ptrs = (C.c_void_p * max(L, 1))()
        ldd_ptrs = (C.c_void_p * max(L, 1))()
        keep = []  # the row arrays must outlive the call
        for l in range(L):
            t = h._layers.get(l)
            if t is None:
                continue
            ids = np.ascontiguousarray(t.ids[:n], np.int32)
            dds = np.ascontiguousarray(t.dists[:n], np.float32)
            keep.append((ids, dds))
            widths[l] = t.width
            lid_ptrs[l] = ids.ctypes.data
            ldd_ptrs[l] = dds.ctypes.data
        handle = getattr(lib, f"hnsw_import_{_TYPED[dt.name]}")(
            h.max_nb_connection, h.ef_construction, h.max_layer,
            h.metric.name.encode(), float(h.get_level_scale()), n, h._dim or 0,
            C.c_void_p(data.ctypes.data), _ip64(origin), _ip32(level), _ip32(rank),
            int(h._entry), L, _ip64(widths), lid_ptrs, ldd_ptrs,
            int(h.extend_candidates), int(h.keep_pruned))
        if not handle:
            raise ValueError("native import failed")
        return cls._wrap(lib, handle, dt, h.max_nb_connection, h.max_layer,
                         h.ef_construction, h.metric.name)

    def to_hnsw(self, device=None):
        """Export the native graph into a port ``Hnsw`` on ``device`` (``None``:
        the card), so a natively built graph gets every capability of the
        port: batched search on the device, persistence, flatten, filters.
        A layer widened past its default width comes back at its widest row
        rounded up to a multiple of 8 (see the module docstring)."""
        from ..models.hnsw import Hnsw
        n = len(self)
        dim = int(self.lib.hnsw_dim(self.h))
        h = Hnsw(max_nb_connection=self.M, max_elements=max(n, 8),
                 max_layer=self.max_layer, ef_construction=self.ef_construction,
                 dist=self.dist_name if self.dist_name != "DistPtr" else "L2",
                 dtype=self.dtype, level_scale=float(self.lib.hnsw_level_scale(self.h)),
                 device=device)
        if n == 0:
            return h
        h._set_dim(dim)
        h._ensure_cap(n)
        self._fn("export_data")(self.h, self._dp(h._data[:n]))
        org = np.empty(n, np.int64)
        lvl = np.empty(n, np.int32)
        rnk = np.empty(n, np.int32)
        self.lib.hnsw_export_meta(self.h, _ip64(org), _ip32(lvl), _ip32(rnk))
        h._origin[:n] = org
        h._level[:n] = lvl
        h._rank_in_layer[:n] = rnk
        for l in range(int(self.lib.hnsw_max_level_used(self.h)) + 1):
            h._layer_npoints[l] = int(self.lib.hnsw_layer_count(self.h, l))
        # every layer that can hold links (levels, backlinks at l_n, projections)
        for l in range(int(lvl.max(initial=0)) + 1):
            t = h._layer_table(l)
            widest = int(self.lib.hnsw_layer_max_row(self.h, l))
            if widest > t.width:
                t.grow_width(-(-widest // 8) * 8)
            ids = np.empty((n, t.width), np.int32)
            dd = np.empty((n, t.width), np.float32)
            self.lib.hnsw_export_layer_w(self.h, l, t.width, _ip32(ids), _fp(dd))
            t.ids[:n] = ids
            t.dists[:n] = dd
            t.counts[:n] = (ids >= 0).sum(1)
        h._nb_point = n
        h._entry = int(self.lib.hnsw_entry_point(self.h))
        h._version += 1
        return h
