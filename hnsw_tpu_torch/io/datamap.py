"""Memory-mapped vector store — counterpart of ``hnsw_tpu/io/datamap.py``, the
analog of reference ``DataMap``
(``src/datamap.rs:24-319``).

A standalone zero-copy view over a ``.hnsw.data`` dump: validates the header, computes
the fixed record size ``4 + 2*8 + dim*itemsize`` (reference ``src/datamap.rs:157-159``),
indexes external id → record offset, and serves vectors without copying. Because every
record has the same size, the whole file doubles as one strided ``[N, dim]`` array
(``strided_view``), which is what the device upload path streams from. Host-side numpy only.
"""

from __future__ import annotations

import os
import struct

import numpy as np

MAGICDATAP = 0xA67F0000
_HDR = 4 + 8  # u32 magic + u64 dimension
_REC_HDR = 4 + 8 + 8  # u32 magic + u64 origin + u64 byte_len


class DataMap:
    def __init__(self, dirpath, basename: str, dtype=np.float32):
        self.path = os.path.join(str(dirpath), basename + ".hnsw.data")
        self.dtype = np.dtype(dtype)
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        magic, = struct.unpack_from("<I", self._mm, 0)
        if magic != MAGICDATAP:
            raise ValueError(f"bad data file magic 0x{magic:08x}")
        self.dimension, = struct.unpack_from("<Q", self._mm, 4)
        self.record_size = _REC_HDR + self.dimension * self.dtype.itemsize
        body = len(self._mm) - _HDR
        if self.dimension and body % self.record_size != 0:
            raise ValueError("data file size is not a whole number of records")
        self.nb_data = body // self.record_size if self.dimension else 0
        # id -> record ordinal (reference builds an IndexMap of offsets) —
        # vectorized: one strided view over the record headers instead of a
        # per-record struct.unpack loop (minutes at 1M points on one core)
        if self.nb_data:
            hdrs = np.asarray(self._mm[_HDR: _HDR + self.nb_data * self.record_size]
                              ).reshape(self.nb_data, self.record_size)
            magics = np.ascontiguousarray(hdrs[:, :4]).view("<u4").ravel()
            if (magics != MAGICDATAP).any():
                k = int(np.flatnonzero(magics != MAGICDATAP)[0])
                raise ValueError(f"bad record magic at record {k}")
            self._ids = np.ascontiguousarray(hdrs[:, 4:12]).view("<i8").ravel().copy()
        else:
            self._ids = np.zeros(0, np.int64)
        self._index = {int(i): k for k, i in enumerate(self._ids)}

    def get_nb_data(self) -> int:
        return self.nb_data

    def get_dimension(self) -> int:
        return int(self.dimension)

    def check_data_type(self, typename: str) -> bool:
        """Compare against a dump's short type name (reference
        ``src/datamap.rs:238-268``)."""
        from .hnswio import _RUST_TYPE
        return _RUST_TYPE.get(self.dtype.name, self.dtype.name) == typename

    def get_data(self, data_id: int):
        """Zero-copy vector for an external id (reference ``get_data``,
        ``src/datamap.rs:276-297``); None if absent."""
        k = self._index.get(int(data_id))
        if k is None:
            return None
        off = _HDR + k * self.record_size + _REC_HDR
        return np.frombuffer(self._mm, dtype=self.dtype, count=self.dimension, offset=off)

    def get_dataid_iter(self):
        """External ids in file order (reference ``get_dataid_iter``,
        ``src/datamap.rs:299-303``) — for streaming consumers."""
        return iter(self._ids.tolist())

    def ids(self) -> np.ndarray:
        return self._ids

    def lazy_data(self, perm: np.ndarray, cap: int, threshold: int = 0) -> "LazyMmapData":
        """A :class:`LazyMmapData` over this map: ``perm[i]`` is the file record
        ordinal serving internal index ``i``."""
        return LazyMmapData(self.strided_view(), perm, cap, self.dtype,
                            threshold=threshold)

    def strided_view(self) -> np.ndarray:
        """The whole file as a ``[N, dim]`` array in file order — zero-copy (a strided
        view over the mmap) whenever the record header is aligned for the dtype
        (f32/i32/u32/u16/u8); a materialized copy otherwise (f64)."""
        dim = int(self.dimension)
        if self.nb_data == 0:
            return np.zeros((0, dim), self.dtype)
        it = self.dtype.itemsize
        if _HDR % it == 0 and _REC_HDR % it == 0 and self.record_size % it == 0:
            per_rec = self.record_size // it
            arr = np.frombuffer(self._mm, dtype=self.dtype, offset=_HDR,
                                count=self.nb_data * per_rec).reshape(self.nb_data, per_rec)
            return arr[:, _REC_HDR // it: _REC_HDR // it + dim]
        out = np.empty((self.nb_data, dim), self.dtype)
        for k, i in enumerate(self._ids):
            out[k] = self.get_data(int(i))
        return out

class LazyMmapData:
    """ndarray-like vector store for mmap-backed reloads — the reference's partial
    residency policy (``src/hnswio.rs:675-692``, policy note ``Changes.md:36-37``):
    the bulk of the corpus stays on the memory map (the OS page cache decides actual
    residency), and only the last ``threshold`` dumped records — upper layers dump
    last, so they stay hot — plus any rows written after reload live in a RAM overlay.

    Supports every access pattern the engine uses on ``Hnsw._data``: int reads
    (zero-copy rows off the map), slice / fancy-index gathers (only the touched
    records are paged in), int row writes (post-reload inserts), and capacity growth.
    """

    def __init__(self, view: np.ndarray, perm: np.ndarray, cap: int, dtype,
                 threshold: int = 0):
        self.dtype = np.dtype(dtype)
        self._view = view  # [nrec, dim] strided over the mmap, file order
        self._dim = int(view.shape[1])
        n = len(perm)
        self._perm = np.full(max(int(cap), n), -1, np.int64)
        self._perm[:n] = perm
        self._overlay: dict[int, np.ndarray] = {}
        if threshold > 0:
            lo = max(0, view.shape[0] - int(threshold))
            for idx in np.flatnonzero(perm >= lo):
                self._overlay[int(idx)] = np.array(view[perm[idx]], self.dtype)

    @property
    def shape(self):
        return (self._perm.shape[0], self._dim)

    @property
    def ndim(self):
        return 2

    def __len__(self):
        return self._perm.shape[0]

    @property
    def resident_rows(self) -> int:
        """Rows materialized in RAM (threshold residents + post-reload writes)."""
        return len(self._overlay)

    def grow(self, new_cap: int):
        if new_cap <= self._perm.shape[0]:
            return
        pad = np.full(new_cap - self._perm.shape[0], -1, np.int64)
        self._perm = np.concatenate([self._perm, pad])

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self._perm.shape[0])
            if step == 1:
                p = self._perm[start:stop]
                out = np.zeros((stop - start, self._dim), self.dtype)
                ok = p >= 0
                out[ok] = self._view[p[ok]]
                for i, row in self._overlay.items():
                    if start <= i < stop:
                        out[i - start] = row
                return out
            key = np.arange(start, stop, step)
        idxs = np.asarray(key)
        if idxs.ndim == 0:
            i = int(idxs)
            if i < 0:
                i += self._perm.shape[0]
            row = self._overlay.get(i)
            if row is not None:
                return row
            p = int(self._perm[i])
            if p < 0:
                return np.zeros(self._dim, self.dtype)
            return self._view[p]
        # N-D fancy indexing: gather flat, then restore the index shape + dim
        shape = idxs.shape
        idxs = idxs.astype(np.int64).ravel()
        p = self._perm[idxs]
        out = np.zeros((len(idxs), self._dim), self.dtype)
        ok = p >= 0
        out[ok] = self._view[p[ok]]
        if self._overlay:
            for j, i in enumerate(idxs):
                row = self._overlay.get(int(i))
                if row is not None:
                    out[j] = row
        return out.reshape(shape + (self._dim,))

    def __setitem__(self, key, value):
        # slice keys FIRST: np.asarray(slice) is a 0-d object array, so the
        # scalar branch would int() a slice and crash (hit by the bulk-array
        # ingest path writing hnsw._data[n0:n0+npts] = X after an mmap reload)
        if isinstance(key, slice):
            key = np.arange(*key.indices(self._perm.shape[0]))
        idxs = np.asarray(key)
        if idxs.ndim == 0:
            i = int(idxs)
            if i < 0:
                i += self._perm.shape[0]
            self._overlay[i] = np.array(value, self.dtype).reshape(self._dim)
            return
        idxs = idxs.astype(np.int64).ravel()
        rows = np.broadcast_to(np.asarray(value, self.dtype),
                               (len(idxs), self._dim))
        for j, i in enumerate(idxs):
            self._overlay[int(i)] = np.array(rows[j])

    def __array__(self, dtype=None, copy=None):
        out = self[0:self._perm.shape[0]]
        return out.astype(dtype) if dtype is not None else out
