"""Language-neutral facade — counterpart of ``hnsw_tpu/api.py``, the analog of
the reference's ``AnnT`` trait (``src/api.rs:13-38``): the object-safe
capability surface (insert / search / parallel variants / file_dump) that any
embedding talks to. ``Hnsw`` implements the methods; this class formalizes the
contract (reference ``src/api.rs:40-94``)."""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable


@runtime_checkable
class AnnT(Protocol):
    def insert(self, data, origin_id=None): ...

    def parallel_insert(self, data_with_ids: Sequence, mode: str = "auto",
                        batch_size=None): ...

    def search(self, data, knbn: int, ef_arg: int): ...

    def parallel_search(self, queries, knbn: int, ef: int, filter=None,
                        mode: str = "auto"): ...

    def file_dump(self, path, basename: str) -> str: ...
