"""The benchmark's in-memory object store, for the source and the target
buckets of the bulk cells.

It implements the port's ``ObjectStore`` interface over a dict. Production's
store is remote; a local disk would put the machine's disk into the rate.
A lock makes each operation atomic across the builder's decode threads and
its writer thread.

``keep(bucket, key)`` says which objects keep their bytes; the others keep
only their size. Held in the process, every feature file of a window (some
2 GB on the B0 cell) grew the run's memory and slowed each later source by
up to half (PERF.md); a remote store holds nothing in the client. The
output check reads back the objects that were kept, exactly as put.
"""

from __future__ import annotations

from collections.abc import Callable, Iterator
from threading import Lock

from mermaid_classifier_tpu_torch.data.store import ObjectStore, ObjectStoreError


class MemoryObjectStore(ObjectStore):
    def __init__(self, keep: Callable[[str, str], bool] | None = None) -> None:
        self._objects: dict[tuple[str, str], bytes | int] = {}
        self._keep = keep or (lambda bucket, key: True)
        self._lock = Lock()

    def exists(self, bucket: str, key: str) -> bool:
        with self._lock:
            return (bucket, key) in self._objects

    def size(self, bucket: str, key: str) -> int:
        with self._lock:
            obj = self._objects.get((bucket, key))
        if obj is None:
            raise ObjectStoreError(f"object not found: {bucket}/{key}")
        return obj if isinstance(obj, int) else len(obj)

    def get_bytes(self, bucket: str, key: str) -> bytes:
        with self._lock:
            obj = self._objects.get((bucket, key))
        if obj is None:
            raise ObjectStoreError(f"object not found: {bucket}/{key}")
        if isinstance(obj, int):
            raise ObjectStoreError(f"object not kept: {bucket}/{key}")
        return obj

    def put_bytes(self, bucket: str, key: str, data: bytes) -> None:
        obj = bytes(data) if self._keep(bucket, key) else len(data)
        with self._lock:
            self._objects[(bucket, key)] = obj

    def list_keys(self, bucket: str, prefix: str = "") -> Iterator[str]:
        with self._lock:
            keys = sorted(k for b, k in self._objects if b == bucket and k.startswith(prefix))
        yield from keys

    def delete(self, bucket: str, key: str) -> None:
        with self._lock:
            self._objects.pop((bucket, key), None)
