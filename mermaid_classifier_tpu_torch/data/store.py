"""Object-store abstraction: the data and coordination plane.

The port's own copy of ``mermaid_classifier_tpu/data/store.py`` (that module
imports no jax, but the port imports nothing of the JAX package). The store
sits behind one small interface with a local-filesystem backend, and keeps
the two disciplines that make the at-scale extraction resumable:

- writes are atomic (temp + rename) and idempotent at (bucket, key);
- the bucket listing is the source of truth for progress.

``get_default_store`` takes its root from ``settings.object_store_root``
only, as the JAX package does: ``OBJECT_STORE_ROOT`` in the environment or
a ``.env`` file when the settings are read (``reload_settings_from_env``
re-reads them), or ``override_settings``. An ``s3://`` root gives the
stdlib-HTTP S3 backend (``s3_store``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from collections.abc import Iterator
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path


class ObjectStoreError(RuntimeError):
    pass


class ObjectStore:
    """Interface. Keys are '/'-separated paths within a bucket."""

    def exists(self, bucket: str, key: str) -> bool:
        raise NotImplementedError

    def get_bytes(self, bucket: str, key: str) -> bytes:
        raise NotImplementedError

    def put_bytes(self, bucket: str, key: str, data: bytes) -> None:
        raise NotImplementedError

    def list_keys(self, bucket: str, prefix: str = "") -> Iterator[str]:
        raise NotImplementedError

    def delete(self, bucket: str, key: str) -> None:
        raise NotImplementedError

    def discard_partial_writes(self, bucket: str, prefix: str = "") -> int:
        """Remove what writes killed mid-way left under ``prefix``; returns
        how many. A store whose puts leave nothing behind has none."""
        return 0

    def download(self, bucket: str, key: str, local_path: str | Path) -> None:
        data = self.get_bytes(bucket, key)
        local_path = Path(local_path)
        local_path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=local_path.parent, suffix=".part")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, local_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def upload(self, local_path: str | Path, bucket: str, key: str) -> None:
        self.put_bytes(bucket, key, Path(local_path).read_bytes())


class LocalFSObjectStore(ObjectStore):
    """Buckets are directories under a root; objects are files."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, bucket: str, key: str) -> Path:
        path = (self.root / bucket / key).resolve()
        if not str(path).startswith(str((self.root / bucket).resolve())):
            raise ObjectStoreError(f"key escapes bucket: {key!r}")
        return path

    def exists(self, bucket: str, key: str) -> bool:
        return self._path(bucket, key).is_file()

    def get_bytes(self, bucket: str, key: str) -> bytes:
        path = self._path(bucket, key)
        try:
            return path.read_bytes()
        except FileNotFoundError:
            raise ObjectStoreError(f"object not found: {bucket}/{key}") from None

    def put_bytes(self, bucket: str, key: str, data: bytes) -> None:
        path = self._path(bucket, key)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".part")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def discard_partial_writes(self, bucket: str, prefix: str = "") -> int:
        """Unlink the ``.part`` temp files under ``prefix`` that a writer
        killed between its temp write and its rename left behind (a SIGKILL
        runs no cleanup). Only for a prefix no other process is writing."""
        root = self._path(bucket, prefix) if prefix else self.root / bucket
        if not root.is_dir():
            return 0
        stale = [p for p in root.rglob("*.part") if p.is_file()]
        for path in stale:
            path.unlink(missing_ok=True)
        return len(stale)

    def list_keys(self, bucket: str, prefix: str = "") -> Iterator[str]:
        bucket_root = self.root / bucket
        if not bucket_root.is_dir():
            return
        for dirpath, _dirnames, filenames in os.walk(bucket_root):
            for filename in sorted(filenames):
                if filename.endswith(".part"):
                    continue
                full = Path(dirpath) / filename
                key = str(full.relative_to(bucket_root)).replace(os.sep, "/")
                if key.startswith(prefix):
                    yield key

    def download(self, bucket: str, key: str, local_path: str | Path) -> None:
        """Local-store downloads hardlink instead of copying bytes.

        A hardlink is byte-identical and atomic (temp name + rename like
        every write here), and stays consistent: consumers treat downloaded
        files as immutable, and a later put_bytes to the same key replaces
        the store's inode, leaving the link holding the bytes it downloaded.
        Cross-filesystem targets fall back to the base byte copy.
        """
        src = self._path(bucket, key)
        if not src.is_file():
            raise ObjectStoreError(f"object not found: {bucket}/{key}")
        dst = Path(local_path)
        dst.parent.mkdir(parents=True, exist_ok=True)
        tmp = dst.parent / f".{dst.name}.{os.getpid()}.part"
        try:
            os.link(src, tmp)
            # The link aliases the store inode; dropping the write bits
            # turns an in-place write (which would corrupt the store object)
            # into a loud EACCES. put_bytes/delete still work: they replace
            # or unlink the directory entry, never write through the inode.
            os.chmod(tmp, 0o444)
            os.replace(tmp, dst)
        except OSError:
            if tmp.exists():
                tmp.unlink()
            super().download(bucket, key, local_path)

    def delete(self, bucket: str, key: str) -> None:
        path = self._path(bucket, key)
        if path.is_file():
            path.unlink()

    def copy_bucket_dir(self, bucket: str, src_prefix: str, dst_prefix: str) -> None:
        """Copy the tree under ``src_prefix`` to ``dst_prefix`` in the same
        bucket, merging into what ``dst_prefix`` already holds."""
        src = self.root / bucket / src_prefix
        dst = self.root / bucket / dst_prefix
        shutil.copytree(src, dst, dirs_exist_ok=True)


def get_default_store() -> ObjectStore:
    """The store at ``settings.object_store_root`` (``OBJECT_STORE_ROOT`` in
    the environment or ``.env`` when the settings were read, or
    ``override_settings``): an ``s3://`` root returns the stdlib-HTTP S3
    backend (endpoint, region and credentials from the environment, see
    ``s3_store.s3_store_from_settings_and_env``), anything else is a
    local-FS root."""
    from mermaid_classifier_tpu_torch.config.settings import settings

    root = settings.object_store_root
    if not root:
        raise ObjectStoreError(
            "settings.object_store_root is not set; configure OBJECT_STORE_ROOT"
            " or inject an ObjectStore explicitly."
        )
    if root.startswith("s3://"):
        from mermaid_classifier_tpu_torch.data.s3_store import (
            s3_store_from_settings_and_env,
        )

        return s3_store_from_settings_and_env()
    return LocalFSObjectStore(root)


def download_parallel(
    store: ObjectStore,
    jobs: dict[tuple[str, str], str],
    max_workers: int = 50,
    skip_existing: bool = True,
) -> set[tuple[str, str]]:
    """Download {(bucket, key): local_path} concurrently.

    Atomic per file (temp + rename inside ``download``), skips local files
    that already exist, returns the set of failed (bucket, key): callers
    drop those images and continue.
    """
    failed: set[tuple[str, str]] = set()

    def fetch(bucket_key: tuple[str, str], local_path: str) -> None:
        if skip_existing and os.path.isfile(local_path):
            return
        store.download(bucket_key[0], bucket_key[1], local_path)

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = {
            pool.submit(fetch, bucket_key, local): bucket_key
            for bucket_key, local in jobs.items()
        }
        for future in as_completed(futures):
            try:
                future.result()
            except Exception:  # noqa: BLE001 - per-file failures are collected
                failed.add(futures[future])
    return failed
