"""Packed feature cache: one flat float32 matrix + JSON index, with a C++
multi-threaded row gather behind ctypes.

The port's own copy of ``mermaid_classifier_tpu/native/fastbatch.py``, with
the same on-disk layout, so a cache packed by either package reads in the
other. A streamed training epoch otherwise opens every image's feature file
per batch; packed once into ``features.bin`` (rows x dim float32,
row-major) and ``index.json`` ({image_id: [start, count], labels: [...]}),
every batch is a row gather: a threaded memcpy in C++ (``fastbatch.cpp``),
or numpy fancy-indexing over a memmap (``use_native=False``, or when the
library is missing). Both return the same bytes.

The library is built by ``g++ -O3 -shared -fPIC -pthread`` at first use
(never at import) into the gitignored ``mermaid_classifier_tpu_torch/_build/``,
named by the sha256 of the source and renamed into place atomically. A
failed build logs a warning and leaves the numpy gather.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import tempfile
from logging import getLogger
from pathlib import Path

import numpy as np

logger = getLogger(__name__)

_SRC = Path(__file__).with_name("fastbatch.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

DATA_FILE = "features.bin"
INDEX_FILE = "index.json"


# -- native library lifecycle ------------------------------------------------

_lib: ctypes.CDLL | None = None
_lib_failed = False


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libfastbatch-{digest}.so"


def ensure_built() -> Path | None:
    """Compile fastbatch.cpp if its cached .so is missing; returns the lib
    path or None when no toolchain is available."""
    lib = _lib_path()
    if lib.is_file():
        return lib
    _BUILD_DIR.mkdir(exist_ok=True)
    # Compile to a private temp name, then atomically rename: concurrent
    # builds (parallel jobs on a fresh checkout) never dlopen a
    # half-written .so.
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.part")
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-pthread",
        "-o", str(tmp), str(_SRC),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, lib)
    except (OSError, subprocess.CalledProcessError) as exc:
        detail = getattr(exc, "stderr", "") or str(exc)
        logger.warning(
            "fastbatch native build failed (%s); using the numpy fallback",
            detail.strip()[:500],
        )
        if tmp.exists():
            tmp.unlink()
        return None
    return lib


def _load_lib() -> ctypes.CDLL | None:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    path = ensure_built()
    if path is None:
        _lib_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        logger.warning(
            "fastbatch library %s failed to load (%s); using the numpy"
            " fallback",
            path,
            exc,
        )
        _lib_failed = True
        return None
    lib.fc_open.restype = ctypes.c_void_p
    lib.fc_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
    lib.fc_close.argtypes = [ctypes.c_void_p]
    lib.fc_rows.restype = ctypes.c_int64
    lib.fc_rows.argtypes = [ctypes.c_void_p]
    lib.fc_dim.restype = ctypes.c_int64
    lib.fc_dim.argtypes = [ctypes.c_void_p]
    lib.fc_gather.restype = ctypes.c_int
    lib.fc_gather.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load_lib() is not None


# -- writer ------------------------------------------------------------------


class PackedFeatureCacheWriter:
    """Stream-append per-image features into a packed cache directory."""

    def __init__(self, cache_dir: str | Path, dim: int) -> None:
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.dim = int(dim)
        self._rows = 0
        self._images: dict[str, list[int]] = {}
        self._labels: list[str] = []
        self._tmp = tempfile.NamedTemporaryFile(
            dir=self.cache_dir, suffix=".part", delete=False
        )

    def add_image(
        self, image_id: str, features: np.ndarray, labels: list[str]
    ) -> None:
        features = np.ascontiguousarray(features, dtype=np.float32)
        if features.ndim != 2 or features.shape[1] != self.dim:
            raise ValueError(
                f"features must be (P, {self.dim}), got {features.shape}"
            )
        if len(labels) != features.shape[0]:
            raise ValueError(
                f"{len(labels)} labels for {features.shape[0]} feature rows"
            )
        if image_id in self._images:
            raise ValueError(f"image {image_id!r} already added")
        self._images[image_id] = [self._rows, features.shape[0]]
        self._labels.extend(str(label) for label in labels)
        self._tmp.write(features.tobytes())
        self._rows += features.shape[0]

    def finalize(self) -> "PackedFeatureCache":
        self._tmp.flush()
        self._tmp.close()
        os.replace(self._tmp.name, self.cache_dir / DATA_FILE)
        index = {
            "dim": self.dim,
            "rows": self._rows,
            "images": self._images,
            "labels": self._labels,
        }
        index_tmp = self.cache_dir / (INDEX_FILE + ".part")
        index_tmp.write_text(json.dumps(index))
        os.replace(index_tmp, self.cache_dir / INDEX_FILE)
        return PackedFeatureCache(self.cache_dir)

    def abort(self) -> None:
        self._tmp.close()
        if os.path.exists(self._tmp.name):
            os.unlink(self._tmp.name)


def pack_feature_files(
    cache_dir: str | Path,
    items: list[tuple[str, str | Path, list[str]]],
    dim: int,
) -> "PackedFeatureCache":
    """Pack (image_id, feature_npz_path, labels) items into a cache.
    Labels are per-point, ordered like the npz rows."""
    from mermaid_classifier_tpu_torch.data.features_io import read_feature_file

    writer = PackedFeatureCacheWriter(cache_dir, dim)
    try:
        for image_id, path, labels in items:
            _, features = read_feature_file(path)
            writer.add_image(image_id, features, labels)
    except BaseException:
        writer.abort()
        raise
    return writer.finalize()


# -- reader ------------------------------------------------------------------


class PackedFeatureCache:
    """Reader with native (C++ threaded) or numpy-memmap gather."""

    def __init__(self, cache_dir: str | Path, *, use_native: bool | None = None):
        self.cache_dir = Path(cache_dir)
        index = json.loads((self.cache_dir / INDEX_FILE).read_text())
        self.dim = int(index["dim"])
        self.rows = int(index["rows"])
        self.images: dict[str, tuple[int, int]] = {
            k: (int(v[0]), int(v[1])) for k, v in index["images"].items()
        }
        self.labels = np.asarray(index["labels"], dtype=object)
        self._data_path = self.cache_dir / DATA_FILE
        expected = self.rows * self.dim * 4
        actual = self._data_path.stat().st_size
        if actual < expected:
            raise ValueError(
                f"{self._data_path} holds {actual} bytes but the index"
                f" declares {expected}."
            )
        self._handle = None
        self._memmap = None
        if use_native is None:
            use_native = native_available()
        self.use_native = bool(use_native)
        if self.use_native:
            lib = _load_lib()
            if lib is None:
                self.use_native = False
            else:
                self._handle = lib.fc_open(
                    str(self._data_path).encode(), self.rows, self.dim
                )
                if not self._handle:
                    logger.warning(
                        "fc_open failed for %s; using numpy fallback",
                        self._data_path,
                    )
                    self.use_native = False
        if not self.use_native:
            self._memmap = np.memmap(
                self._data_path, dtype=np.float32, mode="r",
                shape=(self.rows, self.dim),
            )

    # gather --------------------------------------------------------------

    def gather(
        self, indices: np.ndarray, *, n_threads: int | None = None
    ) -> np.ndarray:
        """Rows at ``indices`` as a fresh (n, dim) float32 array."""
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        if indices.ndim != 1:
            raise ValueError(f"indices must be 1-D, got {indices.shape}")
        n = indices.shape[0]
        out = np.empty((n, self.dim), dtype=np.float32)
        if n == 0:
            return out
        if self.use_native:
            lib = _load_lib()
            if n_threads is None:
                n_threads = min(8, os.cpu_count() or 1)
            rc = lib.fc_gather(
                self._handle,
                indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                n,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                int(n_threads),
            )
            if rc != 0:
                if rc > 0:
                    raise IndexError(
                        f"index {indices[rc - 1]} out of range"
                        f" [0, {self.rows})"
                    )
                raise RuntimeError(f"fc_gather failed with code {rc}")
            return out
        if (indices < 0).any() or (indices >= self.rows).any():
            bad = indices[(indices < 0) | (indices >= self.rows)][0]
            raise IndexError(f"index {bad} out of range [0, {self.rows})")
        np.take(self._memmap, indices, axis=0, out=out)
        return out

    def image_rows(self, image_id: str) -> np.ndarray:
        start, count = self.images[image_id]
        return np.arange(start, start + count, dtype=np.int64)

    def labels_at(self, indices: np.ndarray) -> list[str]:
        return [str(v) for v in self.labels[np.asarray(indices, dtype=np.int64)]]

    def close(self) -> None:
        if self._handle:
            _load_lib().fc_close(self._handle)
            self._handle = None
        self._memmap = None

    def __enter__(self) -> "PackedFeatureCache":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
