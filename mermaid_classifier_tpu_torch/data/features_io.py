"""Per-image feature-vector file IO: the port's own copy of
``mermaid_classifier_tpu/data/features_io.py`` (that module imports no jax,
but the port imports nothing of the JAX package).

One compact npz per image:

- ``rowcols``  — (P, 2) int32, the annotated (row, col) point centers;
- ``features`` — (P, D) float32, one feature vector per point.

Written atomically (tmp + rename) so interrupted extraction runs never leave
half files. A tolerant reader for the legacy JSON featurevector layout is
kept for migration fixtures.
"""

from __future__ import annotations

import ast
import json
import mmap
import os
import struct
import tempfile
import zipfile
from pathlib import Path

import numpy as np

FEATURE_FILE_SUFFIX = ".features.npz"


def write_feature_file(
    path: str | Path, rowcols: np.ndarray, features: np.ndarray
) -> None:
    """Atomically write one image's point features."""
    rowcols = np.asarray(rowcols, dtype=np.int32)
    features = np.asarray(features, dtype=np.float32)
    if rowcols.ndim != 2 or rowcols.shape[1] != 2:
        raise ValueError(f"rowcols must be (P, 2), got {rowcols.shape}")
    if features.ndim != 2 or features.shape[0] != rowcols.shape[0]:
        raise ValueError(
            f"features must be (P, D) matching rowcols; got {features.shape}"
            f" vs {rowcols.shape}"
        )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".part")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, rowcols=rowcols, features=features)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def read_feature_file(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Read (rowcols (P,2) int32, features (P,D) float32); pickle-free."""
    with np.load(path, allow_pickle=False) as archive:
        return (
            np.asarray(archive["rowcols"], dtype=np.int32),
            np.asarray(archive["features"], dtype=np.float32),
        )


def _mapped_npz_member(path: Path, zf: zipfile.ZipFile, name: str):
    """Memory-map one STORED (uncompressed) ``.npy`` member of an npz.

    ``np.savez`` writes members uncompressed, so the array bytes sit
    verbatim inside the zip; mapping them avoids the member copy, the CRC
    pass, and — on a host short of memory — the
    fresh-page allocation that ``zipfile`` pays for every read. Returns a
    read-only view backed by the page cache, or None when the member needs
    the eager path (compressed, Fortran-ordered, zero-size, or any header
    anomaly — correctness never depends on the fast path).
    """
    try:
        info = zf.getinfo(name)
        if info.compress_type != zipfile.ZIP_STORED:
            return None
        raw = zf.fp
        raw.seek(info.header_offset)
        local = raw.read(30)
        if len(local) != 30 or local[:4] != b"PK\x03\x04":
            return None
        name_len, extra_len = struct.unpack("<HH", local[26:30])
        npy_start = info.header_offset + 30 + name_len + extra_len
        raw.seek(npy_start)
        magic = raw.read(8)
        if magic[:6] != b"\x93NUMPY":
            return None
        major = magic[6]
        if major == 1:
            (hlen,) = struct.unpack("<H", raw.read(2))
            data_off = npy_start + 10 + hlen
        elif major in (2, 3):
            (hlen,) = struct.unpack("<I", raw.read(4))
            data_off = npy_start + 12 + hlen
        else:
            return None
        header = ast.literal_eval(raw.read(hlen).decode("latin1"))
        if header.get("fortran_order"):
            return None
        shape = tuple(int(s) for s in header["shape"])
        dtype = np.dtype(header["descr"])
        n_items = int(np.prod(shape)) if shape else 1
        if n_items == 0:
            return np.empty(shape, dtype=dtype)
        if data_off + n_items * dtype.itemsize > npy_start + info.file_size:
            return None
        mapped = np.memmap(
            path, dtype=dtype, mode="r", offset=data_off, shape=shape
        )
        if hasattr(mmap, "MADV_WILLNEED"):
            try:
                # Cold-cache reads: ask the kernel to prefetch the region
                # asynchronously so the later gather memcpy hits warm pages
                # instead of faulting page by page.
                mapped._mmap.madvise(mmap.MADV_WILLNEED)
            except (AttributeError, ValueError, OSError):
                pass
        return mapped
    except (
        OSError, ValueError, KeyError, SyntaxError, struct.error,
        # Truncated/malformed members: magic shorter than 8 bytes
        # (IndexError on magic[6]), a header that parses to a non-dict
        # (AttributeError on .get), or non-literal header contents
        # (TypeError from literal_eval) — all must fall back, never leak.
        IndexError, AttributeError, TypeError,
    ):
        return None


def read_feature_file_mapped(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """``read_feature_file`` with the features member memory-mapped.

    The returned ``features`` array is a read-only view over the file's
    bytes (no copy, no CRC pass, no fresh host pages) whenever the npz
    member is stored uncompressed — the bulk-fill path
    (``ImageLabels.load_into``) gathers straight from the page cache into
    the destination buffer. Falls back to the eager reader member-by-member
    on any irregularity, so results are always identical to
    ``read_feature_file`` (differential-tested)."""
    path = Path(path)
    with zipfile.ZipFile(path) as zf:
        rowcols = _mapped_npz_member(path, zf, "rowcols.npy")
        features = _mapped_npz_member(path, zf, "features.npy")
    if rowcols is None or features is None or (
        rowcols.ndim != 2 or rowcols.shape[1] != 2 or rowcols.dtype != np.int32
        or features.ndim != 2 or features.dtype != np.float32
        or features.shape[0] != rowcols.shape[0]
    ):
        return read_feature_file(path)
    return rowcols, features


def read_legacy_featurevector_json(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Read a pyspacer-style JSON featurevector file: a dict with
    ``point_features`` entries carrying row/col/data per point."""
    payload = json.loads(Path(path).read_text())
    points = payload["point_features"] if isinstance(payload, dict) else payload
    rowcols = np.asarray(
        [(int(p["row"]), int(p["col"])) for p in points], dtype=np.int32
    )
    features = np.asarray([p["data"] for p in points], dtype=np.float32)
    return rowcols, features


def select_point_rows(
    rowcols: np.ndarray,
    wanted_rowcols: list[tuple[int, int]],
) -> np.ndarray | None:
    """Vectorized row indices selecting ``wanted_rowcols`` from ``rowcols``.

    Returns None when the wanted points are exactly the stored points in
    stored order — the extraction-aligned common case, where the caller can
    consume the feature rows as-is with no gather at all. Raises KeyError
    on a point missing from the file (a silent skip would misalign features
    and labels). A duplicated stored point resolves to its LAST occurrence,
    the semantics of the dict index this replaces.
    """
    stored = np.asarray(rowcols, dtype=np.int64).reshape(-1, 2)
    want = np.asarray(wanted_rowcols, dtype=np.int64).reshape(-1, 2)
    # (row, col) int32 pairs pack bijectively into one int64 key.
    skey = (stored[:, 0] << 32) | (stored[:, 1] & 0xFFFFFFFF)
    order = np.argsort(skey, kind="stable")
    sorted_keys = skey[order]
    if want.shape == stored.shape and np.array_equal(want, stored):
        # Exact match in stored order — but only when every stored point
        # is unique: with a duplicated point the dict-last semantics pick
        # the LAST occurrence for every lookup, which identity would not
        # reproduce; fall through to the general path for those.
        if stored.shape[0] < 2 or (sorted_keys[1:] != sorted_keys[:-1]).all():
            return None
    if want.shape[0] == 0:
        return np.empty(0, dtype=np.intp)
    wkey = (want[:, 0] << 32) | (want[:, 1] & 0xFFFFFFFF)
    # side="right" - 1 lands on the last stable-sorted duplicate.
    pos = np.searchsorted(sorted_keys, wkey, side="right") - 1
    missing = (pos < 0) | (sorted_keys[np.maximum(pos, 0)] != wkey)
    if missing.any():
        i = int(np.argmax(missing))
        raise KeyError(
            f"point {(int(want[i, 0]), int(want[i, 1]))} not present in"
            f" feature file (has {stored.shape[0]} points)."
        )
    return order[pos]


def select_point_features(
    rowcols: np.ndarray,
    features: np.ndarray,
    wanted_rowcols: list[tuple[int, int]],
) -> np.ndarray:
    """Select feature rows for specific (row, col) points, in the wanted
    order. Raises KeyError on a point missing from the file — a silent skip
    would misalign features and labels. Always returns an owned copy."""
    rows = select_point_rows(rowcols, wanted_rowcols)
    features = np.asarray(features)
    return features.copy() if rows is None else features[rows]
