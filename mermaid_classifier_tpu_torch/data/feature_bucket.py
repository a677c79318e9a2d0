"""Feature-bucket builder: resumable, idempotent at-scale extraction.

Port of ``mermaid_classifier_tpu/data/feature_bucket.py``, around the
port's object store and ``FeatureExtractor``, without pandas:

- **The bucket is the source of truth for progress**: every write is
  idempotent at (source, image); with skip_existing (default) the target
  bucket is listed and done images are skipped, so a crashed or preempted
  worker resumes by running again.
- Per-image failures are caught, recorded to an append-only JSONL progress
  log and a CSV error log, and the run continues; the run result carries
  counters and the exit code reflects failures.
- Optional device-vs-CPU numerics self-check before any extraction (min
  cosine >= 0.999).

Input layout (source bucket), either of:
  ``s{source_id}/annotations.csv`` with columns image_id, image_key, row,
  col (image_key is the image object's key in the same bucket), and the
  image objects at their image_key;
OR the raw CoralNet-export layout: annotations.csv with ``Name``/``Row``/
``Column`` columns plus ``s{source_id}/image_list.csv`` (``Name`` with a
" - Confirmed|Unconfirmed|Unclassified" status suffix, ``Image Page``
"/image/<id>/view/") mapping names to numeric IDs; images live at
``s{source_id}/images/{image_id}.jpg``. Rows whose name has no mapping are
counted and dropped, never silently extracted.

The CSVs are read with the stdlib ``csv`` module and every value is kept as
the string read, as pandas does with ``keep_default_na=False`` for text
("NA" is a name). Where pandas would infer a numeric column, this reader
still keeps the string: an image_id "007" stays "007" (pandas: "7").

Output layout (target bucket):
  ``s{source_id}/features/i{image_id}.features.npz``
  ``s{source_id}/annotations.csv`` (copied once, idempotent).
"""

from __future__ import annotations

import csv
import io
import json
import queue
import re
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from logging import getLogger
from pathlib import Path
from threading import Lock, Thread

import numpy as np

from mermaid_classifier_tpu_torch.data.features_io import write_feature_file
from mermaid_classifier_tpu_torch.data.store import ObjectStore
from mermaid_classifier_tpu_torch.ops import fused_mbconv, patch_crop
from mermaid_classifier_tpu_torch.serve.image_sources import decode_image_bytes

logger = getLogger(__name__)

_FEATURE_KEY_RE = re.compile(r"^s(?P<source>[^/]+)/features/i(?P<image>.+)\.features\.npz$")

ANNOTATION_COLUMNS = ("image_id", "image_key", "row", "col")

# The raw CoralNet-export annotation shape.
CORALNET_ANNOTATION_COLUMNS = ("Name", "Row", "Column")
_STATUS_SUFFIX_RE = re.compile(
    r"\s+-\s+(?:Confirmed|Unconfirmed|Unclassified)\s*$"
)
_IMAGE_PAGE_ID_RE = re.compile(r"/image/(\d+)/")


def feature_key(source_id: str, image_id: str) -> str:
    return f"s{source_id}/features/i{image_id}.features.npz"


def annotations_key(source_id: str) -> str:
    return f"s{source_id}/annotations.csv"


@dataclass(frozen=True)
class Annotation:
    """One annotated point of the canonical layout."""

    image_id: str
    image_key: str
    row: int
    col: int


def _read_csv(raw: bytes) -> tuple[list[str], list[dict[str, str]]]:
    """(columns, rows) of a CSV, every value the string read; blank lines
    are skipped."""
    reader = csv.DictReader(io.StringIO(raw.decode("utf-8-sig"), newline=""))
    rows = list(reader)
    return list(reader.fieldnames or []), rows


def _to_int(value: str) -> int:
    """A CSV cell as pandas' ``astype(int)`` reads it: "12" and "12.0" are
    12, a fraction is truncated toward zero."""
    try:
        return int(value)
    except ValueError:
        return int(float(value))


def _strip_status(name: str) -> str:
    return _STATUS_SUFFIX_RE.sub("", name).strip()


@dataclass
class SourceResult:
    source_id: str
    images_total: int = 0
    images_done: int = 0
    images_skipped: int = 0
    images_failed: int = 0
    points_done: int = 0
    failures: list[tuple[str, str]] = field(default_factory=list)


@dataclass
class RunResult:
    sources: list[SourceResult] = field(default_factory=list)

    @property
    def images_failed(self) -> int:
        return sum(s.images_failed for s in self.sources)

    @property
    def exit_code(self) -> int:
        return 1 if self.images_failed else 0

    def describe(self) -> str:
        done = sum(s.images_done for s in self.sources)
        skipped = sum(s.images_skipped for s in self.sources)
        points = sum(s.points_done for s in self.sources)
        return (
            f"{len(self.sources)} sources: {done} images extracted"
            f" ({points} points), {skipped} skipped (already done),"
            f" {self.images_failed} failed."
        )


class FeatureBucketBuilder:
    """Drives extraction for a list of sources against source/target buckets.

    ``extractor`` is the port's ``FeatureExtractor`` (or anything with its
    ``extract_features_async`` and ``verify_device_numerics``)."""

    def __init__(
        self,
        store: ObjectStore,
        source_bucket: str,
        target_bucket: str,
        extractor,
        *,
        skip_existing: bool = True,
        progress_log: str | Path | None = None,
        error_log: str | Path | None = None,
        decode_image=None,
        decode_workers: int = 8,
        prefetch: int = 16,
        write_outputs: bool = True,
    ) -> None:
        self.store = store
        self.source_bucket = source_bucket
        self.target_bucket = target_bucket
        self.extractor = extractor
        self.skip_existing = skip_existing
        # False on every rank of a mesh but rank 0: the rank extracts its
        # share of every image and writes nothing (no features, no
        # annotations copy, no logs).
        self.write_outputs = bool(write_outputs)
        self.progress_log = (Path(progress_log) if progress_log and write_outputs
                             else None)
        self.error_log = Path(error_log) if error_log and write_outputs else None
        self._decode_image = decode_image or decode_image_bytes
        # Decode-ahead: fetch+decode of upcoming images overlaps the device
        # extraction of the current one; the in-flight window caps host
        # memory at about ``prefetch`` decoded images.
        self.decode_workers = max(1, int(decode_workers))
        self.prefetch = max(1, int(prefetch))

    # -- logs ---------------------------------------------------------------

    def _record_progress(self, record: dict) -> None:
        if self.progress_log is None:
            return
        self.progress_log.parent.mkdir(parents=True, exist_ok=True)
        with self.progress_log.open("a") as f:
            f.write(json.dumps({"time": time.time(), **record}) + "\n")

    def _record_failure(self, source_id: str, image_id: str, error: str) -> None:
        if self.error_log is None:
            return
        self.error_log.parent.mkdir(parents=True, exist_ok=True)
        new = not self.error_log.exists()
        with self.error_log.open("a", newline="") as f:
            writer = csv.writer(f)
            if new:
                writer.writerow(["time", "source_id", "image_id", "error"])
            writer.writerow([time.time(), source_id, image_id, error])

    # -- per-source pipeline ------------------------------------------------

    def read_annotations(self, source_id: str) -> list[Annotation]:
        """The source's annotated points in file order, from either layout."""
        raw = self.store.get_bytes(self.source_bucket, annotations_key(source_id))
        columns, rows = _read_csv(raw)
        if set(CORALNET_ANNOTATION_COLUMNS) <= set(columns) and not (
            set(ANNOTATION_COLUMNS) <= set(columns)
        ):
            return self._normalize_coralnet_annotations(source_id, rows)
        missing = set(ANNOTATION_COLUMNS) - set(columns)
        if missing:
            raise ValueError(
                f"source {source_id} annotations.csv missing columns"
                f" {sorted(missing)} (canonical layout) and it is not a"
                f" CoralNet export ({CORALNET_ANNOTATION_COLUMNS})"
            )
        return [
            Annotation(r["image_id"], r["image_key"], _to_int(r["row"]),
                       _to_int(r["col"]))
            for r in rows
        ]

    def _name_to_image_id(self, source_id: str) -> dict[str, str]:
        """{bare filename: numeric image id} from s{id}/image_list.csv: the
        CoralNet export keys annotations by Name while images land at
        numeric IDs; the status suffix (" - Confirmed" etc.) is stripped
        before keying."""
        key = f"s{source_id}/image_list.csv"
        try:
            raw = self.store.get_bytes(self.source_bucket, key)
        except Exception as exc:
            raise ValueError(
                f"source {source_id} annotations are CoralNet-export shaped"
                f" (Name/Row/Column) but {key} is unreadable: {exc}"
            ) from exc
        columns, rows = _read_csv(raw)
        if "Name" not in columns or "Image Page" not in columns:
            raise ValueError(
                f"{key} missing required columns Name/'Image Page';"
                f" got {columns}"
            )
        mapping: dict[str, str] = {}
        for r in rows:
            name = _strip_status(r["Name"] or "")
            match = _IMAGE_PAGE_ID_RE.search(r["Image Page"] or "")
            if not name or match is None:
                continue
            image_id = match.group(1)
            if name in mapping and mapping[name] != image_id:
                # Last-wins here would extract annotations from the wrong
                # image's pixels; refuse loudly instead.
                raise ValueError(
                    f"{key}: name {name!r} maps to both image"
                    f" {mapping[name]} and {image_id} after status-suffix"
                    " stripping — ambiguous mapping."
                )
            mapping[name] = image_id
        return mapping

    def _normalize_coralnet_annotations(
        self, source_id: str, rows: list[dict[str, str]]
    ) -> list[Annotation]:
        """Name/Row/Column rows -> canonical annotations, dropping (and
        counting) rows whose name has no image_list mapping."""
        mapping = self._name_to_image_id(source_id)
        out = []
        unmapped = 0
        for r in rows:
            image_id = mapping.get(_strip_status(r["Name"]))
            if image_id is None:
                unmapped += 1
                continue
            out.append(Annotation(
                image_id, f"s{source_id}/images/{image_id}.jpg",
                _to_int(r["Row"]), _to_int(r["Column"]),
            ))
        if unmapped:
            logger.warning(
                "source %s: %d annotation rows name images absent from"
                " image_list.csv — dropped",
                source_id, unmapped,
            )
        return out

    def upload_annotations_csv(self, source_id: str) -> None:
        """Copy the source's annotations.csv to the target bucket once;
        an idempotent skip when present."""
        key = annotations_key(source_id)
        if self.store.exists(self.target_bucket, key):
            return
        self.store.put_bytes(
            self.target_bucket, key, self.store.get_bytes(self.source_bucket, key)
        )

    def list_existing_feature_image_ids(self, source_id: str) -> set[str]:
        """Resume state from the target bucket's listing."""
        prefix = f"s{source_id}/features/"
        existing = set()
        for key in self.store.list_keys(self.target_bucket, prefix=prefix):
            m = _FEATURE_KEY_RE.match(key)
            if m and m.group("source") == str(source_id):
                existing.add(m.group("image"))
        return existing

    def process_source(self, source_id: str) -> SourceResult:
        source_id = str(source_id)
        result = SourceResult(source_id=source_id)
        annotations = self.read_annotations(source_id)
        if self.write_outputs:
            self.upload_annotations_csv(source_id)
            # A run killed mid-write left its temp file beside the features;
            # the image itself is not listed, so it is extracted again.
            discarded = self.store.discard_partial_writes(
                self.target_bucket, f"s{source_id}/features/")
            if discarded:
                logger.warning("source %s: discarded %d partial writes of a"
                               " killed run", source_id, discarded)

        existing = (
            self.list_existing_feature_image_ids(source_id)
            if self.skip_existing
            else set()
        )

        # Images in sorted id order, each image's points in file order.
        groups: dict[str, list[Annotation]] = {}
        for a in annotations:
            groups.setdefault(a.image_id, []).append(a)
        result.images_total = len(groups)
        todo = [
            (image_id, groups[image_id])
            for image_id in sorted(groups)
            if image_id not in existing
        ]
        result.images_skipped = result.images_total - len(todo)

        def fetch_decode(item):
            image_id, rows = item
            image_keys = {a.image_key for a in rows}
            if len(image_keys) != 1:
                raise ValueError(
                    f"image {image_id} maps to {len(image_keys)} distinct"
                    f" image_keys; expected exactly 1."
                )
            return self._decode_image(
                self.store.get_bytes(self.source_bucket, rows[0].image_key)
            )

        # Depth-1 device pipeline on top of decode-ahead: image i is
        # dispatched with its readback queued (no host sync), then a writer
        # thread waits for image i's readback alone and writes it while
        # image i+1 is dispatched. Counters and the append-only logs are
        # touched from both threads; one lock keeps the counter updates
        # and log appends atomic.
        result_lock = Lock()

        def record_failure(image_id: str, exc: Exception) -> None:
            with result_lock:
                result.images_failed += 1
                result.failures.append((image_id, str(exc)))
                try:
                    self._record_failure(source_id, image_id, str(exc))
                except Exception:  # noqa: BLE001 - the log is best-effort
                    logger.exception(
                        "failure-log write failed for image %s", image_id
                    )
            logger.warning(
                "source %s image %s failed: %s", source_id, image_id, exc
            )

        def finalize(pending) -> None:
            image_id, rowcols, readback, launched = pending
            try:
                features = readback.wait()
                n_points = (
                    self._write_features(source_id, image_id, rowcols, features)
                    if self.write_outputs else len(rowcols)
                )
            except Exception as exc:  # noqa: BLE001 - per-image isolation
                record_failure(image_id, exc)
                return
            with result_lock:
                result.images_done += 1
                result.points_done += n_points
                try:
                    self._record_progress(
                        {"source_id": source_id, "image_id": image_id,
                         "points": n_points}
                    )
                except Exception:  # noqa: BLE001
                    # The bucket (not the log) is the progress truth: the
                    # features are written, so a failing progress-log write
                    # (e.g. full disk) must neither mark the image failed
                    # nor escape into the writer loop.
                    logger.exception(
                        "progress-log write failed for image %s", image_id
                    )
            # The process's kernel launches as of this image's dispatch: a
            # process killed mid-run still leaves its count per written image.
            logger.info("image %s written (%d points); kernel launches so far:"
                        " crop %d, fused_mbconv %d", image_id, n_points, *launched)

        done_queue: queue.Queue = queue.Queue(maxsize=2)

        def writer() -> None:
            while True:
                pending = done_queue.get()
                if pending is None:
                    return
                try:
                    finalize(pending)
                except Exception as exc:  # noqa: BLE001 - writer must survive
                    # finalize isolates per-image write and log failures
                    # itself; this is the last line of defense. A dead
                    # writer would deadlock the bounded queue, so even a
                    # failing record_failure must not escape.
                    try:
                        record_failure(pending[0], exc)
                    except Exception:  # noqa: BLE001
                        logger.exception(
                            "failure bookkeeping failed for image %s",
                            pending[0],
                        )

        writer_thread = Thread(target=writer, daemon=True)
        writer_thread.start()
        try:
            with ThreadPoolExecutor(max_workers=self.decode_workers) as pool:
                in_flight: list = []
                cursor = 0
                while cursor < len(todo) or in_flight:
                    while cursor < len(todo) and len(in_flight) < self.prefetch:
                        item = todo[cursor]
                        in_flight.append((item, pool.submit(fetch_decode, item)))
                        cursor += 1
                    (image_id, rows), future = in_flight.pop(0)
                    try:
                        image = future.result()
                        rowcols = np.asarray(
                            [(a.row, a.col) for a in rows], dtype=np.int32
                        ).reshape(-1, 2)
                        readback = self.extractor.extract_features_async(
                            image, rowcols
                        )
                    except Exception as exc:  # noqa: BLE001 - per-image isolation
                        record_failure(image_id, exc)
                        continue
                    launched = (patch_crop.launches, fused_mbconv.launches)
                    done_queue.put((image_id, rowcols, readback, launched))
        finally:
            done_queue.put(None)
            writer_thread.join()
        return result

    def _write_features(
        self,
        source_id: str,
        image_id: str,
        rowcols: np.ndarray,
        features: np.ndarray,
    ) -> int:
        # Atomic write through a local temp file, then idempotent upload.
        with tempfile.TemporaryDirectory() as td:
            local = Path(td) / "f.npz"
            write_feature_file(local, rowcols, features)
            self.store.upload(
                local, self.target_bucket, feature_key(source_id, image_id)
            )
        return len(rowcols)

    def filter_to_available_sources(
        self, source_ids: list[str], *, max_io_workers: int = 16
    ) -> tuple[list[str], list[str]]:
        """Threaded probe of each source's annotations.csv in the source
        bucket; returns (available, missing)."""
        source_ids = [str(s) for s in source_ids]

        def probe(source_id: str) -> bool:
            return self.store.exists(
                self.source_bucket, annotations_key(source_id)
            )

        with ThreadPoolExecutor(max_workers=max_io_workers) as pool:
            flags = list(pool.map(probe, source_ids))
        available = [s for s, ok in zip(source_ids, flags) if ok]
        missing = [s for s, ok in zip(source_ids, flags) if not ok]
        if missing:
            logger.warning(
                "%d sources have no annotations.csv in %s and will be"
                " skipped: %s",
                len(missing),
                self.source_bucket,
                missing[:10],
            )
        return available, missing

    # -- run ----------------------------------------------------------------

    def run(self, source_ids: list[str], *, verify_numerics: bool = False) -> RunResult:
        if verify_numerics:
            worst = self.extractor.verify_device_numerics()
            logger.info("device numerics check passed: min cosine %.6f", worst)
        result = RunResult()
        for source_id in source_ids:
            logger.info("processing source %s", source_id)
            result.sources.append(self.process_source(str(source_id)))
        logger.info(result.describe())
        return result
