"""Point-label containers and the train/ref/val split: the port's own copy
of ``mermaid_classifier_tpu/data/labels.py``.

The contracts kept:

- labels are (row, col, label) points grouped per image feature file;
- ``load_data_in_batches(batch_size, random_seed)`` streams (X, y) batches
  from disk, so train/ref/val are never in memory at once;
- ``iter_index_batches`` is its index twin: the same image order, batch
  boundaries and label order, yielding row indices into the canonical layout
  (sorted image keys, annotation order) that ``load_into`` fills — the
  trainer's resident and streamed epochs depend on that contract;
- the split is per point and stratified per class, with a deterministic,
  seed-independent assignment, and every class keeps at least one training
  point when it has any.

``load_into`` also fills a CPU ``torch.bfloat16`` tensor: the card's Python
has no ``ml_dtypes``, so the trainer stages bf16 rows there (the cast is
round-to-nearest-even, the bits of ``jnp.asarray(x, jnp.bfloat16)``).

Batches come from the per-image feature files, or, after
``build_packed_cache``, from row gathers of a packed feature cache
(``native/fastbatch.py``): one threaded memcpy per image in place of a file
open. Both give the same bytes.
"""

from __future__ import annotations

import enum
import threading
from collections.abc import Iterator
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from mermaid_classifier_tpu_torch.data.features_io import (
    read_feature_file_mapped,
    select_point_features,
    select_point_rows,
)

Annotation = tuple[int, int, str]  # (row, col, label)


class SplitMode(enum.Enum):
    POINTS_STRATIFIED = "points_stratified"


@dataclass
class ImageLabels:
    """Annotations grouped per image, keyed by the image's feature-file path."""

    data: dict[str, list[Annotation]] = field(default_factory=dict)
    # The packed feature cache batches are gathered from, once
    # ``build_packed_cache`` has attached one.
    packed_cache: Any = field(default=None, repr=False, compare=False)

    def add_image(self, feature_path: str, annotations: list[Annotation]) -> None:
        if feature_path in self.data:
            raise ValueError(f"image {feature_path!r} already added.")
        self.data[feature_path] = list(annotations)

    def __len__(self) -> int:
        return len(self.data)

    @property
    def image_keys(self) -> list[str]:
        return list(self.data.keys())

    @property
    def label_count(self) -> int:
        return sum(len(anns) for anns in self.data.values())

    @property
    def classes_set(self) -> set[str]:
        return {label for anns in self.data.values() for _, _, label in anns}

    @property
    def label_count_per_class(self) -> dict[str, int]:
        """Per-class point counts (the runner's class-weighting input)."""
        counts: dict[str, int] = {}
        for anns in self.data.values():
            for _, _, label in anns:
                counts[label] = counts.get(label, 0) + 1
        return counts

    def annotation_items(self) -> Iterator[tuple[str, int, int, str]]:
        """Yield (feature_path, row, col, label) in deterministic order:
        sorted image key, then stored point order."""
        for key in sorted(self.data.keys()):
            for row, col, label in self.data[key]:
                yield key, row, col, label

    def load_image_data(self, feature_path: str) -> tuple[np.ndarray, list[str]]:
        """Load this image's (features, labels) from its feature file,
        aligned to the annotation order."""
        annotations = self.data[feature_path]
        if self.packed_cache is not None:
            rows = self.packed_cache.image_rows(feature_path)
            return (
                self.packed_cache.gather(rows),
                [label for _, _, label in annotations],
            )
        rowcols, features = read_feature_file_mapped(feature_path)
        x = select_point_features(
            rowcols, features, [(r, c) for r, c, _ in annotations]
        )
        return x, [label for _, _, label in annotations]

    def build_packed_cache(self, cache_dir: str | Path):
        """Pack every image's aligned point features into a packed cache at
        ``cache_dir`` and attach it, so later batches are row gathers.
        Returns the cache. Each image's rows are in annotation order, so the
        batches equal the file-backed ones."""
        from mermaid_classifier_tpu_torch.native.fastbatch import (
            PackedFeatureCacheWriter,
        )

        keys = sorted(self.data.keys())
        if not keys:
            raise ValueError("no images to pack")
        first_x, _ = self.load_image_data(keys[0])
        writer = PackedFeatureCacheWriter(cache_dir, dim=first_x.shape[1])
        try:
            for key in keys:
                x, y = self.load_image_data(key)
                writer.add_image(key, x, y)
        except BaseException:
            writer.abort()
            raise
        cache = writer.finalize()
        self.packed_cache = cache
        return cache

    def load_data_in_batches(
        self,
        batch_size: int,
        random_seed: int | None = None,
    ) -> Iterator[tuple[np.ndarray, list[str]]]:
        """Stream (X, y) batches of about ``batch_size`` points from disk.

        Image order is sorted-key deterministic, shuffled per
        ``random_seed`` when given (the trainer passes the epoch index, so
        every epoch sees another order, reproducibly). A batch closes at the
        first image that brings it to ``batch_size`` points or more. Memory
        stays O(batch_size), never O(dataset).
        """
        keys = sorted(self.data.keys())
        if random_seed is not None:
            rng = np.random.default_rng(int(random_seed))
            rng.shuffle(keys)

        batch_x: list[np.ndarray] = []
        batch_y: list[str] = []
        count = 0
        for key in keys:
            x, y = self.load_image_data(key)
            batch_x.append(x)
            batch_y.extend(y)
            count += len(y)
            if count >= batch_size:
                yield np.vstack(batch_x), batch_y
                batch_x, batch_y, count = [], [], 0
        if count:
            yield np.vstack(batch_x), batch_y

    def load_all(self) -> tuple[np.ndarray, list[str]]:
        """Everything in one array (tests and small sets)."""
        xs, ys = [], []
        for key in sorted(self.data.keys()):
            x, y = self.load_image_data(key)
            xs.append(x)
            ys.extend(y)
        return np.vstack(xs), ys

    def load_into(
        self,
        out: np.ndarray | torch.Tensor,
        offset: int = 0,
        max_workers: int | None = None,
        row_transform=None,
        on_rows_filled=None,
    ) -> None:
        """Load every image's aligned point features directly into
        ``out[offset : offset + label_count]`` in canonical row order
        (sorted image keys, annotation order — the order of ``load_all``
        and ``row_ranges``), reading feature files in parallel when
        ``max_workers`` > 1.

        The caller owns ``out`` (one preallocated buffer spanning all three
        splits for the resident upload), so peak host memory is the buffer
        alone. Feature files are memory-mapped, so the bytes move page cache
        → buffer in one gather. ``out`` is a numpy array, or a CPU torch
        tensor of a reduced storage dtype (``torch.bfloat16``): the row
        assignment casts, round to nearest even.

        ``row_transform(x, out_rows, buffer_row)``, when given, writes each
        image's f32 rows into its (disjoint) ``out`` slice itself — int8
        quantization inline with the parallel reads — and ``buffer_row`` is
        the slice's absolute row in ``out`` (for the per-row scale vector).

        ``on_rows_filled(buffer_row, n)``, when given, is called after an
        image's ``n`` rows are written at absolute row ``buffer_row``: the
        fill-progress signal the pipelined upload streams behind. Called
        from worker threads; it must be thread-safe."""
        ranges = self.row_ranges()
        keys = sorted(self.data.keys())
        total = self.label_count
        if out.ndim != 2 or out.shape[0] < offset + total:
            raise ValueError(
                f"out{tuple(out.shape)} cannot hold {total} rows at offset"
                f" {offset}."
            )
        to_tensor = isinstance(out, torch.Tensor)
        scratch_local = threading.local()

        def scratch_rows(n: int, dim: int) -> np.ndarray:
            buf = getattr(scratch_local, "buf", None)
            if buf is None or buf.shape[0] < n or buf.shape[1] != dim:
                buf = np.empty((n, dim), dtype=np.float32)
                scratch_local.buf = buf
            return buf[:n]

        def one(key: str) -> None:
            start, n = ranges[key]
            dest = out[offset + start: offset + start + n]
            if self.packed_cache is not None:
                # The gather returns a fresh writable array of the rows.
                rows = None
                features = self.packed_cache.gather(
                    self.packed_cache.image_rows(key))
            else:
                rowcols, features = read_feature_file_mapped(key)
                rows = select_point_rows(
                    rowcols, [(r, c) for r, c, _ in self.data[key]]
                )
            if (rows is not None and row_transform is None and not to_tensor
                    and dest.dtype == features.dtype):
                # Gather straight into the destination rows: the only pass
                # the feature bytes make.
                np.take(features, rows, axis=0, out=dest)
            else:
                if rows is not None:
                    x = np.take(features, rows, axis=0,
                                out=scratch_rows(n, features.shape[1]))
                elif to_tensor and row_transform is None:
                    # torch reads only writable arrays; the mapping is not.
                    x = scratch_rows(n, features.shape[1])
                    x[...] = features
                else:
                    x = features
                if row_transform is not None:
                    row_transform(x, dest, offset + start)
                elif to_tensor:
                    dest.copy_(torch.from_numpy(x))
                else:
                    dest[:] = x
            if on_rows_filled is not None:
                on_rows_filled(offset + start, n)

        if max_workers and max_workers > 1 and len(keys) > 1:
            with ThreadPoolExecutor(max_workers=max_workers) as pool:
                # list() drains the iterator so worker exceptions propagate.
                list(pool.map(one, keys))
        else:
            for key in keys:
                one(key)

    def row_ranges(self) -> dict[str, tuple[int, int]]:
        """{key: (offset, count)} into the canonical row layout: sorted image
        keys, each image's rows in annotation order (the row order of
        ``load_all``, so indices from ``iter_index_batches`` address it)."""
        ranges: dict[str, tuple[int, int]] = {}
        offset = 0
        for key in sorted(self.data.keys()):
            count = len(self.data[key])
            ranges[key] = (offset, count)
            offset += count
        return ranges

    def iter_index_batches(
        self,
        batch_size: int,
        random_seed: int | None = None,
    ) -> Iterator[tuple[np.ndarray, list[str]]]:
        """The index twin of ``load_data_in_batches``: the same image order,
        batch boundaries and label sequence, yielding each batch's int32 row
        indices into the canonical layout instead of its feature rows — for
        device-resident training, where the rows never visit the host
        (``MLPClassifier.partial_fit_resident``)."""
        ranges = self.row_ranges()
        keys = sorted(self.data.keys())
        if random_seed is not None:
            rng = np.random.default_rng(int(random_seed))
            rng.shuffle(keys)

        batch_idx: list[np.ndarray] = []
        batch_y: list[str] = []
        count = 0
        for key in keys:
            offset, n = ranges[key]
            batch_idx.append(np.arange(offset, offset + n, dtype=np.int32))
            batch_y.extend(label for _, _, label in self.data[key])
            count += n
            if count >= batch_size:
                yield np.concatenate(batch_idx), batch_y
                batch_idx, batch_y, count = [], [], 0
        if count:
            yield np.concatenate(batch_idx), batch_y


@dataclass
class TrainingTaskLabels:
    """The train/ref/val triple."""

    train: ImageLabels
    ref: ImageLabels
    val: ImageLabels

    @property
    def label_count(self) -> int:
        return self.train.label_count + self.ref.label_count + self.val.label_count


def preprocess_labels(
    labels: ImageLabels,
    split_ratios: tuple[float, float] = (0.1, 0.1),
    split_mode: SplitMode = SplitMode.POINTS_STRATIFIED,
    split_seed: int = 0,
) -> TrainingTaskLabels:
    """Split per point, stratified per class, into train/ref/val.

    ``split_ratios`` = (ref_ratio, val_ratio); train gets the rest.

    The assignment depends only on the label data and ``split_seed`` (fixed
    by default), never on dict or iteration order. Every class with at least
    one point keeps at least one point in train; ref/val allocations shrink
    before train empties for a class.
    """
    if split_mode is not SplitMode.POINTS_STRATIFIED:
        raise ValueError(f"Unsupported split mode: {split_mode}")
    ref_ratio, val_ratio = split_ratios
    if ref_ratio < 0 or val_ratio < 0 or ref_ratio + val_ratio >= 1.0:
        raise ValueError(
            f"split_ratios must be non-negative and sum to < 1; got {split_ratios}."
        )

    # Deterministic global point enumeration: (feature_path, point_idx).
    points_by_class: dict[str, list[tuple[str, int]]] = {}
    for key in sorted(labels.data.keys()):
        for idx, (_, _, label) in enumerate(labels.data[key]):
            points_by_class.setdefault(label, []).append((key, idx))

    rng = np.random.default_rng(split_seed)
    assignment: dict[tuple[str, int], str] = {}
    # Classes in sorted order, so the per-class draws do not depend on
    # insertion order.
    for label in sorted(points_by_class.keys()):
        points = points_by_class[label]
        n = len(points)
        n_ref = int(round(n * ref_ratio))
        n_val = int(round(n * val_ratio))
        # Keep at least one training point per class.
        while n_ref + n_val >= n and (n_ref or n_val):
            if n_val >= n_ref and n_val > 0:
                n_val -= 1
            elif n_ref > 0:
                n_ref -= 1
        order = rng.permutation(n)
        for rank, point_pos in enumerate(order):
            if rank < n_ref:
                split = "ref"
            elif rank < n_ref + n_val:
                split = "val"
            else:
                split = "train"
            assignment[points[point_pos]] = split

    out = {"train": ImageLabels(), "ref": ImageLabels(), "val": ImageLabels()}
    for key in sorted(labels.data.keys()):
        per_split: dict[str, list[Annotation]] = {"train": [], "ref": [], "val": []}
        for idx, ann in enumerate(labels.data[key]):
            per_split[assignment[(key, idx)]].append(ann)
        for split, anns in per_split.items():
            if anns:
                out[split].add_image(key, anns)

    return TrainingTaskLabels(train=out["train"], ref=out["ref"], val=out["val"])


def evaluate_classifier(
    clf: Any,
    labels: ImageLabels,
    batch_size: int = 5000,
) -> tuple[list[str], list[str], list[float]]:
    """Evaluate a calibrated classifier on a label set by streaming batches.

    Returns (ground_truths, estimates, scores), the score being the
    probability of the predicted class — the contract the trainer and
    ``ValResults`` consume.
    """
    classes = list(clf.classes_)
    gts: list[str] = []
    ests: list[str] = []
    scores: list[float] = []
    for x, y in labels.load_data_in_batches(batch_size=batch_size):
        proba = clf.predict_proba(x)
        top = np.argmax(proba, axis=1)
        gts.extend(y)
        ests.extend(classes[i] for i in top)
        scores.extend(float(proba[i, j]) for i, j in enumerate(top))
    return gts, ests, scores
