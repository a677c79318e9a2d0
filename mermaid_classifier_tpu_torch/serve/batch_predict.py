"""Bulk feature classification: extracted feature files -> predictions CSV.

Port of ``mermaid_classifier_tpu/serve/batch_predict.py``. Production
extraction leaves buckets of ``*.features.npz`` files; this module
classifies them in bulk through the shipped artifact contract (the port's
``load_predictor``, whose head runs on its device), packing every row across
all input files into large fixed batches so the calibrated head runs a
handful of device calls instead of one per file.

Inputs per file:
- ``*.npz`` — the bucket format (``rowcols`` (P, 2) + ``features`` (P, D),
  data/features_io.py);
- ``*.npy`` — a bare (P, D) float matrix (row/col reported as -1).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass(frozen=True)
class PredictionRow:
    """One point's top-N prediction."""

    source_file: str
    row: int
    col: int
    labels: tuple[str, ...]
    scores: tuple[float, ...]


def load_feature_matrix(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """(rowcols (P, 2) int, features (P, D) float32) from .npz or .npy."""
    path = Path(path)
    if path.suffix == ".npy":
        features = np.asarray(np.load(path), dtype=np.float32)
        if features.ndim != 2:
            raise ValueError(
                f"{path}: expected a 2-D feature matrix, got {features.shape}"
            )
        rowcols = np.full((len(features), 2), -1, dtype=np.int64)
        return rowcols, features
    from mermaid_classifier_tpu_torch.data.features_io import read_feature_file

    rowcols, features = read_feature_file(path)
    return np.asarray(rowcols), np.asarray(features, dtype=np.float32)


def predict_feature_files(
    predictor,
    paths: list[str | Path],
    *,
    top_n: int = 3,
    batch_size: int = 4096,
) -> list[PredictionRow]:
    """Classify every row of every file through ``predictor`` and return
    per-point top-N rows in input order. Rows are packed across file
    boundaries into ``batch_size`` batches before hitting the head, and
    features stream through a bounded carry buffer — peak feature memory
    is O(batch_size + one file), not O(total points)."""
    if top_n < 1:
        raise ValueError(f"top_n must be >= 1, got {top_n}")
    classes = np.asarray(predictor.classes)
    k = min(top_n, len(classes))

    from collections import deque

    rows: list[PredictionRow] = []
    # Pending feature blocks are drained through (deque of views, offset
    # into the head block) — a flush copies only the batch it emits, so a
    # single file much larger than batch_size costs O(n), not O(n^2/batch).
    pending_feats: deque[np.ndarray] = deque()
    pending_rows = 0
    pending_meta: deque[tuple[str, int, int]] = deque()

    def flush(batch: np.ndarray, batch_meta: list) -> None:
        proba = np.asarray(predictor.predict_proba(batch))
        order = np.argsort(-proba, axis=1)[:, :k]
        scores = np.take_along_axis(proba, order, axis=1)
        labels = classes[order]
        for i, (source_file, r, c) in enumerate(batch_meta):
            rows.append(
                PredictionRow(
                    source_file=source_file,
                    row=r,
                    col=c,
                    labels=tuple(str(x) for x in labels[i]),
                    scores=tuple(float(x) for x in scores[i]),
                )
            )

    def drain(n: int) -> None:
        nonlocal pending_rows
        parts: list[np.ndarray] = []
        need = n
        while need:
            head = pending_feats[0]
            if len(head) <= need:
                parts.append(pending_feats.popleft())
                need -= len(head)
            else:
                parts.append(head[:need])
                pending_feats[0] = head[need:]
                need = 0
        pending_rows -= n
        batch = parts[0] if len(parts) == 1 else np.concatenate(parts)
        flush(batch, [pending_meta.popleft() for _ in range(n)])

    for path in paths:
        rowcols, features = load_feature_matrix(path)
        if len(features):
            pending_feats.append(features)
            pending_rows += len(features)
        pending_meta.extend(
            (str(path), int(rowcols[i, 0]), int(rowcols[i, 1]))
            for i in range(len(features))
        )
        while pending_rows >= batch_size:
            drain(batch_size)
    if pending_rows:
        drain(pending_rows)
    return rows


def write_predictions_csv(
    rows: list[PredictionRow], output: str | Path, *, top_n: int
) -> None:
    """``file,row,col,label_1,score_1,...,label_N,score_N`` (the viewer's
    top-N write-back shape, generalized across files)."""
    output = Path(output)
    output.parent.mkdir(parents=True, exist_ok=True)
    header = ["file", "row", "col"]
    for rank in range(1, top_n + 1):
        header += [f"label_{rank}", f"score_{rank}"]
    with output.open("w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        for r in rows:
            record = [r.source_file, r.row, r.col]
            for rank in range(top_n):
                if rank < len(r.labels):
                    record += [r.labels[rank], f"{r.scores[rank]:.6f}"]
                else:
                    record += ["", ""]
            writer.writerow(record)
