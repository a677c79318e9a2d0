"""Per-point CoralNet training-manifest builder.

The port's own copy of ``mermaid_classifier_tpu/coralnet/manifest.py``, on
the port's sqlite engine and ``Table`` in place of DataFrames. It joins the
ETL annotation table against the ETL image table to produce the manifest
the training dataset consumes (``data/dataset.py``
``read_coralnet_manifest``): one row per annotated point, only for images
whose header probe succeeded and whose object key is known.

Input tables (parquet paths, or a ``Table`` / records / dict of columns):

- annotations: source_id, image_id, row, col, coralnet_id  (one row / point)
- images:      source_id, image_id, header_status, s3_key  (one row / image)

A parquet input loads through ``read_parquet_columns`` and
``Database.create_table``, which declare ``DataFrame.to_sql``'s column
types, so the join compares values as the JAX builder does.

Output manifest columns (``MANIFEST_COLUMNS``): source_id, image_id, row,
col, coralnet_id, s3_key. Images are kept only when
``header_status = 'ok'`` AND ``s3_key`` is non-null/non-empty; a NULL
status counts as a bad header.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any

from mermaid_classifier_tpu_torch.common.relational import (
    Database,
    read_parquet_columns,
    write_parquet_table,
)
from mermaid_classifier_tpu_torch.common.table import Table, as_table

MANIFEST_COLUMNS = (
    "source_id",
    "image_id",
    "row",
    "col",
    "coralnet_id",
    "s3_key",
)

_ANNOTATION_REQUIRED = {"source_id", "image_id", "row", "col", "coralnet_id"}
_IMAGE_REQUIRED = {"source_id", "image_id", "header_status", "s3_key"}


@dataclass(frozen=True)
class BuildSummary:
    """Counts for auditing a manifest build."""

    total_annotations: int
    manifest_rows: int
    images_total: int
    images_ok: int
    images_bad_header: int
    images_missing_key: int
    manifest_sources: int
    manifest_images: int

    def describe(self) -> str:
        return (
            f"annotations in: {self.total_annotations:,};"
            f" manifest rows out: {self.manifest_rows:,}"
            f" ({self.manifest_sources} sources, {self.manifest_images:,} images)."
            f" Images: {self.images_total:,} total, {self.images_ok:,} ok,"
            f" {self.images_bad_header:,} bad header,"
            f" {self.images_missing_key:,} missing key."
        )


def _load_table(db: Database, name: str, source: Any, required: set[str]) -> None:
    if isinstance(source, (str, Path)):
        source = read_parquet_columns(str(source))
    table = as_table(source)
    missing = required - set(table.columns)
    if missing:
        raise ValueError(
            f"{name} table is missing columns {sorted(missing)};"
            f" has {sorted(table.columns)}"
        )
    db.create_table(name, table)


def _nunique(values: list) -> int:
    """``Series.nunique()``: distinct values, missing ones not counted."""
    return len({v for v in values if v is not None and v == v})


def build_manifest(
    annotations: Any, images: Any, db: Database | None = None
) -> tuple[Table, BuildSummary]:
    """Join annotations x images into the per-point manifest.

    Returns (manifest, summary). Deterministic output order:
    (source_id, image_id, row, col).
    """
    db = db or Database()
    _load_table(db, "ann", annotations, _ANNOTATION_REQUIRED)
    _load_table(db, "img", images, _IMAGE_REQUIRED)

    images_total = db.row_count("img")
    images_bad_header = int(
        db.scalar("SELECT count(*) FROM img WHERE header_status IS NOT 'ok'")
    )
    images_missing_key = int(
        db.scalar(
            "SELECT count(*) FROM img WHERE header_status = 'ok'"
            " AND (s3_key IS NULL OR s3_key = '')"
        )
    )
    db.execute(
        "CREATE TEMP TABLE img_ok AS SELECT source_id, image_id, s3_key"
        " FROM img WHERE header_status = 'ok'"
        " AND s3_key IS NOT NULL AND s3_key != ''"
    )
    images_ok = int(db.scalar("SELECT count(*) FROM img_ok"))

    manifest = db.query(
        "SELECT a.source_id, a.image_id, a.row, a.col, a.coralnet_id, i.s3_key"
        " FROM ann a JOIN img_ok i"
        " ON a.source_id = i.source_id AND a.image_id = i.image_id"
        " ORDER BY a.source_id, a.image_id, a.row, a.col"
    )
    summary = BuildSummary(
        total_annotations=db.row_count("ann"),
        manifest_rows=len(manifest),
        images_total=images_total,
        images_ok=images_ok,
        images_bad_header=images_bad_header,
        images_missing_key=images_missing_key,
        manifest_sources=_nunique(manifest.column("source_id")),
        manifest_images=_nunique(manifest.column("image_id")),
    )
    return manifest, summary


def write_manifest(manifest: Table, path: str | Path) -> None:
    """Write the manifest parquet (``write_parquet_table``: the arrow types
    the JAX writer gets from pandas); refuses to write an empty manifest."""
    if len(manifest) == 0:
        raise ValueError(
            "Refusing to write an empty manifest — the join produced no"
            " rows. Check header_status / s3_key coverage in the images"
            " table."
        )
    missing = set(MANIFEST_COLUMNS) - set(manifest.columns)
    if missing:
        raise ValueError(f"manifest is missing columns {sorted(missing)}")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    write_parquet_table(
        Table.from_columns({c: manifest.column(c) for c in MANIFEST_COLUMNS}),
        str(path),
    )


def audit_manifest(manifest: Table) -> list[str]:
    """Best-effort warnings pass over a built manifest."""
    warnings: list[str] = []

    def negative(name):
        return any(v is not None and v < 0 for v in manifest.column(name))

    if negative("row") or negative("col"):
        warnings.append("manifest contains negative row/col point positions")
    keys = zip(*(manifest.column(c) for c in ("source_id", "image_id", "row", "col")))
    seen: set = set()
    dupes = 0
    for key in keys:
        dupes += key in seen
        seen.add(key)
    if dupes:
        warnings.append(
            f"manifest contains {int(dupes)} duplicate (source, image, row,"
            f" col) points"
        )
    empty_labels = sum(
        v is None or v != v or str(v) == "" for v in manifest.column("coralnet_id")
    )
    if empty_labels:
        warnings.append(
            f"manifest contains {int(empty_labels)} rows with empty coralnet_id"
        )
    return warnings
