"""The port's CoralNet manifest builder (``coralnet/manifest.py``) and its
parquet writer (``common/relational.write_parquet_table``) against the JAX
package on the same seeded inputs: manifest rows and their order, the
``BuildSummary`` and its ``describe()``, the audit warnings, and the
written parquet's arrow field names, types and values. The port writes no
``pandas`` schema-metadata block (it names the pandas and pyarrow
versions); that is the one difference, and it is asserted here. Also
``Database.write_parquet`` on query results of each column type, and the
``build_coralnet_manifest`` CLI's exit codes."""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from mermaid_classifier_tpu.common.relational import Database as JDatabase
from mermaid_classifier_tpu.coralnet import manifest as jman
from mermaid_classifier_tpu_torch.common.relational import Database as TDatabase
from mermaid_classifier_tpu_torch.common.relational import read_parquet_columns
from mermaid_classifier_tpu_torch.common.table import Table
from mermaid_classifier_tpu_torch.coralnet import manifest as tman

REPO = Path(__file__).resolve().parents[1]


def seeded_tables(seed=0, n_images=40, string_ids=False):
    """An ETL export: images with ok / bad / missing header status, some
    with no or an empty s3 key; annotations of 1-6 points per image, a few
    duplicates and one negative position, shuffled."""
    rng = np.random.default_rng(seed)
    sources = rng.integers(1, 5, n_images)
    image_ids = rng.permutation(np.arange(1000, 1000 + n_images))
    status = rng.choice(["ok", "ok", "ok", "error", None], n_images)
    keys = [None if rng.random() < 0.1 else ("" if rng.random() < 0.05
            else f"s{s}/i{i}.jpg") for s, i in zip(sources, image_ids)]
    images = pd.DataFrame({"source_id": sources, "image_id": image_ids,
                           "header_status": status, "s3_key": keys})
    rows = []
    for s, i in zip(sources, image_ids):
        for _ in range(rng.integers(1, 7)):
            rows.append((s, i, int(rng.integers(0, 1500)), int(rng.integers(0, 2000)),
                         str(rng.integers(100, 140))))
    rows += [rows[3], rows[7]]
    rows[5] = (rows[5][0], rows[5][1], -4, rows[5][3], rows[5][4])
    rows = [rows[j] for j in rng.permutation(len(rows))]
    annotations = pd.DataFrame(rows, columns=["source_id", "image_id", "row", "col",
                                              "coralnet_id"])
    if string_ids:
        for df in (annotations, images):
            df["source_id"] = df["source_id"].astype(str)
            df["image_id"] = df["image_id"].astype(str)
    return annotations, images


def columns(df):
    """A DataFrame as a dict of Python lists, missing values None."""
    return {c: [None if isinstance(v, float) and np.isnan(v) else
                (v.item() if hasattr(v, "item") else v) for v in df[c].tolist()]
            for c in df.columns}


def write_inputs(tmp_path, annotations, images, layout):
    paths = tmp_path / "ann.parquet", tmp_path / "img.parquet"
    for path, df in zip(paths, (annotations, images)):
        table = (pa.Table.from_pandas(df) if layout == "pandas"
                 else pa.table(columns(df)))
        pq.write_table(table, str(path))
    return paths


def jax_rows(df):
    return [tuple(None if (isinstance(v, float) and np.isnan(v)) else v
                  for v in (x.item() if hasattr(x, "item") else x for x in row))
            for row in df.itertuples(index=False)]


@pytest.mark.parametrize("layout", ["pandas", "arrow"])
@pytest.mark.parametrize("string_ids", [False, True])
def test_manifest_rows_summary_and_parquet_equal_jax(tmp_path, layout, string_ids):
    annotations, images = seeded_tables(string_ids=string_ids)
    ann_p, img_p = write_inputs(tmp_path, annotations, images, layout)
    jdf, jsum = jman.build_manifest(ann_p, img_p)
    table, tsum = tman.build_manifest(ann_p, img_p)
    assert table.columns == list(jman.MANIFEST_COLUMNS) == list(tman.MANIFEST_COLUMNS)
    assert table.rows == jax_rows(jdf)
    assert dataclasses.asdict(tsum) == dataclasses.asdict(jsum)
    assert tsum.describe() == jsum.describe()
    assert 0 < tsum.manifest_rows < tsum.total_annotations
    assert tsum.images_bad_header and tsum.images_missing_key
    assert tman.audit_manifest(table) == jman.audit_manifest(jdf)
    assert len(tman.audit_manifest(table)) == 2  # the duplicates, the negative row

    jout, tout = tmp_path / "jax.parquet", tmp_path / "port.parquet"
    jman.write_manifest(jdf, jout)
    tman.write_manifest(table, tout)
    jt, tt = pq.read_table(str(jout)), pq.read_table(str(tout))
    assert [(f.name, f.type) for f in tt.schema] == [(f.name, f.type) for f in jt.schema]
    assert tt.to_pylist() == jt.to_pylist()
    assert b"pandas" in jt.schema.metadata and tt.schema.metadata is None
    assert read_parquet_columns(str(tout)) == read_parquet_columns(str(jout))


def test_in_memory_inputs_equal_jax():
    annotations, images = seeded_tables(seed=3)
    jdf, jsum = jman.build_manifest(annotations, images)
    image_cols = columns(images)
    table, tsum = tman.build_manifest(
        columns(annotations),
        Table.from_records(dict(zip(image_cols, r)) for r in zip(*image_cols.values())))
    assert table.rows == jax_rows(jdf)
    assert dataclasses.asdict(tsum) == dataclasses.asdict(jsum)


def test_deterministic_order_and_missing_column():
    annotations, images = seeded_tables(seed=1)
    m1, _ = tman.build_manifest(
        columns(annotations.sample(frac=1, random_state=0)), columns(images))
    m2, _ = tman.build_manifest(
        columns(annotations.sample(frac=1, random_state=7)), columns(images))
    assert m1.rows == m2.rows
    with pytest.raises(ValueError, match="missing columns.*coralnet_id"):
        tman.build_manifest(columns(annotations.drop(columns=["coralnet_id"])),
                            columns(images))


def audit_cases():
    base = Table(list(tman.MANIFEST_COLUMNS), [
        (1, 10, 5, 5, "100", "a"), (1, 10, 8, 8, "101", "a"), (2, 20, 5, 5, "102", "b")])
    neg = Table(base.columns, [base.rows[0][:2] + (-1,) + base.rows[0][3:]] + base.rows[1:])
    negcol = Table(base.columns, [base.rows[0][:3] + (-2,) + base.rows[0][4:]] + base.rows[1:])
    dup = Table(base.columns, base.rows + [base.rows[2], base.rows[2]])
    empty = Table(base.columns, [base.rows[0][:4] + ("", "a"), base.rows[1][:4] + (None, "a")]
                  + base.rows[2:])
    everything = Table(base.columns, neg.rows + [neg.rows[0]] + empty.rows[:1])
    return {"clean": base, "negative_row": neg, "negative_col": negcol,
            "duplicates": dup, "empty_labels": empty, "all_three": everything}


@pytest.mark.parametrize("name", sorted(audit_cases()))
def test_audit_warnings_equal_jax(name):
    table = audit_cases()[name]
    df = pd.DataFrame(table.rows, columns=table.columns)
    assert tman.audit_manifest(table) == jman.audit_manifest(df)


def test_empty_manifest_refused(tmp_path):
    annotations, images = seeded_tables()
    images["header_status"] = "error"
    table, summary = tman.build_manifest(columns(annotations), columns(images))
    assert len(table) == 0 and summary.images_bad_header == len(images)
    with pytest.raises(ValueError, match="empty manifest"):
        tman.write_manifest(table, tmp_path / "m.parquet")
    with pytest.raises(ValueError, match="missing columns"):
        tman.write_manifest(Table(["source_id"], [(1,)]), tmp_path / "m.parquet")
    assert not (tmp_path / "m.parquet").exists()


QUERIES = {
    "ints": "SELECT a FROM t",
    "int_with_null": "SELECT e FROM t",
    "strs_with_null": "SELECT b FROM t",
    "floats": "SELECT c, g FROM t",
    "all_null": "SELECT d, f FROM t",
    "empty_result": "SELECT * FROM t WHERE 0",
    "whole_table": "t",
    "expressions": "SELECT a * 2 AS twice, b || 'x' AS bx, count(*) AS n FROM t GROUP BY a",
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_write_parquet_types_and_values_equal_jax(tmp_path, name):
    dbs = JDatabase(), TDatabase()
    for db in dbs:
        db.execute("CREATE TABLE t (a INTEGER, b TEXT, c REAL, d TEXT, e INTEGER,"
                   " f, g REAL)")
        db.executemany("INSERT INTO t VALUES (?,?,?,?,?,?,?)",
                       [(1, "x", 1.5, None, None, None, 2.0),
                        (2, None, None, None, 3, None, 3.0),
                        (3, "z", -0.25, None, 7, None, 4.5)])
    paths = tmp_path / "jax.parquet", tmp_path / "port.parquet"
    for db, path in zip(dbs, paths):
        db.write_parquet(QUERIES[name], str(path))
    jt, tt = (pq.read_table(str(p)) for p in paths)
    assert [(f.name, f.type) for f in tt.schema] == [(f.name, f.type) for f in jt.schema]
    assert tt.to_pylist() == jt.to_pylist()
    assert tt.schema.metadata is None


def test_write_parquet_refuses_a_mixed_column(tmp_path):
    db = TDatabase()
    db.execute("CREATE TABLE u (a)")
    db.executemany("INSERT INTO u VALUES (?)", [(1,), ("x",)])
    with pytest.raises(TypeError, match="mixes"):
        db.write_parquet("u", str(tmp_path / "u.parquet"))


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_build_coralnet_manifest", REPO / "scripts" / "build_coralnet_manifest.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_build_coralnet_manifest_cli(tmp_path):
    from mermaid_classifier_tpu_torch.scripts import build_coralnet_manifest as cli

    annotations, images = seeded_tables(seed=2)
    ann_p, img_p = write_inputs(tmp_path, annotations, images, "pandas")
    argv = ["--annotations-parquet", str(ann_p), "--images-parquet", str(img_p)]
    # The seeded export has duplicates and a negative row: refused.
    assert cli.main([*argv, "--output", str(tmp_path / "refused.parquet")]) == 1
    assert not (tmp_path / "refused.parquet").exists()
    assert cli.main([*argv, "--output", str(tmp_path / "port.parquet"),
                     "--allow-warnings"]) == 0
    assert _jax_cli().main([*argv, "--output", str(tmp_path / "jax.parquet"),
                            "--allow-warnings"]) == 0
    jt, tt = (pq.read_table(str(tmp_path / f)) for f in ("jax.parquet", "port.parquet"))
    assert tt.to_pylist() == jt.to_pylist()
    assert [f.type for f in tt.schema] == [f.type for f in jt.schema]
    images["header_status"] = "error"
    ann_p, img_p = write_inputs(tmp_path, annotations, images, "pandas")
    assert cli.main([*argv, "--output", str(tmp_path / "empty.parquet")]) == 1
