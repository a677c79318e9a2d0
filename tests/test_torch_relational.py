"""The port's sqlite ``Database`` against the JAX one: the same inputs (a
DataFrame on the JAX side, the same columns as lists on the port's) give
tables with the same declared column types and CREATE statement, and every
helper gives equal rows in equal order — ties of ``grouped_rows`` included,
which come out in insertion order. CSV text is compared byte for byte with
``DataFrame.to_csv(index=False)``. Every comparison is exact."""

import numpy as np
import pandas as pd
import pytest

from mermaid_classifier_tpu.common.relational import Database as JDatabase
from mermaid_classifier_tpu_torch.common.relational import Database as TDatabase
from mermaid_classifier_tpu_torch.common.table import Table, to_csv_text


def seeded_columns(seed: int = 0, n: int = 60) -> dict:
    """Annotation-like columns: string ids with leading zeros, ints, floats,
    None, a constant, a bool, and group keys with many ties."""
    rng = np.random.default_rng(seed)
    return {
        "image_id": [f"{int(v):03d}" for v in rng.integers(0, 12, n)],
        "row": [int(v) for v in rng.integers(0, 500, n)],
        "col": [int(v) for v in rng.integers(0, 500, n)],
        "label_id": [None if v < 0.2 else str(int(v * 10)) for v in rng.random(n)],
        "score": [float(v) for v in rng.random(n)],
        "site": ["coralnet"] * n,
        "flag": [bool(v) for v in rng.integers(0, 2, n)],
        "bucket": [str(v) for v in rng.choice(["b1", "b2"], n)],
    }


VARIANTS = {
    "annotations": seeded_columns,
    "int_with_null": lambda: {"a": [1, None, 3], "b": ["x", "y", "z"]},
    "float_and_int": lambda: {"a": [1, 2.5, 3], "b": [True, None, False]},
    "all_null": lambda: {"n": [None, None], "s": ["007", "7"]},
    "mixed": lambda: {"m": [1, "a", None]},
}


def both(cols):
    jdb, tdb = JDatabase(), TDatabase()
    jdb.create_table_from_df("t", pd.DataFrame(cols))
    tdb.create_table("t", cols)
    return jdb, tdb


def rows(db, sql="SELECT * FROM t"):
    return db.conn.execute(sql).fetchall()


def master(db):
    return db.conn.execute("SELECT name, sql FROM sqlite_master ORDER BY name").fetchall()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_create_table_types_and_rows(variant):
    cols = VARIANTS[variant]()
    jdb, tdb = both(cols)
    assert master(tdb) == master(jdb)
    assert rows(tdb, "PRAGMA table_info(t)") == rows(jdb, "PRAGMA table_info(t)")
    assert rows(tdb) == rows(jdb)
    assert tdb.columns("t") == jdb.columns("t")
    assert tdb.row_count("t") == jdb.row_count("t")
    assert tdb.table_exists("t") and not tdb.table_exists("u")
    # Replacing the table declares anew.
    jdb.create_table_from_df("t", pd.DataFrame(cols).iloc[::-1])
    tdb.create_table("t", {k: v[::-1] for k, v in cols.items()})
    assert rows(tdb) == rows(jdb) and master(tdb) == master(jdb)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_query_and_csv(variant, tmp_path):
    jdb, tdb = both(VARIANTS[variant]())
    q = "SELECT * FROM t"
    jdf, tt = jdb.query_df(q), tdb.query(q)
    assert tt.columns == list(jdf.columns)
    assert to_csv_text(tt) == jdf.to_csv(index=False)
    jdb.write_csv("t", str(tmp_path / "j.csv"))
    tdb.write_csv("t", str(tmp_path / "t.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_insert_appends_in_order():
    cols = seeded_columns()
    jdb, tdb = both(cols)
    more = seeded_columns(seed=1, n=7)
    jdb.insert_df("t", pd.DataFrame(more))
    tdb.insert("t", more)
    assert rows(tdb) == rows(jdb)
    # Into a table that does not exist yet: created as by create_table.
    jdb.insert_df("u", pd.DataFrame(more))
    tdb.insert("u", Table.from_columns(more))
    assert master(tdb) == master(jdb)
    assert rows(tdb, "SELECT * FROM u") == rows(jdb, "SELECT * FROM u")


def test_transform_add_filter():
    jdb, tdb = both(seeded_columns())
    for db in (jdb, tdb):
        db.transform_column("t", "label_id", lambda v: None if v == "3" else
                            ("" if v is None else v + "x"))
        db.add_column_from("t", "combo", ["image_id", "label_id"],
                           lambda a, b: f"{a}::{b}")
    assert rows(tdb) == rows(jdb)
    deleted = [db.filter_on_column("t", "image_id", lambda v: v not in ("003", "007"))
               for db in (jdb, tdb)]
    assert deleted[1] == deleted[0] > 0
    assert rows(tdb) == rows(jdb)
    assert [db.filter_on_column("t", "site", lambda v: True) for db in (jdb, tdb)] \
        == [0, 0]
    assert master(tdb) == master(jdb)


def test_iter_and_grouped_rows_keep_tie_order():
    jdb, tdb = both(seeded_columns(n=200))
    sql = "SELECT * FROM t ORDER BY bucket, image_id"
    assert list(tdb.iter_rows(sql, chunk_size=7)) == list(jdb.iter_rows(sql, chunk_size=7))
    for keys in (["bucket"], ["bucket", "image_id"], ["label_id"]):
        assert list(tdb.grouped_rows("t", keys, chunk_size=13)) == \
            list(jdb.grouped_rows("t", keys, chunk_size=13))
    assert tdb.scalar("SELECT count(DISTINCT image_id) FROM t") == \
        jdb.scalar("SELECT count(DISTINCT image_id) FROM t")


def test_temp_table_drops():
    tdb = TDatabase()
    with tdb.temp_table("x") as name:
        tdb.execute(f'CREATE TABLE "{name}" (a)')
        assert tdb.table_exists(name)
    assert not tdb.table_exists(name)


def test_parquet_in_and_out(tmp_path):
    cols = seeded_columns()
    cols.pop("flag")
    pd.DataFrame(cols).to_parquet(tmp_path / "in.parquet")
    jdb, tdb = JDatabase(), TDatabase()
    jdb.read_parquet(str(tmp_path / "in.parquet"), "p")
    tdb.read_parquet(str(tmp_path / "in.parquet"), "p")
    assert master(tdb) == master(jdb)
    assert rows(tdb, "SELECT * FROM p") == rows(jdb, "SELECT * FROM p")
    tdb.write_parquet("p", str(tmp_path / "out.parquet"))
    back = pd.read_parquet(tmp_path / "out.parquet")
    assert back.to_csv(index=False) == jdb.query_df("SELECT * FROM p").to_csv(index=False)
