"""Relational ETL engine: sqlite3, tables in and out as ``Table`` rows.

The port's own copy of ``mermaid_classifier_tpu/common/relational.py``,
without pandas. The API is the JAX one with a ``Table`` (or a list of
records, or a dict of columns) where JAX takes or returns a DataFrame:
``query`` for ``query_df``, ``create_table`` for ``create_table_from_df``,
``insert`` for ``insert_df``.

A table created here declares the column types ``DataFrame.to_sql``
declares for the same values (TEXT for strings and missing-only columns,
INTEGER for ints and bools, REAL for floats and for ints with a missing
value, whose values go in as floats), and inserts its rows in the order
given. SQLite's type affinity follows the declared type ("007" stays a
string in a TEXT column), and so do ``IS``, ``ORDER BY`` and ``CAST``; and
an ORDER BY over keys with ties returns the tied rows in insertion order,
so the same inserts give the same rows in the same order as the JAX engine.

Parquet is read by ``read_parquet_columns`` alone, which imports
``pyarrow.parquet`` when called.

Determinism contract: every subsetting operation must ORDER BY an explicit
key; helpers here never emit un-ordered LIMITs.
"""

from __future__ import annotations

import math
import sqlite3
import uuid
from collections.abc import Callable, Iterator
from contextlib import contextmanager
from typing import Any

import numpy as np

from mermaid_classifier_tpu_torch.common.table import Table, as_table, value_kinds


def _quote_ident(name: str) -> str:
    if not name.replace("_", "").isalnum():
        raise ValueError(f"suspicious SQL identifier: {name!r}")
    return f'"{name}"'


def _escape(name: str) -> str:
    """pandas' sqlite identifier escape."""
    return '"' + name.replace('"', '""') + '"'


def declared_type(values: list) -> tuple[str, bool]:
    """(the SQL type ``DataFrame.to_sql`` declares for this column, whether
    its values go in as floats)."""
    kinds, missing, n = value_kinds(values)
    if n == 0:
        return "REAL", True
    if kinds == {"int"} and not missing:
        return "INTEGER", False
    if kinds and kinds <= {"int", "float"}:
        return "REAL", True
    if kinds == {"bool"}:
        return "INTEGER", False
    return "TEXT", False


def _sql_value(value: Any, as_float: bool) -> Any:
    if value is None:
        return None
    if as_float:
        value = float(value)
        return None if math.isnan(value) else value
    if isinstance(value, (np.generic,)):
        return value.item()
    return value


def read_parquet_columns(path: str) -> dict[str, list]:
    """A parquet file as {column: values}, each value as the JAX package
    sees it after ``to_pandas()``: an integer column holding a null becomes
    float (pandas float64), every null None."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    table = pq.read_table(path)
    out: dict[str, list] = {}
    for name, column in zip(table.column_names, table.columns):
        values = column.to_pylist()
        if pa.types.is_integer(column.type) and column.null_count:
            values = [None if v is None else float(v) for v in values]
        out[name] = values
    return out


def pandas_str(values: list) -> list:
    """``Series.astype(str)`` as pandas 3 applies it to a column read from
    parquet: a missing value stays missing (None), a float is written by
    its repr (so an integer column holding a null gives "1001.0"), every
    other value by ``str``."""
    out = []
    for v in values:
        if v is None or (isinstance(v, float) and math.isnan(v)):
            out.append(None)
        elif isinstance(v, float):
            out.append(repr(v))
        else:
            out.append(str(v))
    return out


class Database:
    """One in-memory (or file-backed) sqlite database with ETL helpers."""

    def __init__(self, path: str = ":memory:"):
        self.conn = sqlite3.connect(path)
        self.conn.execute("PRAGMA temp_store = MEMORY")

    # -- basics ---------------------------------------------------------------

    def execute(self, sql: str, params: Any = ()) -> sqlite3.Cursor:
        return self.conn.execute(sql, params)

    def executemany(self, sql: str, rows: Any) -> sqlite3.Cursor:
        return self.conn.executemany(sql, rows)

    def query(self, sql: str, params: Any = ()) -> Table:
        cur = self.conn.execute(sql, params)
        columns = [d[0] for d in cur.description]
        return Table(columns, cur.fetchall())

    def scalar(self, sql: str, params: Any = ()) -> Any:
        row = self.conn.execute(sql, params).fetchone()
        return row[0] if row else None

    def table_exists(self, name: str) -> bool:
        return (
            self.scalar(
                "SELECT count(*) FROM sqlite_master WHERE type='table' AND name=?",
                (name,),
            )
            > 0
        )

    def columns(self, table: str) -> list[str]:
        cur = self.conn.execute(f"SELECT * FROM {_quote_ident(table)} LIMIT 0")
        return [d[0] for d in cur.description]

    def row_count(self, table: str) -> int:
        return int(self.scalar(f"SELECT count(*) FROM {_quote_ident(table)}"))

    # -- tables & parquet ----------------------------------------------------------

    def create_table(self, name: str, data: Any) -> None:
        """Create (or replace) ``name`` from a Table, records or a dict of
        columns, declaring the types ``DataFrame.to_sql`` would."""
        table = as_table(data)
        if self.table_exists(name):
            self.conn.execute(f"DROP TABLE {_escape(name)}")
        columns = [table.column(c) for c in table.columns]
        types = [declared_type(v) for v in columns]
        defs = ",\n  ".join(
            f"{_escape(c)} {t}" for c, (t, _) in zip(table.columns, types)
        )
        self.conn.execute(f"CREATE TABLE {_escape(name)} (\n{defs}\n)")
        self._insert_rows(name, table.columns, columns, types)

    def insert(self, name: str, data: Any) -> None:
        """Append rows to ``name`` (created as by ``create_table`` when it
        does not exist)."""
        table = as_table(data)
        if not self.table_exists(name):
            self.create_table(name, table)
            return
        columns = [table.column(c) for c in table.columns]
        types = [declared_type(v) for v in columns]
        self._insert_rows(name, table.columns, columns, types)

    def _insert_rows(self, name, names, columns, types) -> None:
        if not columns or not columns[0]:
            return
        as_float = [f for _, f in types]
        rows = [
            tuple(_sql_value(v, f) for v, f in zip(row, as_float))
            for row in zip(*columns)
        ]
        cols = ",".join(_escape(c) for c in names)
        marks = ",".join("?" for _ in names)
        self.conn.executemany(
            f"INSERT INTO {_escape(name)} ({cols}) VALUES ({marks})", rows
        )

    def read_parquet(self, path: str, table: str) -> None:
        self.create_table(table, read_parquet_columns(path))

    def write_parquet(self, sql_or_table: str, path: str) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        result = self.query(self._select(sql_or_table))
        pq.write_table(
            pa.table({c: result.column(c) for c in result.columns}), path
        )

    def write_csv(self, sql_or_table: str, path: str) -> None:
        from mermaid_classifier_tpu_torch.common.table import to_csv_text

        with open(path, "w", newline="") as f:
            f.write(to_csv_text(self.query(self._select(sql_or_table))))

    @staticmethod
    def _select(sql_or_table: str) -> str:
        return (
            f"SELECT * FROM {_quote_ident(sql_or_table)}"
            if sql_or_table.isidentifier()
            else sql_or_table
        )

    # -- temp tables --------------------------------------------------------------

    @contextmanager
    def temp_table(self, prefix: str = "tmp") -> Iterator[str]:
        """Yield a unique table name; DROP it on exit."""
        name = f"{prefix}_{uuid.uuid4().hex[:12]}"
        try:
            yield name
        finally:
            self.conn.execute(f"DROP TABLE IF EXISTS {_quote_ident(name)}")

    # -- python-function column ops ---------------------------------------------

    def transform_column(
        self, table: str, column: str, fn: Callable[[Any], Any]
    ) -> None:
        """Replace ``column`` with ``fn(column)`` applied once per DISTINCT
        value via a mapping-table JOIN."""
        q_table, q_col = _quote_ident(table), _quote_ident(column)
        distinct = [
            r[0]
            for r in self.conn.execute(
                f"SELECT DISTINCT {q_col} FROM {q_table}"
            ).fetchall()
        ]
        mapping = [(v, fn(v)) for v in distinct]
        with self.temp_table("map") as map_table:
            q_map = _quote_ident(map_table)
            self.conn.execute(f"CREATE TABLE {q_map} (old_value, new_value)")
            self.conn.executemany(
                f"INSERT INTO {q_map} VALUES (?, ?)", mapping
            )
            self.conn.execute(
                f"UPDATE {q_table} SET {q_col} ="
                f" (SELECT new_value FROM {q_map} WHERE old_value IS {q_table}.{q_col})"
            )

    def add_column_from(
        self,
        table: str,
        new_column: str,
        source_columns: list[str],
        fn: Callable[..., Any],
    ) -> None:
        """Add ``new_column`` computed by a Python function of other columns,
        applied once per DISTINCT source tuple."""
        q_table = _quote_ident(table)
        q_new = _quote_ident(new_column)
        q_srcs = ", ".join(_quote_ident(c) for c in source_columns)
        distinct = self.conn.execute(
            f"SELECT DISTINCT {q_srcs} FROM {q_table}"
        ).fetchall()
        mapping = [(*vals, fn(*vals)) for vals in distinct]
        with self.temp_table("map") as map_table:
            q_map = _quote_ident(map_table)
            src_defs = ", ".join(f"src{i}" for i in range(len(source_columns)))
            self.conn.execute(f"CREATE TABLE {q_map} ({src_defs}, out_value)")
            placeholders = ", ".join("?" for _ in range(len(source_columns) + 1))
            self.conn.executemany(
                f"INSERT INTO {q_map} VALUES ({placeholders})", mapping
            )
            self.conn.execute(f"ALTER TABLE {q_table} ADD COLUMN {q_new}")
            match = " AND ".join(
                f"{q_map}.src{i} IS {q_table}.{_quote_ident(c)}"
                for i, c in enumerate(source_columns)
            )
            self.conn.execute(
                f"UPDATE {q_table} SET {q_new} ="
                f" (SELECT out_value FROM {q_map} WHERE {match})"
            )

    def filter_on_column(
        self, table: str, column: str, keep_fn: Callable[[Any], bool]
    ) -> int:
        """Delete rows whose ``column`` value fails ``keep_fn`` (applied per
        DISTINCT value). Returns the number of deleted rows."""
        q_table, q_col = _quote_ident(table), _quote_ident(column)
        distinct = [
            r[0]
            for r in self.conn.execute(
                f"SELECT DISTINCT {q_col} FROM {q_table}"
            ).fetchall()
        ]
        drop_values = [v for v in distinct if not keep_fn(v)]
        if not drop_values:
            return 0
        before = self.row_count(table)
        with self.temp_table("drop") as drop_table:
            q_drop = _quote_ident(drop_table)
            self.conn.execute(f"CREATE TABLE {q_drop} (value)")
            self.conn.executemany(
                f"INSERT INTO {q_drop} VALUES (?)", [(v,) for v in drop_values]
            )
            self.conn.execute(
                f"DELETE FROM {q_table} WHERE {q_col} IN (SELECT value FROM {q_drop})"
            )
        return before - self.row_count(table)

    # -- iteration -------------------------------------------------------------

    def iter_rows(
        self, sql: str, params: Any = (), chunk_size: int = 10000
    ) -> Iterator[dict[str, Any]]:
        """Yield rows as dicts, fetching in chunks."""
        cur = self.conn.execute(sql, params)
        columns = [d[0] for d in cur.description]
        while True:
            rows = cur.fetchmany(chunk_size)
            if not rows:
                return
            for row in rows:
                yield dict(zip(columns, row))

    def grouped_rows(
        self, table: str, group_columns: list[str], chunk_size: int = 10000
    ) -> Iterator[list[dict[str, Any]]]:
        """Yield lists of rows sharing the same group-column values, streaming
        in group order."""
        order = ", ".join(_quote_ident(c) for c in group_columns)
        current_key: tuple | None = None
        group: list[dict[str, Any]] = []
        for row in self.iter_rows(
            f"SELECT * FROM {_quote_ident(table)} ORDER BY {order}",
            chunk_size=chunk_size,
        ):
            key = tuple(row[c] for c in group_columns)
            if current_key is not None and key != current_key:
                yield group
                group = []
            current_key = key
            group.append(row)
        if group:
            yield group

    def close(self) -> None:
        self.conn.close()
