"""A small column-named table, and its CSV text.

The JAX package hands pandas DataFrames between its ETL, runner, metric
groups and tracker. The port hands a ``Table`` instead: column names and
one tuple per row, built from rows, records or a dict of columns.

``to_csv_text`` writes the bytes ``DataFrame.to_csv(index=False)`` writes
for the same values, so an artifact logged by either package reads the
same. pandas infers one type per column from its values, and the text
follows that type:

- int, with no missing value: ``str(int)``;
- float, or int mixed with float or with a missing value (pandas makes the
  column float64): the shortest round-trip repr, so 3 is written ``3.0``;
- bool, with no missing value: ``True`` / ``False``;
- anything else (str, mixed): ``str(value)``;
- a missing value (None or NaN): the empty field.

``Table.sort_values`` orders rows as ``DataFrame.sort_values(name,
ascending=...)`` does with its default kind (``pandas_sort_order``).
"""

from __future__ import annotations

import csv
import io
import math
from collections.abc import Iterable, Sequence
from typing import Any

import numpy as np


def _is_missing(value: Any) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


def value_kinds(values: Iterable[Any]) -> tuple[set[str], bool, int]:
    """(the kinds of the non-missing values among "bool", "int", "float",
    "str", "object"; whether a value is missing (None or NaN); how many
    values there are)."""
    kinds: set[str] = set()
    missing = False
    n = 0
    for v in values:
        n += 1
        if v is None:
            missing = True
        elif isinstance(v, (bool, np.bool_)):
            kinds.add("bool")
        elif isinstance(v, (int, np.integer)):
            kinds.add("int")
        elif isinstance(v, (float, np.floating)):
            kinds.add("float")
            missing = missing or math.isnan(v)
        elif isinstance(v, str):
            kinds.add("str")
        else:
            kinds.add("object")
    return kinds, missing, n


def column_kind(values: Iterable[Any]) -> str:
    """The pandas dtype family a list of Python values infers to:
    "int", "float", "bool", "str" or "object" (a mix, or only missing
    values)."""
    kinds, missing, _ = value_kinds(values)
    if kinds and kinds <= {"int", "float"}:
        return "float" if ("float" in kinds or missing) else "int"
    if kinds == {"bool"} and not missing:
        return "bool"
    if kinds == {"str"}:
        return "str"
    return "object"


def _cell(value: Any, kind: str) -> str:
    if _is_missing(value):
        return ""
    if kind == "float":
        return repr(float(value))
    if kind == "int":
        return str(int(value))
    if isinstance(value, (np.floating, np.integer, np.bool_)):
        value = value.item()
    return str(value)


class Table:
    """Named columns and one tuple per row."""

    def __init__(self, columns: Sequence[str], rows: Iterable[Sequence] = ()):
        self.columns = list(columns)
        self.rows = [tuple(r) for r in rows]
        for r in self.rows:
            if len(r) != len(self.columns):
                raise ValueError(
                    f"row of {len(r)} values for {len(self.columns)} columns"
                )

    @classmethod
    def from_records(
        cls, records: Iterable[dict], columns: Sequence[str] | None = None
    ) -> "Table":
        """Rows from dicts; the columns are ``columns`` or every key in order
        of first appearance (a key a record lacks reads None)."""
        records = list(records)
        if columns is None:
            seen: dict[str, None] = {}
            for rec in records:
                seen.update(dict.fromkeys(rec))
            columns = list(seen)
        return cls(columns, [tuple(rec.get(c) for c in columns) for rec in records])

    @classmethod
    def from_columns(cls, data: dict[str, Sequence]) -> "Table":
        """Rows from a dict of equally long columns."""
        columns = list(data)
        lengths = {len(v) for v in data.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal lengths {sorted(lengths)}")
        return cls(columns, zip(*(data[c] for c in columns)))

    def __len__(self) -> int:
        return len(self.rows)

    @property
    def empty(self) -> bool:
        return not self.rows or not self.columns

    def column(self, name: str) -> list:
        i = self.columns.index(name)
        return [r[i] for r in self.rows]

    def records(self) -> list[dict]:
        return [dict(zip(self.columns, r)) for r in self.rows]

    def where(self, name: str, value: Any) -> "Table":
        """The rows whose ``name`` equals ``value``, in order."""
        i = self.columns.index(name)
        return Table(self.columns, [r for r in self.rows if r[i] == value])

    def with_column(self, position: int, name: str, values: Sequence) -> "Table":
        """A copy with ``values`` inserted as column ``name`` at ``position``."""
        values = list(values)
        if len(values) != len(self.rows):
            raise ValueError(f"{len(values)} values for {len(self.rows)} rows")
        cols = self.columns[:position] + [name] + self.columns[position:]
        rows = [r[:position] + (v,) + r[position:] for r, v in zip(self.rows, values)]
        return Table(cols, rows)

    def sort_values(self, name: str, ascending: bool = True) -> "Table":
        """The rows in ``pandas_sort_order`` of column ``name``."""
        order = pandas_sort_order(self.column(name), ascending)
        return Table(self.columns, [self.rows[i] for i in order])

    def __repr__(self) -> str:
        return f"Table(columns={self.columns!r}, {len(self.rows)} rows)"


def pandas_sort_order(values: Sequence, ascending: bool = True) -> np.ndarray:
    """The row order of pandas' ``nargsort`` with its default quicksort:
    numpy's unstable ``argsort`` over the non-NaN values (reversed before
    and after the sort when descending), the NaN rows last. Rows with equal
    values come out in pandas' order, which is not Python's stable
    ``sorted`` order once there are more than 16 rows."""
    items = np.asarray(values)
    mask = np.isnan(items) if items.dtype.kind == "f" else np.zeros(len(items), bool)
    idx = np.arange(len(items))
    non_nans = items[~mask]
    non_nan_idx = idx[~mask]
    if not ascending:
        non_nans = non_nans[::-1]
        non_nan_idx = non_nan_idx[::-1]
    indexer = non_nan_idx[non_nans.argsort(kind="quicksort")]
    if not ascending:
        indexer = indexer[::-1]
    return np.concatenate([indexer, np.nonzero(mask)[0]])


def as_table(data: Any) -> Table:
    """A Table from a Table, a list of records or a dict of columns."""
    if isinstance(data, Table):
        return data
    if isinstance(data, dict):
        return Table.from_columns(data)
    return Table.from_records(data)


def to_csv_text(data: Any) -> str:
    """The text ``pandas.DataFrame(data).to_csv(index=False)`` writes."""
    table = as_table(data)
    kinds = [
        column_kind([r[i] for r in table.rows]) for i in range(len(table.columns))
    ]
    buf = io.StringIO()
    writer = csv.writer(buf, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
    writer.writerow(table.columns)
    for row in table.rows:
        writer.writerow([_cell(v, k) for v, k in zip(row, kinds)])
    return buf.getvalue()
