"""CSV-defined config framework on the stdlib ``csv`` module.

The port's own copy of ``mermaid_classifier_tpu/common/csv_utils.py``
without pandas: declared columns with header aliases, blank cells kept as
empty strings (never NaN), and a per-row hook subclasses implement. The
rows are kept as a ``Table`` (``CsvSpec.table``) where JAX keeps a
DataFrame.
"""

from __future__ import annotations

import csv
import io
from dataclasses import dataclass
from typing import IO, Any, ClassVar

from mermaid_classifier_tpu_torch.common.table import Table


@dataclass(frozen=True)
class ColumnSpec:
    """One expected CSV column: canonical name plus accepted header aliases."""

    name: str
    aliases: tuple[str, ...] = ()
    required: bool = True

    def matches(self, header: str) -> bool:
        return header == self.name or header in self.aliases


def csv_to_table(csv_file: str | IO[str], columns: tuple[ColumnSpec, ...]) -> Table:
    """Read a CSV with every cell as a string (a blank cell is ""), rename
    alias headers to canonical names, and validate presence.

    An empty file yields an empty table with all canonical columns, so specs
    constructed from empty CSVs behave as empty sets.
    """
    if isinstance(csv_file, str):
        with open(csv_file, newline="") as f:
            text = f.read()
    else:
        text = csv_file.read()
    reader = csv.reader(io.StringIO(text))
    header = next(reader, None)
    if header is None:
        return Table([spec.name for spec in columns])
    rows = [r for r in reader if r]

    rename: dict[str, str] = {}
    for h in header:
        for spec in columns:
            if spec.matches(h) and h != spec.name:
                rename[h] = spec.name
    names = [rename.get(h, h) for h in header]

    missing = [
        spec.name for spec in columns if spec.required and spec.name not in names
    ]
    if missing:
        raise ValueError(
            f"CSV is missing required column(s) {missing};"
            f" found columns {names}."
        )
    width = len(names)
    table = Table(names, [(r + [""] * width)[:width] for r in rows])
    for spec in columns:
        if spec.name not in table.columns:
            table = table.with_column(len(table.columns), spec.name,
                                      [""] * len(table))
    return table


class CsvSpec:
    """Base class: subclasses declare COLUMNS and implement handle_row."""

    COLUMNS: ClassVar[tuple[ColumnSpec, ...]] = ()

    def __init__(self, csv_file: str | IO[str]):
        self.table = csv_to_table(csv_file, self.COLUMNS)
        for row in self.table.records():
            self.handle_row(row)

    def handle_row(self, row: dict[str, Any]) -> None:
        """Per-row initialization hook; default does nothing."""

    def __len__(self) -> int:
        return len(self.table)
