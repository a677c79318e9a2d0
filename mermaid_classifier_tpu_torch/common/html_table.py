"""A CSV file as ``pandas.read_csv`` reads it, and the HTML table
``DataFrame.to_html(index=False, border=0)`` writes for it, without pandas.

The JAX package's run report renders each CSV artifact with
``pd.read_csv(path)`` then ``df.head(200).to_html(index=False, border=0)``.
The port writes the same bytes. What pandas decides, and this module
follows:

- **Missing values.** A field equal to one of pandas' default NA strings
  (``NA_STRINGS``: "", "NA", "N/A", "None", "null", "nan", ...) is missing,
  quoted or not, and prints as ``NaN``. A class literally named "NA" is
  missing too.
- **One type per column**, from all of its non-missing fields (not only
  the rows shown): int (``[+-]digits``, spaces and tabs around allowed),
  then float (decimal, exponent, ``inf`` / ``infinity`` in any case), then
  bool ("True" / "TRUE" / "true" and the three falses), else str. An int
  or all-missing column with a missing value is float, so ``3`` prints as
  ``3.0``; a bool column with a missing value holds objects, printed
  ``True`` / ``False`` / ``NaN``.
- **Floats are formatted per column** (pandas' ``FloatArrayFormatter`` at
  ``display.precision`` 6, no leading space): each value ``{:.6f}``, then
  trailing zeros trimmed while every decimal number of the column ends in
  0 (one kept after the point); the whole column switches to ``{:.6e}``
  when a value lies in (0, 1e-6) in magnitude, or when a value exceeds
  1e6 and the longest trimmed value is longer than 12 characters.
- **Cells.** A str value has tab, CR and LF written as ``\\t``, ``\\r``,
  ``\\n``; every cell and header has ``&``, ``<``, ``>`` escaped, is
  stripped, and has each pair of spaces written ``&nbsp;&nbsp;``.
- **Rows.** Blank lines (nothing, or only spaces and tabs) are skipped; a
  short row is padded with missing values; a row longer than the header
  raises ``CsvParseError``, except when the first data row has exactly one
  field more than the header: then the first field of every row is the
  (unprinted) index. Empty and duplicate header names become
  ``Unnamed: i`` and ``name.1``.
"""

from __future__ import annotations

import csv
import io
import math
import re
from dataclasses import dataclass
from pathlib import Path

NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
TRUE_STRINGS = frozenset({"True", "TRUE", "true"})
FALSE_STRINGS = frozenset({"False", "FALSE", "false"})
PRECISION = 6

_INT = re.compile(r"[ \t]*[+-]?[0-9]+[ \t]*")
_FLOAT = re.compile(
    r"[ \t]*[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
    r"|(?i:inf|infinity))[ \t]*"
)
_DECIMAL_NUMBER = re.compile(r"\s*[+-]?[0-9]+\.[0-9]*")


class CsvParseError(ValueError):
    """The file is not a table pandas' ``read_csv`` would read."""


@dataclass
class CsvFrame:
    """Named columns, each with its pandas type ("int", "float", "bool",
    "object" or "str") and its values (None where missing; a float
    column's missing values are NaN)."""

    columns: list[str]
    kinds: list[str]
    data: list[list]

    def __len__(self) -> int:
        return len(self.data[0]) if self.data else 0

    def head(self, n: int) -> "CsvFrame":
        return CsvFrame(self.columns, self.kinds, [col[:n] for col in self.data])

    def to_table(self):
        """The values as a ``common.table.Table``."""
        from mermaid_classifier_tpu_torch.common.table import Table

        return Table(self.columns, zip(*self.data))

    def to_html(self) -> str:
        """``DataFrame.to_html(index=False, border=0)``."""
        out = [
            '<table class="dataframe">',
            "  <thead>",
            '    <tr style="text-align: right;">',
        ]
        out += [f"      <th>{_cell_text(name)}</th>" for name in self.columns]
        out += ["    </tr>", "  </thead>", "  <tbody>"]
        cells = [_format_column(kind, col) for kind, col in zip(self.kinds, self.data)]
        for row in zip(*cells):
            out.append("    <tr>")
            out += [f"      <td>{_cell_text(text)}</td>" for text in row]
            out.append("    </tr>")
        out += ["  </tbody>", "</table>"]
        return "\n".join(out)


def _cell_text(text: str) -> str:
    text = text.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
    return text.strip().replace("  ", "&nbsp;&nbsp;")


def _escape_controls(text: str) -> str:
    return text.replace("\t", "\\t").replace("\r", "\\r").replace("\n", "\\n")


def _trim_zeros(texts: list[str]) -> list[str]:
    """pandas' ``_trim_zeros_float``."""

    def numbers(values):
        return [x for x in values if _DECIMAL_NUMBER.fullmatch(x)]

    while (nums := numbers(texts)) and all(x.endswith("0") for x in nums):
        texts = [x[:-1] if _DECIMAL_NUMBER.fullmatch(x) else x for x in texts]
    return [
        x + "0" if _DECIMAL_NUMBER.fullmatch(x) and x.endswith(".") else x
        for x in texts
    ]


def format_float_column(values: list[float]) -> list[str]:
    """pandas' ``FloatArrayFormatter`` as ``to_html(index=False)`` runs it:
    precision 6, no leading space, NaN as ``NaN``."""

    def with_format(spec: str) -> list[str]:
        texts = ["NaN" if math.isnan(v) else format(v, spec) for v in values]
        return _trim_zeros(texts)

    texts = with_format(f".{PRECISION}f")
    too_long = bool(texts) and max(len(x) for x in texts) > PRECISION + 6
    finite = [abs(v) for v in values if not math.isnan(v)]
    has_large = any(a > 1e6 for a in finite)
    has_small = any(0 < a < 10.0 ** -PRECISION for a in finite)
    if has_small or (too_long and has_large):
        texts = with_format(f".{PRECISION}e")
    return texts


def _format_column(kind: str, values: list) -> list[str]:
    if kind == "float":
        return format_float_column([float(v) for v in values])
    if kind == "str":
        return ["NaN" if v is None else _escape_controls(v) for v in values]
    return ["NaN" if v is None else str(v) for v in values]


def _infer(fields: list[str | None]) -> tuple[str, list]:
    """(pandas type, values) of one column of raw fields (None missing)."""
    present = [f for f in fields if f is not None]
    n_missing = len(fields) - len(present)
    if not fields:
        return "object", []
    if not present:
        return "float", [math.nan] * len(fields)
    if all(_INT.fullmatch(f) for f in present):
        if not n_missing:
            return "int", [int(f) for f in fields]
        return "float", [math.nan if f is None else float(int(f)) for f in fields]
    if all(_FLOAT.fullmatch(f) for f in present):
        return "float", [math.nan if f is None else float(f) for f in fields]
    if all(f in TRUE_STRINGS or f in FALSE_STRINGS for f in present):
        values = [None if f is None else f in TRUE_STRINGS for f in fields]
        return ("object" if n_missing else "bool"), values
    return "str", list(fields)


def _header_names(row: list[str]) -> list[str]:
    names, seen = [], {}
    for i, name in enumerate(row):
        if name == "":
            name = f"Unnamed: {i}"
        base = name
        while name in seen:
            seen[base] += 1
            name = f"{base}.{seen[base]}"
        seen.setdefault(name, 0)
        names.append(name)
    return names


def _csv_rows(text: str) -> list[list[str]]:
    """The rows of ``text``: a quote left open at the end raises, as in
    pandas; a quote closed mid-field (``"x"y``) joins the rest, as in
    pandas (which the strict reader refuses, so the lenient one reads it).
    A field may be as long as the text, as in pandas."""
    def read(strict: bool) -> list[list[str]]:
        limit = csv.field_size_limit(max(len(text), 131_072))
        try:
            return list(csv.reader(io.StringIO(text, newline=""), strict=strict))
        finally:
            csv.field_size_limit(limit)

    try:
        return read(strict=True)
    except csv.Error as exc:
        if "unexpected end of data" in str(exc):
            raise CsvParseError(
                "Error tokenizing data. C error: EOF inside string") from exc
    try:
        return read(strict=False)
    except csv.Error as exc:
        raise CsvParseError(f"Error tokenizing data: {exc}") from exc


def parse_csv_text(text: str, keep_default_na: bool = True) -> CsvFrame:
    """``pd.read_csv`` on ``text`` with its defaults (see the module);
    ``keep_default_na=False`` makes no field missing, so "" stays a str."""
    na_strings = NA_STRINGS if keep_default_na else frozenset()
    text = text.removeprefix("\ufeff")
    rows = []
    for line_no, row in enumerate(_csv_rows(text), 1):
        # An empty line, or one of spaces and tabs only, is blank; a quoted
        # empty field ("") is a missing value.
        if not row or (len(row) == 1 and row[0] and not row[0].strip()):
            continue
        rows.append((line_no, row))
    if not rows:
        raise CsvParseError("No columns to parse from file")
    names = _header_names(rows[0][1])
    body = rows[1:]
    n = len(names)
    implicit_index = bool(body) and len(body[0][1]) == n + 1
    width = n + 1 if implicit_index else n
    columns: list[list[str | None]] = [[] for _ in range(n)]
    for line_no, row in body:
        if len(row) > width:
            raise CsvParseError(
                "Error tokenizing data. C error: Expected"
                f" {width} fields in line {line_no}, saw {len(row)}\n"
            )
        if implicit_index:
            row = row[1:]
        for col, field in zip(columns, row):
            col.append(None if field in na_strings else field)
        for col in columns[len(row):]:
            col.append(None)
    kinds, data = [], []
    for col in columns:
        kind, values = _infer(col)
        kinds.append(kind)
        data.append(values)
    return CsvFrame(names, kinds, data)


def read_csv(path: str | Path, keep_default_na: bool = True) -> CsvFrame:
    """``pd.read_csv(path, keep_default_na=...)``: UTF-8, a leading
    byte-order mark dropped."""
    try:
        text = Path(path).read_bytes().decode("utf-8")
    except UnicodeDecodeError as exc:
        raise CsvParseError(f"'utf-8' codec can't decode the file: {exc}") from exc
    return parse_csv_text(text, keep_default_na)
