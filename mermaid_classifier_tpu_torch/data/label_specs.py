"""CSV-defined label specifications applied in the relational engine.

The port's own copy of ``mermaid_classifier_tpu/data/label_specs.py``, on
the port's sqlite relational layer and stdlib CSV specs (no pandas):

- ``LabelFilter``: include/exclude specific BA+GF combos. An empty exclusion
  set accepts everything; an empty inclusion set accepts nothing.
- ``LabelRollupSpec``: map fine-grained BA+GF combos onto coarser ones;
  combos not in the spec pass through unchanged.
- ``CNSourceFilter``: the set of CoralNet source IDs to include.

Both in-db operations follow the reference's single-column discipline:
concatenate BA+GF into one combo column, run the distinct-values transform/
filter, split back, drop the scratch column — so the Python function runs
once per distinct combo, never per row.
"""

from __future__ import annotations

from typing import IO, Any

from mermaid_classifier_tpu_torch.common.csv_utils import ColumnSpec, CsvSpec
from mermaid_classifier_tpu_torch.common.relational import Database
from mermaid_classifier_tpu_torch.common.taxonomy import combine_ba_gf, split_ba_gf

_SCRATCH = "_bagf_combo"


def _add_combo_column(
    db: Database, table: str, ba_column: str, gf_column: str
) -> None:
    db.add_column_from(table, _SCRATCH, [ba_column, gf_column], combine_ba_gf)


def _drop_column(db: Database, table: str, column: str) -> None:
    db.execute(f'ALTER TABLE "{table}" DROP COLUMN "{column}"')


class LabelFilter(CsvSpec):
    """Include/exclude BA+GF combos (reference: label_specs.py:26-91)."""

    COLUMNS = (
        ColumnSpec("ba_id"),
        ColumnSpec("gf_id", required=False),
    )

    def __init__(self, csv_file: str | IO[str], inclusion: bool = True):
        self.bagf_set: set[tuple[str, str]] = set()
        super().__init__(csv_file)
        self.inclusion = inclusion

    def handle_row(self, row: dict[str, Any]) -> None:
        self.bagf_set.add((row["ba_id"] or "", row.get("gf_id") or ""))

    def accepts_bagf(self, bagf_id: str | None) -> bool:
        if bagf_id is None:
            return not self.inclusion
        key = split_ba_gf(bagf_id)
        return (key in self.bagf_set) == self.inclusion

    def filter_in_db(
        self,
        db: Database,
        table: str,
        ba_column: str = "benthic_attribute_id",
        gf_column: str = "growth_form_id",
    ) -> int:
        """Filter the table's rows by this spec; returns rows deleted."""
        _add_combo_column(db, table, ba_column, gf_column)
        deleted = db.filter_on_column(table, _SCRATCH, self.accepts_bagf)
        _drop_column(db, table, _SCRATCH)
        return deleted


class LabelRollupSpec(CsvSpec):
    """Roll up BA+GF combos to coarser combos
    (reference: label_specs.py:94-189)."""

    COLUMNS = (
        ColumnSpec("from_ba_id"),
        ColumnSpec("from_gf_id", required=False),
        ColumnSpec("to_ba_id"),
        ColumnSpec("to_gf_id", required=False),
    )

    def __init__(self, csv_file: str | IO[str]):
        self.lookup: dict[tuple[str, str], tuple[str, str]] = {}
        super().__init__(csv_file)

    def handle_row(self, row: dict[str, Any]) -> None:
        key = (row["from_ba_id"] or "", row.get("from_gf_id") or "")
        value = (row["to_ba_id"] or "", row.get("to_gf_id") or "")
        self.lookup[key] = value

    def roll_up(self, bagf_id: str | None) -> str | None:
        if bagf_id is None:
            return None
        key = split_ba_gf(bagf_id)
        if key in self.lookup:
            return combine_ba_gf(*self.lookup[key])
        return bagf_id

    def roll_up_in_db(
        self,
        db: Database,
        table: str,
        ba_column: str = "benthic_attribute_id",
        gf_column: str = "growth_form_id",
    ) -> None:
        """Apply the rollup to the BA/GF id columns in place."""
        _add_combo_column(db, table, ba_column, gf_column)
        db.transform_column(table, _SCRATCH, self.roll_up)
        # Split the (possibly rolled-up) combo back into the id columns.
        db.execute(
            f'UPDATE "{table}" SET'
            f' "{ba_column}" = substr("{_SCRATCH}", 1, instr("{_SCRATCH}", \'::\') - 1),'
            f' "{gf_column}" = substr("{_SCRATCH}", instr("{_SCRATCH}", \'::\') + 2)'
            f' WHERE "{_SCRATCH}" IS NOT NULL'
        )
        _drop_column(db, table, _SCRATCH)


class CNSourceFilter(CsvSpec):
    """The CoralNet source IDs to include
    (reference: label_specs.py:192-212)."""

    COLUMNS = (ColumnSpec("id"),)

    def __init__(self, csv_file: str | IO[str]):
        self.source_id_list: list[str] = []
        super().__init__(csv_file)

    def handle_row(self, row: dict[str, Any]) -> None:
        self.source_id_list.append(row["id"] or "")

    def is_empty(self) -> bool:
        return not self.source_id_list
