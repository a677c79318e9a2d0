"""Training-config directory generator.

The port's own copy of ``mermaid_classifier_tpu/config/generate.py``, on
``Table`` in place of DataFrames. From the BA taxonomy plus per-class
annotation counts, it writes a committed config dir:

- ``included_labels.csv``   — the label set the classifier trains on;
- ``rollups.csv``           — every other annotated label rolled up to its
  nearest included ancestor;
- ``sources.csv``           — the source list (passed through);
- ``training_config.yaml``  — a ready-to-run config referencing the CSVs;
- ``README.md``             — the audit trail: how the label set was chosen.

Every file has the JAX generator's bytes for the same inputs: the CSVs go
through ``Table.to_csv_text`` (pandas' ``to_csv`` text), the YAML is the same
template and the README the same audit lines.

Selection policy (the reference's top-N ancestor walk, genericized):

1. Rank benthic attributes by total annotation count (GFs summed). The
   ranking is pandas': the per-BA sums in sorted-id order (``groupby``),
   then ``sort_values(ascending=False)``, whose quicksort decides the order
   of tied sums (``pandas_sort_order``), and so which BAs a tie at the
   top-N cut selects.
2. Keep the top ``top_n`` BAs, minus ``excluded_names``.
3. For selected BAs listed in ``gf_buckets``, keep the named (BA, GF)
   combos as distinct labels (the reference's Porites growth-form buckets);
   all other GFs of that BA roll up to the bare BA.
4. Every non-selected annotated BA rolls up to its nearest selected
   ancestor (root-ward walk); BAs with no selected ancestor are excluded
   (recorded in the README).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from mermaid_classifier_tpu_torch.common.relational import pandas_str
from mermaid_classifier_tpu_torch.common.table import (
    Table,
    as_table,
    pandas_sort_order,
    to_csv_text,
)
from mermaid_classifier_tpu_torch.common.taxonomy import (
    BenthicAttributeLibrary,
    GrowthFormLibrary,
)


@dataclass
class GeneratedConfig:
    included: Table                 # columns ba_id, gf_id
    rollups: Table                  # columns from_ba_id, from_gf_id, to_ba_id, to_gf_id
    excluded: list[str] = field(default_factory=list)  # ba_ids with no home

    @property
    def n_labels(self) -> int:
        return len(self.included)


def _ranked_bas(counts: Table) -> list:
    """``counts.groupby("ba_id")["count"].sum().sort_values(ascending=False)
    .index``: a missing id is dropped, the ids sorted, and the sums ordered
    by pandas' descending quicksort."""
    sums: dict = {}
    for ba_id, count in zip(counts.column("ba_id"), counts.column("count")):
        if ba_id is None or ba_id != ba_id:
            continue
        sums[ba_id] = sums.get(ba_id, 0) + count
    ids = sorted(sums)
    order = pandas_sort_order([sums[b] for b in ids], ascending=False)
    return [ids[i] for i in order]


def _drop_duplicates(rows: list[tuple]) -> list[tuple]:
    """``DataFrame.drop_duplicates()``: the first of equal rows kept."""
    seen: set = set()
    out = []
    for row in rows:
        if row not in seen:
            seen.add(row)
            out.append(row)
    return out


def select_labels(
    ba_library: BenthicAttributeLibrary,
    counts: Any,
    *,
    top_n: int = 100,
    excluded_names: set[str] | None = None,
    gf_buckets: dict[str, list[str]] | None = None,
    gf_library: GrowthFormLibrary | None = None,
) -> GeneratedConfig:
    """Apply the selection policy; ``counts`` (a Table, records or a dict of
    columns) has columns (ba_id, gf_id, count)."""
    excluded_names = excluded_names or set()
    gf_buckets = gf_buckets or {}
    counts = as_table(counts)
    required = {"ba_id", "gf_id", "count"}
    if missing := required - set(counts.columns):
        raise ValueError(f"counts is missing columns {sorted(missing)}")

    ranked = _ranked_bas(counts)
    unknown = [b for b in ranked if b not in ba_library.by_id]
    if unknown:
        raise ValueError(f"counts references unknown ba_ids: {unknown[:5]}")

    selected: list[str] = []
    for ba_id in ranked:
        if ba_library.id_to_name(ba_id) in excluded_names:
            continue
        selected.append(ba_id)
        if len(selected) >= top_n:
            break
    selected_set = set(selected)

    # GF buckets: named (BA, GF) combos become distinct labels.
    bucket_rows: list[tuple] = []
    bucket_index: dict[str, set[str]] = {}
    for ba_name, gf_names in gf_buckets.items():
        ba_id = ba_library.name_to_id(ba_name)
        if ba_id not in selected_set:
            raise ValueError(
                f"gf_buckets names {ba_name!r}, which is not a selected label."
            )
        if gf_library is None:
            raise ValueError("gf_buckets requires gf_library.")
        gf_ids = set()
        for gf_name in gf_names:
            matches = [i for i, n in gf_library.by_id.items() if n == gf_name]
            if not matches:
                raise ValueError(f"unknown growth form name {gf_name!r}.")
            gf_ids.add(matches[0])
        bucket_index[ba_id] = gf_ids
        bucket_rows.extend((ba_id, gf_id) for gf_id in sorted(gf_ids))

    included_rows = [(ba_id, "") for ba_id in selected] + bucket_rows

    # The annotated GFs of each BA, as ``astype(str)`` gives them.
    gf_strs: dict = {}
    for ba_id, gf_id in zip(counts.column("ba_id"), pandas_str(counts.column("gf_id"))):
        gf_strs.setdefault(ba_id, set()).add(gf_id)

    # Rollups. Every annotated (ba, gf) combo must end at an included label
    # or be explicitly excluded: nothing may silently fall through the
    # inclusion filter.
    rollup_rows: list[tuple] = []
    excluded_ids: list[str] = []
    for ba_id in ranked:
        annotated_gfs = gf_strs[ba_id]
        if ba_id in selected_set:
            # GFs outside the BA's bucket set (all GFs, for non-bucketed
            # BAs) collapse to the bare BA.
            kept_gfs = bucket_index.get(ba_id, set())
            for gf_id in sorted((annotated_gfs - {""}) - kept_gfs):
                rollup_rows.append((ba_id, gf_id, ba_id, ""))
            continue
        target = next(
            (a for a in reversed(ba_library.get_ancestor_ids(ba_id))
             if a in selected_set),
            None,
        )
        if target is None:
            excluded_ids.append(ba_id)
            continue
        # One rule per annotated combo of this BA (GF'd or bare), all
        # landing on the bare target label.
        for gf_id in sorted(annotated_gfs):
            rollup_rows.append((ba_id, gf_id, target, ""))

    return GeneratedConfig(
        included=Table(["ba_id", "gf_id"], _drop_duplicates(included_rows)),
        rollups=Table(
            ["from_ba_id", "from_gf_id", "to_ba_id", "to_gf_id"], rollup_rows
        ),
        excluded=excluded_ids,
    )


_CONFIG_YAML = """\
dataset:
  include_mermaid: true
  label_rollup_spec_csv: rollups.csv
  included_labels_csv: included_labels.csv
  ref_val_ratios: [0.1, 0.1]
  subsample:
    strategy: balanced
    total_annotations: {total_annotations}
    min_per_class: {min_per_class}
  weighting:
    enabled: true
    weight_ratio_cap: 5000
training:
  epochs: {epochs}
  early_stopping_patience: 3
tracking:
  experiment_name: {experiment_name}
"""


def write_config_dir(
    output_dir: str | Path,
    generated: GeneratedConfig,
    ba_library: BenthicAttributeLibrary,
    *,
    sources: list[str] | None = None,
    total_annotations: int = 500_000,
    min_per_class: int = 200,
    epochs: int = 40,
    experiment_name: str = "mermaid-classifier",
) -> Path:
    """Write the committed config dir + audit README."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    def write(name: str, text: str) -> None:
        with open(output_dir / name, "w", newline="") as f:
            f.write(text)

    write("included_labels.csv", to_csv_text(generated.included))
    write("rollups.csv", to_csv_text(generated.rollups))
    if sources:
        write("sources.csv", to_csv_text({"source_id": list(sources)}))
    (output_dir / "training_config.yaml").write_text(
        _CONFIG_YAML.format(
            total_annotations=total_annotations,
            min_per_class=min_per_class,
            epochs=epochs,
            experiment_name=experiment_name,
        )
    )

    def name(ba_id: str) -> str:
        return ba_library.id_to_name(ba_id) if ba_id else ""

    included = generated.included.records()
    lines = [
        "# Training config audit",
        "",
        f"- {generated.n_labels} included labels"
        f" ({sum(r['gf_id'] != '' for r in included)} with"
        " growth-form buckets).",
        f"- {len(generated.rollups)} rollup rules.",
        f"- {len(generated.excluded)} annotated attributes excluded (no"
        " selected ancestor):",
    ]
    lines += [f"  - {name(b)} ({b})" for b in generated.excluded] or ["  - none"]
    lines += ["", "## Included labels", ""]
    lines += [
        f"- {name(r['ba_id'])}" + (f" [{r['gf_id']}]" if r["gf_id"] else "")
        for r in included
    ]
    (output_dir / "README.md").write_text("\n".join(lines) + "\n")
    return output_dir
