"""Per-source metric group: validation metrics grouped by data source, with
the alignment invariant check.

The port of ``mermaid_classifier_tpu/metrics/per_source.py`` on numpy:
``accuracy_score`` (``train.trainer``), ``balanced_accuracy_score`` and
macro ``precision_recall_fscore_support`` (``metrics.classification``) in
sklearn 1.9's semantics, with the JAX group's filter of the single-label
warning. The table is sorted as pandas sorts it (``Table.sort_values``:
sources with equal annotation counts keep pandas' order), and the figure
is a ``Drawing``.
"""

from __future__ import annotations

import warnings
from collections import Counter

import numpy as np

from mermaid_classifier_tpu_torch.common.plots import pyplot
from mermaid_classifier_tpu_torch.common.table import Table
from mermaid_classifier_tpu_torch.common.taxonomy import split_ba_gf
from mermaid_classifier_tpu_torch.metrics.classification import (
    balanced_accuracy_score,
    precision_recall_fscore_macro,
)
from mermaid_classifier_tpu_torch.metrics.context import MetricsContext
from mermaid_classifier_tpu_torch.metrics.groups import metric_group
from mermaid_classifier_tpu_torch.metrics.outputs import GroupOutput
from mermaid_classifier_tpu_torch.metrics.taxonomy_index import (
    build_ba_paths,
    find_lca,
)
from mermaid_classifier_tpu_torch.train.trainer import accuracy_score


def _accuracy_figure(data: dict):
    """Bars of each source's ("sources") validation accuracy ("accuracy")."""
    plt = pyplot()
    sources, accuracy = data["sources"], data["accuracy"]
    fig, ax = plt.subplots(figsize=(10, max(4, len(sources) * 0.4)))
    try:
        ax.barh(range(len(sources)), accuracy, color="#1976d2", alpha=0.85)
        ax.set_yticks(range(len(sources)))
        ax.set_yticklabels(sources, fontsize=9)
        ax.invert_yaxis()
        ax.set_xlim(0, 1.05)
        ax.set_xlabel("Accuracy")
        ax.set_title("Validation Accuracy by Source")
        plt.tight_layout()
    except Exception:
        plt.close(fig)
        raise
    return fig


@metric_group("per_source", needs=("dataset",))
def compute_per_source(ctx: MetricsContext) -> GroupOutput:
    val_results = ctx.val_results
    dataset = ctx.dataset
    assert dataset is not None
    classes = list(val_results.classes)
    out = GroupOutput()

    feature_path_to_source = getattr(dataset, "feature_path_to_source", None)
    if not feature_path_to_source:
        # Re-evaluation paths may lack the per-image source map; skip.
        return out

    # Per-val-index source keys: evaluate_classifier streams images in
    # sorted key order, each image's points contiguous.
    source_per_index: list[str] = []
    images_per_source: Counter = Counter()
    for key in sorted(dataset.labels.val.data.keys()):
        site, project_id = feature_path_to_source[key]
        source_key = f"{site}:{project_id}"
        source_per_index.extend([source_key] * len(dataset.labels.val.data[key]))
        images_per_source[source_key] += 1

    if len(source_per_index) != len(val_results.gt):
        # Defensive: never emit a silently-misaligned breakdown.
        raise ValueError(
            f"Per-source index count ({len(source_per_index)}) does not match"
            f" val_results length ({len(val_results.gt)})."
            " dataset.labels.val iteration order may have diverged from"
            " evaluate_classifier."
        )

    sources = np.asarray(source_per_index)
    gt = np.asarray(val_results.gt)
    est = np.asarray(val_results.est)
    ba_paths = ctx.ba_paths or build_ba_paths(classes, ctx.ba_library)

    rows = []
    accuracies = []
    for source_key in sorted(set(source_per_index)):
        mask = sources == source_key
        gt_s, est_s = gt[mask], est[mask]
        n = int(mask.sum())
        if n == 0:
            continue
        site, source_id = source_key.split(":", 1)
        accuracy = float(accuracy_score(gt_s, est_s))
        accuracies.append(accuracy)
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings(
                    "ignore",
                    message="A single label was found in 'y_true' and 'y_pred'",
                    category=UserWarning,
                )
                balanced_acc = float(balanced_accuracy_score(gt_s, est_s))
        except ValueError:
            balanced_acc = float("nan")
        prec, rec, f1 = precision_recall_fscore_macro(gt_s, est_s)

        err_total = err_cross = 0
        for g, e in zip(gt_s, est_s):
            if g == e:
                continue
            err_total += 1
            if (
                find_lca(
                    split_ba_gf(classes[g])[0], split_ba_gf(classes[e])[0], ba_paths
                )
                is None
            ):
                err_cross += 1
        rows.append(
            {
                "source_key": source_key,
                "site": site,
                "source_id": source_id,
                "num_val_images": int(images_per_source[source_key]),
                "num_val_annotations": n,
                "accuracy": round(accuracy, 4),
                "balanced_accuracy": round(balanced_acc, 4),
                "f1_macro": round(float(f1), 4),
                "precision_macro": round(float(prec), 4),
                "recall_macro": round(float(rec), 4),
                "cross_branch_error_rate": round(
                    err_cross / err_total if err_total else 0.0, 4
                ),
            }
        )

    if not rows:
        return out

    table = Table.from_records(rows).sort_values(
        "num_val_annotations", ascending=False
    )
    out.table(table, "per_source/metrics")
    out.scalar("per_source/n_sources", float(len(rows)))
    out.scalar("per_source/min_accuracy", float(min(accuracies)))
    out.scalar("per_source/max_accuracy", float(max(accuracies)))

    if len(table) > 1:
        out.figure(
            _accuracy_figure,
            {"sources": table.column("source_key"),
             "accuracy": table.column("accuracy")},
            "per_source/accuracy_by_source.png",
        )
    return out
