"""Taxonomic metric group: LCA error attribution, top-level confusion, and
growth-form differentiation.

The port of ``mermaid_classifier_tpu/metrics/taxonomic.py`` on numpy: the
same tables (``Table``) and three figures as ``Drawing``s, the two
confusion figures through ``common.plots.confusion_display`` in place of
sklearn's ``ConfusionMatrixDisplay``.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from mermaid_classifier_tpu_torch.common.plots import confusion_display, pyplot
from mermaid_classifier_tpu_torch.common.table import Table
from mermaid_classifier_tpu_torch.common.taxonomy import split_ba_gf
from mermaid_classifier_tpu_torch.metrics.context import MetricsContext
from mermaid_classifier_tpu_torch.metrics.groups import metric_group
from mermaid_classifier_tpu_torch.metrics.outputs import GroupOutput
from mermaid_classifier_tpu_torch.metrics.taxonomy_index import (
    build_ba_paths,
    build_ba_to_top,
    find_lca,
)


@metric_group("taxonomic")
def compute_taxonomic(ctx: MetricsContext) -> GroupOutput:
    return (
        GroupOutput()
        .merge(_error_attribution(ctx))
        .merge(_top_level_confusion(ctx))
        .merge(_gf_differentiation(ctx))
    )


def _attribution_figure(data: dict):
    """Errors per LCA node ("names", "counts"), cross-branch in red
    ("cross")."""
    plt = pyplot()
    names, counts = data["names"], data["counts"]
    fig, ax = plt.subplots(figsize=(11, max(4, len(names) * 0.4)))
    try:
        colors = ["#d32f2f" if cross else "#1976d2" for cross in data["cross"]]
        ax.barh(range(len(names)), counts, color=colors)
        ax.set_yticks(range(len(names)))
        ax.set_yticklabels(names, fontsize=9)
        ax.invert_yaxis()
        ax.set_xlabel("Number of errors")
        ax.set_title("Error Attribution by Taxonomy Node")
        plt.tight_layout()
    except Exception:
        plt.close(fig)
        raise
    return fig


def _error_attribution(ctx: MetricsContext) -> GroupOutput:
    """Attribute each misclassification to the LCA of its true/predicted BA;
    LCA None = cross-branch (different top level)."""
    val_results = ctx.val_results
    classes = list(val_results.classes)
    ba_library = ctx.ba_library
    ba_paths = ctx.ba_paths or build_ba_paths(classes, ba_library)

    def branch_of(ba_id: str) -> str:
        if ba_id in ba_paths:
            return ba_paths[ba_id][0]
        return ba_library.top_level_ancestor(ba_id)

    lca_counts: Counter = Counter()
    total_errors = 0
    for gt_idx, est_idx in zip(val_results.gt, val_results.est):
        if gt_idx == est_idx:
            continue
        total_errors += 1
        ba_gt, _ = split_ba_gf(classes[gt_idx])
        ba_est, _ = split_ba_gf(classes[est_idx])
        lca_counts[find_lca(ba_gt, ba_est, ba_paths)] += 1

    out = GroupOutput()
    columns = [
        "lca_node",
        "lca_name",
        "branch",
        "error_count",
        "pct_of_errors",
        "classes_in_subtree",
    ]
    if total_errors == 0:
        out.scalar("cross_branch_error_rate", 0.0)
        out.scalar("within_branch_error_rate", 0.0)
        out.table(Table(columns), "taxonomic/error_attribution")
        return out

    cross = lca_counts.get(None, 0)
    out.scalar("cross_branch_error_rate", cross / total_errors)
    out.scalar(
        "within_branch_error_rate", (total_errors - cross) / total_errors
    )

    # Model classes under each LCA node, for the artifact's context column.
    model_ba_ids = {split_ba_gf(c)[0] for c in classes}
    rows = []
    for node, count in lca_counts.most_common():
        if node is None:
            rows.append(
                {
                    "lca_node": "(cross-branch)",
                    "lca_name": "(cross-branch)",
                    "branch": "",
                    "error_count": count,
                    "pct_of_errors": count / total_errors * 100,
                    "classes_in_subtree": 0,
                }
            )
        else:
            subtree_ids = {d["id"] for d in ba_library.get_descendants(node)} | {node}
            rows.append(
                {
                    "lca_node": node,
                    "lca_name": ba_library.id_to_name(node),
                    "branch": ba_library.id_to_name(branch_of(node)),
                    "error_count": count,
                    "pct_of_errors": count / total_errors * 100,
                    "classes_in_subtree": len(subtree_ids & model_ba_ids),
                }
            )
    out.table(Table.from_records(rows, columns), "taxonomic/error_attribution")

    top = lca_counts.most_common(20)
    out.figure(
        _attribution_figure,
        {"names": ["(cross-branch)" if node is None else ba_library.id_to_name(node)
                   for node, _ in top],
         "counts": [c for _, c in top],
         "cross": [node is None for node, _ in top]},
        "taxonomic/error_attribution.png",
    )
    return out


def _top_level_figure(data: dict):
    """The row-normalized top-level confusion ("matrix", "names")."""
    plt = pyplot()
    n = len(data["names"])
    fig, ax = plt.subplots(figsize=(max(8, n * 0.7), max(8, n * 0.7)))
    try:
        confusion_display(ax, data["matrix"], data["names"])
        ax.set_title("Top-Level Confusion (row-normalized %)", pad=20)
        ax.xaxis.set_label_position("top")
        ax.xaxis.set_ticks_position("top")
        plt.setp(ax.get_xticklabels(), rotation=45, ha="left", rotation_mode="anchor")
        plt.tight_layout()
    except Exception:
        plt.close(fig)
        raise
    return fig


def _top_level_confusion(ctx: MetricsContext) -> GroupOutput:
    """Row-normalized confusion matrix at the top-level BA granularity."""
    val_results = ctx.val_results
    classes = list(val_results.classes)
    ba_library = ctx.ba_library
    ba_to_top = ctx.ba_to_top or build_ba_to_top(classes, ba_library)

    top_gt, top_est = [], []
    for gt_idx, est_idx in zip(val_results.gt, val_results.est):
        top_gt.append(ba_to_top[split_ba_gf(classes[gt_idx])[0]])
        top_est.append(ba_to_top[split_ba_gf(classes[est_idx])[0]])

    gt_counts = Counter(top_gt)
    order = [tid for tid, _ in gt_counts.most_common()]
    order.extend(sorted(set(top_est) - set(order)))
    names = [ba_library.id_to_name(t) for t in order]
    idx = {t: i for i, t in enumerate(order)}

    n = len(order)
    cm = np.zeros((n, n), dtype=int)
    for g, e in zip(top_gt, top_est):
        cm[idx[g], idx[e]] += 1
    row_sums = cm.sum(axis=1, keepdims=True)
    row_sums[row_sums == 0] = 1
    cm_pct = np.floor(cm / row_sums * 100).astype(np.int64)

    out = GroupOutput()
    out.figure(_top_level_figure, {"matrix": cm_pct, "names": names},
               "taxonomic/top_level_confusion.png")

    confusions = [
        {
            "true": names[i],
            "predicted": names[j],
            "row_normalized_pct": int(cm_pct[i, j]),
            "sample_count": int(cm[i, j]),
        }
        for i in range(n)
        for j in range(n)
        if i != j and cm[i, j] > 0
    ]
    confusions.sort(key=lambda r: r["row_normalized_pct"], reverse=True)
    out.table(
        Table.from_records(
            confusions, ["true", "predicted", "row_normalized_pct", "sample_count"]
        ),
        "taxonomic/top_level_confusions",
    )
    return out


def _gf_figure(data: dict):
    """The growth-form confusion over GF-relevant samples ("matrix",
    "names")."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(max(6, len(data["names"]) * 0.8),) * 2)
    try:
        confusion_display(ax, data["matrix"], data["names"])
        ax.set_title("Growth-Form Confusion (GF-relevant samples)")
        plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
        plt.tight_layout()
    except Exception:
        plt.close(fig)
        raise
    return fig


def _gf_differentiation(ctx: MetricsContext) -> GroupOutput:
    """Growth-form prediction quality: accuracy among GF-relevant samples,
    GF accuracy when the BA was right, per-GF P/R/F1, GF confusion figure."""
    val_results = ctx.val_results
    classes = list(val_results.classes)
    gf_library = ctx.gf_library

    true_gf, pred_gf, ba_match = [], [], []
    for gt_idx, est_idx in zip(val_results.gt, val_results.est):
        gt_ba, gt_gf = split_ba_gf(classes[gt_idx])
        est_ba, est_gf = split_ba_gf(classes[est_idx])
        true_gf.append(gf_library.id_to_name(gt_gf) if gt_gf else "(no GF)")
        pred_gf.append(gf_library.id_to_name(est_gf) if est_gf else "(no GF)")
        ba_match.append(gt_ba == est_ba)

    true_gf_arr = np.asarray(true_gf)
    pred_gf_arr = np.asarray(pred_gf)
    ba_match_arr = np.asarray(ba_match)
    has_gf = true_gf_arr != "(no GF)"
    n_relevant = int(has_gf.sum())

    out = GroupOutput()
    prf_columns = ["growth_form", "precision", "recall", "f1", "support"]
    if n_relevant == 0:
        out.scalar("gf_accuracy_gf_relevant", 0.0)
        out.scalar("within_ba_gf_accuracy", 0.0)
        out.table(Table(prf_columns), "taxonomic/gf_precision_recall_f1")
        return out

    gf_acc = float((true_gf_arr[has_gf] == pred_gf_arr[has_gf]).mean())
    within_mask = has_gf & ba_match_arr
    within_acc = (
        float((true_gf_arr[within_mask] == pred_gf_arr[within_mask]).mean())
        if within_mask.any()
        else float("nan")
    )
    out.scalar("gf_accuracy_gf_relevant", gf_acc)
    out.scalar("within_ba_gf_accuracy", within_acc)

    gf_order = [name for name, _ in Counter(true_gf_arr[has_gf]).most_common()]
    prf_rows = []
    for gf in gf_order:
        tp = int(np.sum((true_gf_arr == gf) & (pred_gf_arr == gf)))
        fp = int(np.sum((true_gf_arr != gf) & (pred_gf_arr == gf)))
        fn = int(np.sum((true_gf_arr == gf) & (pred_gf_arr != gf)))
        precision = tp / (tp + fp) if (tp + fp) else 0.0
        recall = tp / (tp + fn) if (tp + fn) else 0.0
        f1 = 2 * precision * recall / (precision + recall) if (precision + recall) else 0.0
        prf_rows.append(
            {
                "growth_form": gf,
                "precision": round(precision, 4),
                "recall": round(recall, 4),
                "f1": round(f1, 4),
                "support": int(np.sum(true_gf_arr == gf)),
            }
        )
    out.table(Table.from_records(prf_rows, prf_columns),
              "taxonomic/gf_precision_recall_f1")

    # GF confusion figure over GF-relevant samples.
    all_gfs = gf_order + sorted(set(pred_gf_arr[has_gf]) - set(gf_order))
    gf_idx = {g: i for i, g in enumerate(all_gfs)}
    cm = np.zeros((len(all_gfs), len(all_gfs)), dtype=int)
    for t, p in zip(true_gf_arr[has_gf], pred_gf_arr[has_gf]):
        cm[gf_idx[t], gf_idx[p]] += 1
    out.figure(_gf_figure, {"matrix": cm, "names": [str(g) for g in all_gfs]},
               "taxonomic/gf_confusion.png")
    return out
