"""Ranking metric group: top-K accuracy, MRR, per-category top-K, and
hierarchical top-K with taxonomic similarity.

The port of ``mermaid_classifier_tpu/metrics/ranking.py`` on numpy. The
ranks come from ``np.argsort(-proba, axis=1)`` with numpy's default kind,
as in JAX (not ``torch.argsort``), so tied probabilities rank the same in
both packages. Tables are ``Table``s and the figure is a ``Drawing``.
"""

from __future__ import annotations

import numpy as np

from mermaid_classifier_tpu_torch.common.plots import pyplot
from mermaid_classifier_tpu_torch.common.table import Table
from mermaid_classifier_tpu_torch.common.taxonomy import split_ba_gf
from mermaid_classifier_tpu_torch.metrics.context import MetricsContext
from mermaid_classifier_tpu_torch.metrics.groups import metric_group
from mermaid_classifier_tpu_torch.metrics.outputs import GroupOutput
from mermaid_classifier_tpu_torch.metrics.taxonomy_index import (
    build_ba_paths,
    build_ba_to_top,
    group_by_top_level,
    taxonomic_similarity,
)

KS = (1, 3, 5, 10)


def topk_and_mrr(proba: np.ndarray, gt_labels: list, classes: list) -> dict:
    """Vectorized rank of the true class per sample: its position in the
    row's ``argsort(-proba)`` order, plus one (ties broken by that order)."""
    class_to_idx = {c: i for i, c in enumerate(classes)}
    sorted_indices = np.argsort(-proba, axis=1)
    gt_cols = np.asarray([class_to_idx[g] for g in gt_labels])
    # position of gt column within each row's sorted order
    ranks = np.argmax(sorted_indices == gt_cols[:, None], axis=1) + 1
    return {
        "topk": {k: float(np.mean(ranks <= k)) for k in KS},
        "mrr": float(np.mean(1.0 / ranks)),
        "ranks": ranks,
        "sorted_indices": sorted_indices,
    }


def _topk_figure(data: dict):
    """Grouped bars of each category's ("names") top-K accuracies
    ("topk": {k: values})."""
    plt = pyplot()
    names = data["names"]
    fig, ax = plt.subplots(figsize=(12, max(4, len(names) * 0.5)))
    try:
        y = np.arange(len(names))
        height = 0.18
        for i, k in enumerate(KS):
            ax.barh(
                y + i * height,
                data["topk"][k],
                height,
                label=f"Top-{k}",
                alpha=0.85,
            )
        ax.set_yticks(y + 1.5 * height)
        ax.set_yticklabels(names)
        ax.invert_yaxis()
        ax.set_xlim(0, 1.05)
        ax.set_xlabel("Accuracy")
        ax.set_title("Top-K Accuracy by Top-Level Category")
        ax.legend(loc="lower right")
        plt.tight_layout()
    except Exception:
        plt.close(fig)
        raise
    return fig


@metric_group("ranking", needs=("val_proba",))
def compute_ranking(ctx: MetricsContext) -> GroupOutput:
    assert ctx.val_proba is not None and ctx.val_gt_labels is not None
    val_proba = ctx.val_proba
    val_gt_labels = list(ctx.val_gt_labels)
    classes = list(ctx.clf.classes_)
    ba_library = ctx.ba_library

    out = GroupOutput()
    ranking = topk_and_mrr(val_proba, val_gt_labels, classes)
    for k in KS:
        out.scalar(f"top_{k}_accuracy", ranking["topk"][k])
    out.scalar("mrr", ranking["mrr"])

    # Per-category top-K.
    ba_to_top = ctx.ba_to_top or build_ba_to_top(classes, ba_library)
    class_to_idx = {c: i for i, c in enumerate(classes)}
    gt_cols = [class_to_idx[g] for g in val_gt_labels]
    groups = group_by_top_level(
        list(range(len(val_gt_labels))),
        gt_cols,
        classes,
        ba_to_top,
        ba_library,
        min_samples=30,
    )
    ranks = ranking["ranks"]
    cat_rows = []
    for group in groups:
        group_ranks = ranks[group["indices"]]
        row = {
            "category": group["name"],
            "n_samples": group["n_samples"],
            "mrr": float(np.mean(1.0 / group_ranks)),
        }
        for k in KS:
            row[f"top_{k}"] = float(np.mean(group_ranks <= k))
        cat_rows.append(row)
    cat_rows.sort(key=lambda r: r["top_1"], reverse=True)
    out.table(
        Table.from_records(cat_rows)
        if cat_rows
        else Table(["category", "top_1", "top_3", "top_5", "top_10", "mrr",
                    "n_samples"]),
        "ranking/per_category_topk",
    )
    if cat_rows:
        out.figure(
            _topk_figure,
            {"names": [r["category"] for r in cat_rows],
             "topk": {k: [r[f"top_{k}"] for r in cat_rows] for k in KS}},
            "ranking/per_category_topk.png",
        )

    # Hierarchical top-K: best taxonomic similarity within the top-k
    # predictions per sample.
    ba_paths = ctx.ba_paths or build_ba_paths(classes, ba_library)
    sorted_indices = ranking["sorted_indices"]
    class_ba_ids = [split_ba_gf(c)[0] for c in classes]
    gt_ba_ids = [split_ba_gf(g)[0] for g in val_gt_labels]
    max_k = max(KS)
    n = len(val_gt_labels)
    max_sim_at_k = {k: np.zeros(n) for k in KS}
    for i in range(n):
        sims = [
            taxonomic_similarity(gt_ba_ids[i], class_ba_ids[int(j)], ba_paths)
            for j in sorted_indices[i, :max_k]
        ]
        for k in KS:
            max_sim_at_k[k][i] = max(sims[:k])

    out.scalar(
        "hierarchical_top_5_mean_similarity", float(np.mean(max_sim_at_k[5]))
    )
    hier_rows = []
    threshold_labels = {1.0: "hit_exact", 0.75: "hit_sibling_0.75", 0.5: "hit_family_0.5"}
    for k in KS:
        row = {"k": k, "mean_max_similarity": float(np.mean(max_sim_at_k[k]))}
        for threshold, label in threshold_labels.items():
            row[label] = float(np.mean(max_sim_at_k[k] >= threshold))
        hier_rows.append(row)
    out.table(Table.from_records(hier_rows), "ranking/hierarchical_topk")
    return out
