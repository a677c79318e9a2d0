"""Calibration metric group: adaptive (equal-mass) ECE, reliability diagram,
per-category ECE.

The port of ``mermaid_classifier_tpu/metrics/calibration.py`` on numpy: the
same bins (``np.argsort`` of the confidences, numpy's default kind, so
ties fall into the same bins), tables as ``Table``s and the reliability
diagram as a ``Drawing``.
"""

from __future__ import annotations

import numpy as np

from mermaid_classifier_tpu_torch.common.plots import pyplot
from mermaid_classifier_tpu_torch.common.table import Table
from mermaid_classifier_tpu_torch.metrics.context import MetricsContext
from mermaid_classifier_tpu_torch.metrics.groups import metric_group
from mermaid_classifier_tpu_torch.metrics.outputs import GroupOutput
from mermaid_classifier_tpu_torch.metrics.taxonomy_index import (
    build_ba_to_top,
    group_by_top_level,
)


def adaptive_ece(
    confidences, gt_indices, est_indices, n_bins: int = 20
) -> tuple[float, list[dict]]:
    """ECE with equal-mass bins: sort by confidence, split into n_bins
    equal-count bins, weight |acc - conf| by bin mass."""
    confidences = np.asarray(confidences, dtype=float)
    accuracies = (np.asarray(est_indices) == np.asarray(gt_indices)).astype(float)
    order = np.argsort(confidences)
    confidences = confidences[order]
    accuracies = accuracies[order]

    n = len(confidences)
    edges = np.linspace(0, n, n_bins + 1, dtype=int)
    ece = 0.0
    bins: list[dict] = []
    for i in range(n_bins):
        start, end = edges[i], edges[i + 1]
        if start == end:
            continue
        conf = confidences[start:end]
        acc = accuracies[start:end]
        count = end - start
        ece += abs(acc.mean() - conf.mean()) * count / n
        bins.append(
            {
                "avg_confidence": float(conf.mean()),
                "avg_accuracy": float(acc.mean()),
                "count": int(count),
                "conf_min": float(conf.min()),
                "conf_max": float(conf.max()),
            }
        )
    return float(ece), bins


def _reliability_figure(data: dict):
    """The reliability diagram of ``data`` ("ece", "confs", "accs")."""
    plt = pyplot()
    confs, accs = data["confs"], data["accs"]
    fig, ax = plt.subplots(figsize=(7, 7))
    try:
        ax.plot([0, 1], [0, 1], "k--", linewidth=1, label="perfect calibration")
        ax.plot(confs, accs, "o-", color="#1976d2", label="model")
        ax.fill_between(confs, accs, confs, alpha=0.15, color="#d32f2f")
        ax.set_xlabel("Mean predicted confidence")
        ax.set_ylabel("Empirical accuracy")
        ax.set_title(f"Reliability diagram (adaptive ECE = {data['ece']:.4f})")
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        ax.legend(loc="upper left")
        plt.tight_layout()
    except Exception:
        plt.close(fig)
        raise
    return fig


@metric_group("calibration")
def compute_calibration(ctx: MetricsContext) -> GroupOutput:
    val_results = ctx.val_results
    out = GroupOutput()

    ece, bins = adaptive_ece(
        val_results.scores, val_results.gt, val_results.est, n_bins=20
    )
    out.scalar("ece", ece)

    rows = [
        {
            "bin": i + 1,
            "conf_min": b["conf_min"],
            "conf_max": b["conf_max"],
            "avg_confidence": b["avg_confidence"],
            "avg_accuracy": b["avg_accuracy"],
            "gap": b["avg_confidence"] - b["avg_accuracy"],
            "count": b["count"],
        }
        for i, b in enumerate(bins)
    ]
    out.table(Table.from_records(rows), "calibration/per_bin_details")
    out.figure(
        _reliability_figure,
        {"ece": ece,
         "confs": [b["avg_confidence"] for b in bins],
         "accs": [b["avg_accuracy"] for b in bins]},
        "calibration/reliability_diagram.png",
    )

    # Per-category (top-level BA) ECE with fewer bins per category.
    classes = list(val_results.classes)
    ba_to_top = ctx.ba_to_top or build_ba_to_top(classes, ctx.ba_library)
    groups = group_by_top_level(
        list(range(len(val_results.gt))),
        val_results.gt,
        classes,
        ba_to_top,
        ctx.ba_library,
        min_samples=30,
    )
    scores = np.asarray(val_results.scores)
    gt = np.asarray(val_results.gt)
    est = np.asarray(val_results.est)
    cat_rows = []
    for group in groups:
        idx = np.asarray(group["indices"])
        cat_ece, _ = adaptive_ece(scores[idx], gt[idx], est[idx], n_bins=10)
        cat_rows.append(
            {
                "category": group["name"],
                "ece": cat_ece,
                "n_samples": group["n_samples"],
            }
        )
    cat_rows.sort(key=lambda r: r["ece"], reverse=True)
    out.table(
        Table.from_records(cat_rows, ["category", "ece", "n_samples"]),
        "calibration/per_category_ece",
    )
    return out
