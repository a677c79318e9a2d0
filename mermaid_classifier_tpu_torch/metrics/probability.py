"""Probability metric group: log loss overall + per top-level category.

The port of ``mermaid_classifier_tpu/metrics/probability.py`` on numpy,
with its bar figure as a ``Drawing``. The overall log loss is
``train.trainer.log_loss``, sklearn 1.9's ``log_loss(labels=...)`` (the
dtype of ``val_proba`` decides its eps, as in sklearn).
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
from mermaid_classifier_tpu_torch.train.trainer import log_loss


def _category_figure(data: dict):
    """Bars of the per-category log loss ("names", "losses") with the
    overall loss ("overall") as a dashed line."""
    plt = pyplot()
    names, losses, overall = data["names"], data["losses"], data["overall"]
    fig, ax = plt.subplots(figsize=(10, max(4, len(names) * 0.45)))
    try:
        ax.barh(range(len(names)), losses, color="#d32f2f", alpha=0.85)
        ax.set_yticks(range(len(names)))
        ax.set_yticklabels(names)
        ax.invert_yaxis()
        ax.set_xlabel("Log Loss (nats)")
        ax.set_title("Log Loss by Top-Level Category")
        ax.axvline(
            overall,
            color="#1976d2",
            linestyle="--",
            label=f"Overall: {overall:.3f}",
        )
        ax.legend(loc="lower right")
        plt.tight_layout()
    except Exception:
        plt.close(fig)
        raise
    return fig


@metric_group("probability", needs=("val_proba",))
def compute_probability(ctx: MetricsContext) -> GroupOutput:
    assert ctx.val_proba is not None and ctx.val_gt_labels is not None
    val_proba = ctx.val_proba
    val_gt_labels = ctx.val_gt_labels
    classes = list(ctx.clf.classes_)

    out = GroupOutput()
    overall_ll = float(log_loss(val_gt_labels, val_proba, labels=classes))
    out.scalar("log_loss", overall_ll)

    class_to_idx = {c: i for i, c in enumerate(classes)}
    gt_cols = np.asarray([class_to_idx[g] for g in val_gt_labels])
    p_true = val_proba[np.arange(len(val_proba)), gt_cols]
    sample_losses = -np.log(np.clip(p_true, 1e-15, 1.0))

    ba_to_top = ctx.ba_to_top or build_ba_to_top(classes, ctx.ba_library)
    groups = group_by_top_level(
        list(range(len(val_gt_labels))),
        list(gt_cols),
        classes,
        ba_to_top,
        ctx.ba_library,
        min_samples=30,
    )
    cat_rows = [
        {
            "category": group["name"],
            "log_loss": float(np.mean(sample_losses[group["indices"]])),
            "n_samples": group["n_samples"],
        }
        for group in groups
    ]
    cat_rows.sort(key=lambda r: r["log_loss"], reverse=True)
    out.table(
        Table.from_records(cat_rows, ["category", "log_loss", "n_samples"]),
        "probability/per_category_log_loss",
    )
    if cat_rows:
        out.figure(
            _category_figure,
            {"names": [r["category"] for r in cat_rows],
             "losses": [r["log_loss"] for r in cat_rows],
             "overall": overall_ll},
            "probability/per_category_log_loss.png",
        )
    return out
