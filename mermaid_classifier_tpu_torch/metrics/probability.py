"""Probability metric group: log loss overall + per top-level category.

The port of ``mermaid_classifier_tpu/metrics/probability.py`` on numpy,
numbers and tables only (no figure). The overall log loss is
``train.trainer.log_loss``, sklearn 1.9's ``log_loss(labels=...)``.
"""

from __future__ import annotations

import numpy as np

from mermaid_classifier_tpu_torch.common.table import Table
from mermaid_classifier_tpu_torch.metrics.context import MetricsContext
from mermaid_classifier_tpu_torch.metrics.groups import metric_group
from mermaid_classifier_tpu_torch.metrics.outputs import GroupOutput
from mermaid_classifier_tpu_torch.metrics.taxonomy_index import (
    build_ba_to_top,
    group_by_top_level,
)
from mermaid_classifier_tpu_torch.train.trainer import log_loss


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
    return out
