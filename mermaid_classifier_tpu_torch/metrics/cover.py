"""Cover metric group: per-image cover reconstruction quality.

Cover = the fraction of an image's points assigned to each class — the
quantity reef monitoring actually consumes. Per-class bias/RMSE/MAE/R²
between predicted and true per-image cover vectors, aggregated over classes
with > 0.5% mean cover.

The port of ``mermaid_classifier_tpu/metrics/cover.py`` on numpy:
``r2_score`` in sklearn 1.9's formula, the per-class table sorted as pandas
sorts it (``Table.sort_values``; tied covers keep pandas' order) with NaN
``r_squared`` cells written empty, and the bias figure as a ``Drawing``.
"""

from __future__ import annotations

import numpy as np

from mermaid_classifier_tpu_torch.common.plots import pyplot
from mermaid_classifier_tpu_torch.common.table import Table
from mermaid_classifier_tpu_torch.metrics.context import MetricsContext
from mermaid_classifier_tpu_torch.metrics.groups import metric_group
from mermaid_classifier_tpu_torch.metrics.outputs import GroupOutput


def r2_score(y_true, y_pred) -> float:
    """sklearn 1.9's ``r2_score`` of two 1-D arrays (``force_finite``): 1
    for a perfect prediction, 0 for an imperfect one of a constant truth,
    NaN for fewer than two samples."""
    y_true = np.asarray(y_true, dtype=np.float64).reshape(-1, 1)
    y_pred = np.asarray(y_pred, dtype=np.float64).reshape(-1, 1)
    if len(y_true) < 2:
        return float("nan")
    numerator = np.sum((y_true - y_pred) ** 2, axis=0)[0]
    denominator = np.sum((y_true - np.average(y_true, axis=0)) ** 2, axis=0)[0]
    if numerator == 0:
        return 1.0
    if denominator == 0:
        return 0.0
    return float(1 - numerator / denominator)


def _bias_figure(data: dict):
    """Bars of the per-class cover bias ("names", "bias")."""
    plt = pyplot()
    names, bias = data["names"], data["bias"]
    top_n = len(names)
    fig, ax = plt.subplots(figsize=(10, 6))
    try:
        colors = ["#d32f2f" if b > 0 else "#1976d2" for b in bias]
        ax.barh(range(top_n), bias, color=colors)
        ax.set_yticks(range(top_n))
        ax.set_yticklabels(names, fontsize=9)
        ax.set_xlabel("Cover Bias (%)")
        ax.set_title("Per-Class Cover Bias (top classes by mean cover)")
        ax.axvline(x=0, color="black", linewidth=0.5)
        ax.invert_yaxis()
        plt.tight_layout()
    except Exception:
        plt.close(fig)
        raise
    return fig


@metric_group("cover", needs=("dataset",))
def compute_cover(ctx: MetricsContext) -> GroupOutput:
    val_results = ctx.val_results
    dataset = ctx.dataset
    assert dataset is not None
    classes = list(val_results.classes)

    present = sorted({classes[i] for i in set(val_results.gt) | set(val_results.est)})
    class_to_idx = {c: i for i, c in enumerate(present)}
    n_classes = len(present)

    gt_labels = [classes[i] for i in val_results.gt]
    est_labels = [classes[i] for i in val_results.est]

    # Per-image cover vectors: evaluate_classifier streams images in sorted
    # key order with each image's points contiguous (data/labels.py), so the
    # flat gt/est arrays slice cleanly per image.
    val_images = sorted(dataset.labels.val.data.keys())
    true_cover = np.zeros((len(val_images), n_classes))
    pred_cover = np.zeros((len(val_images), n_classes))
    offset = 0
    for img_idx, key in enumerate(val_images):
        n_points = len(dataset.labels.val.data[key])
        for label in gt_labels[offset : offset + n_points]:
            true_cover[img_idx, class_to_idx[label]] += 1
        for label in est_labels[offset : offset + n_points]:
            pred_cover[img_idx, class_to_idx[label]] += 1
        true_cover[img_idx] /= n_points
        pred_cover[img_idx] /= n_points
        offset += n_points

    errors = pred_cover - true_cover
    per_class_r2 = np.full(n_classes, np.nan)
    for i in range(n_classes):
        if true_cover[:, i].std() > 0:
            per_class_r2[i] = r2_score(true_cover[:, i], pred_cover[:, i])

    cover = Table.from_columns(
        {
            "bagf_id": present,
            "bagf_name": [
                ctx.ba_library.bagf_id_to_name(c, ctx.gf_library) for c in present
            ],
            "mean_true_cover_pct": true_cover.mean(axis=0) * 100,
            "bias_pct": errors.mean(axis=0) * 100,
            "rmse_pct": np.sqrt((errors**2).mean(axis=0)) * 100,
            "mae_pct": np.abs(errors).mean(axis=0) * 100,
            "r_squared": per_class_r2,
        }
    ).sort_values("mean_true_cover_pct", ascending=False)

    significant = Table(
        cover.columns,
        [r for r, c in zip(cover.rows, cover.column("mean_true_cover_pct"))
         if c > 0.5],
    )
    out = GroupOutput()
    if len(significant) > 0:
        bias = np.asarray(significant.column("bias_pct"))
        r2_values = np.asarray(significant.column("r_squared"))
        r2_values = r2_values[~np.isnan(r2_values)]
        median_r2 = float(np.median(r2_values)) if len(r2_values) else float("nan")
        out.scalar("cover_mean_abs_bias_pct", float(np.abs(bias).mean()))
        out.scalar(
            "cover_mean_rmse_pct", float(np.mean(significant.column("rmse_pct")))
        )
        out.scalar(
            "cover_mean_mae_pct", float(np.mean(significant.column("mae_pct")))
        )
        out.scalar("cover_median_r_squared", median_r2)
    else:
        for name in (
            "cover_mean_abs_bias_pct",
            "cover_mean_rmse_pct",
            "cover_mean_mae_pct",
            "cover_median_r_squared",
        ):
            out.scalar(name, 0.0)

    out.table(cover, "cover/per_class_cover_metrics")

    top_n = min(20, len(significant))
    if top_n > 0:
        out.figure(
            _bias_figure,
            {"names": significant.column("bagf_name")[:top_n],
             "bias": [float(b) for b in significant.column("bias_pct")[:top_n]]},
            "cover/per_class_bias.png",
        )
    return out
