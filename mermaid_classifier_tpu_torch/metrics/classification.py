"""Classification metric groups: confusion matrices, per-label and macro
P/R/F1, balanced accuracy + MCC.

The port of ``mermaid_classifier_tpu/metrics/classification.py`` on numpy
and scipy. The two confusion-matrix figures are ``Drawing``s the
coordinator draws (``common.plots.confusion_display`` in place of sklearn's
``ConfusionMatrixDisplay``), with the JAX size and dpi caps. Each sklearn
call of the JAX groups has a numpy counterpart with sklearn 1.9's
semantics:

- ``confusion_matrix`` over ``labels`` with ``normalize="true"`` (rows
  divided by their sums, 0 for an empty row);
- ``cosine_distances``: rows L2-normalised (a norm below 10 eps counts as
  1), ``1 - X X^T`` clipped to [0, 2], zero diagonal;
- macro ``precision_score`` / ``recall_score`` with ``zero_division=0.0``,
  averaged over the sorted labels present in gt or est, and macro
  ``precision_recall_fscore_support`` (the per-source group's);
- ``balanced_accuracy_score``: the mean recall over the labels in gt, with
  sklearn's warnings;
- multiclass ``matthews_corrcoef``.

The clustering order is scipy's average ``linkage`` and ``leaves_list``, as
in JAX.
"""

from __future__ import annotations

import warnings
from collections import Counter

import numpy as np

from mermaid_classifier_tpu_torch.common.plots import confusion_display, pyplot
from mermaid_classifier_tpu_torch.common.table import Table
from mermaid_classifier_tpu_torch.metrics.context import MetricsContext
from mermaid_classifier_tpu_torch.metrics.groups import metric_group
from mermaid_classifier_tpu_torch.metrics.outputs import GroupOutput


def confusion_matrix(y_true, y_pred, n_labels: int, normalize: bool = False):
    """(n_labels, n_labels) counts of (true, predicted) label indices;
    with ``normalize`` each row divided by its sum (an empty row stays 0)."""
    cm = np.zeros((n_labels, n_labels), dtype=np.int64)
    np.add.at(cm, (np.asarray(y_true, np.int64), np.asarray(y_pred, np.int64)), 1)
    if not normalize:
        return cm
    with np.errstate(all="ignore"):
        out = cm / cm.sum(axis=1, keepdims=True)
    return np.nan_to_num(out)


def cosine_distances(x: np.ndarray) -> np.ndarray:
    """sklearn's ``cosine_distances(X)`` for a dense float64 X."""
    x = np.asarray(x, dtype=np.float64)
    norms = np.sqrt(np.einsum("ij,ij->i", x, x))
    norms[norms < 10 * np.finfo(norms.dtype).eps] = 1.0
    xn = x / norms[:, None]
    s = xn @ xn.T
    s *= -1
    s += 1
    s = np.clip(s, 0.0, 2.0)
    np.fill_diagonal(s, 0.0)
    return s


def _label_codes(gt_labels, est_labels):
    """(sorted unique labels of gt and est, gt codes, est codes)."""
    labels, codes = np.unique(
        np.concatenate([np.asarray(gt_labels), np.asarray(est_labels)]),
        return_inverse=True,
    )
    n = len(gt_labels)
    return labels, codes[:n], codes[n:]


def _macro_divide(num: np.ndarray, den: np.ndarray) -> float:
    den = den.astype(np.float64)
    mask = den == 0
    den[mask] = 1
    result = num.astype(np.float64) / den
    result[mask] = 0.0
    return float(np.mean(result))


def precision_recall_macro(gt_labels, est_labels) -> tuple[float, float]:
    """Macro precision and recall, ``zero_division=0.0``."""
    labels, gt, est = _label_codes(gt_labels, est_labels)
    cm = confusion_matrix(gt, est, len(labels))
    tp = np.diag(cm)
    return (
        _macro_divide(tp, cm.sum(axis=0)),
        _macro_divide(tp, cm.sum(axis=1)),
    )


def precision_recall_fscore_macro(gt_labels, est_labels) -> tuple[float, float, float]:
    """``precision_recall_fscore_support(average="macro",
    zero_division=0)``'s precision, recall and F1 (F1 from the counts,
    2 tp / (true + predicted))."""
    labels, gt, est = _label_codes(gt_labels, est_labels)
    cm = confusion_matrix(gt, est, len(labels))
    tp = np.diag(cm)
    pred_sum, true_sum = cm.sum(axis=0), cm.sum(axis=1)
    return (
        _macro_divide(tp, pred_sum),
        _macro_divide(tp, true_sum),
        _macro_divide(2.0 * tp, true_sum + pred_sum),
    )


def balanced_accuracy_score(gt_labels, est_labels) -> float:
    """sklearn's, with its two UserWarnings: one label in all, and
    predicted labels that never occur in gt."""
    labels, gt, est = _label_codes(gt_labels, est_labels)
    cm = confusion_matrix(gt, est, len(labels))
    if cm.shape == (1, 1):
        warnings.warn(
            "A single label was found in 'y_true' and 'y_pred'. For the confusion "
            "matrix to have the correct shape, use the 'labels' parameter to pass "
            "all known labels.",
            UserWarning,
        )
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.diag(cm) / cm.sum(axis=1)
    if np.any(np.isnan(per_class)):
        warnings.warn("y_pred contains classes not in y_true")
        per_class = per_class[~np.isnan(per_class)]
    return float(np.mean(per_class))


def matthews_corrcoef(gt_labels, est_labels) -> float:
    labels, gt, est = _label_codes(gt_labels, est_labels)
    cm = confusion_matrix(gt, est, len(labels))
    t_sum = cm.sum(axis=1, dtype=np.float64)
    p_sum = cm.sum(axis=0, dtype=np.float64)
    n_correct = np.trace(cm, dtype=np.float64)
    n_samples = p_sum.sum()
    cov_ytyp = n_correct * n_samples - np.dot(t_sum, p_sum)
    cov_ypyp = n_samples**2 - np.dot(p_sum, p_sum)
    cov_ytyt = n_samples**2 - np.dot(t_sum, t_sum)
    cov_ypyp_ytyt = cov_ypyp * cov_ytyt
    if cov_ypyp_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ypyp_ytyt))


def _hierarchical_class_order(val_results) -> list[int]:
    """Order classes by hierarchically clustering their row-normalized
    confusion profiles, revealing block structure."""
    from scipy.cluster.hierarchy import leaves_list, linkage
    from scipy.spatial.distance import squareform

    n_classes = len(val_results.classes)
    if n_classes < 3:
        return list(range(n_classes))
    cm = confusion_matrix(val_results.gt, val_results.est, n_classes)
    row_sums = cm.sum(axis=1, keepdims=True)
    row_sums[row_sums == 0] = 1
    profiles = cm / row_sums
    dist = cosine_distances(profiles)
    np.fill_diagonal(dist, 0)
    dist = (dist + dist.T) / 2
    linkage_matrix = linkage(squareform(dist, checks=False), method="average")
    return [int(i) for i in leaves_list(linkage_matrix)]


# Longest raster side for confusion-matrix PNGs. At 80 classes the figure
# is 48 in; dpi 100 with bbox_inches="tight" re-renders the 6,400-text
# canvas twice at 4800 px. Capping the long side at 2400 px (>= 30 px per
# cell at 80 classes) and saving without the tight-bbox measuring pass
# keeps the content and cuts the time (the JAX package's caps).
_CONFUSION_MAX_RASTER_PX = 2400


def _confusion_size(n: int) -> float:
    return max(12, n * 0.6)


def _confusion_figure(data: dict):
    """The confusion-matrix figure of ``data`` ("matrix", "names"), ticks on
    top, tight layout."""
    plt = pyplot()
    names = data["names"]
    n = len(names)
    fig_size = _confusion_size(n)
    fig, ax = plt.subplots(figsize=(fig_size, fig_size))
    try:
        confusion_display(ax, data["matrix"], names)
        ax.xaxis.set_label_position("top")
        ax.xaxis.set_ticks_position("top")
        font_size = max(8, min(12, 150 / max(n, 1)))
        plt.setp(
            ax.get_xticklabels(),
            rotation=45,
            ha="left",
            rotation_mode="anchor",
            fontsize=font_size,
        )
        plt.setp(ax.get_yticklabels(), fontsize=font_size)
        plt.tight_layout()
    except Exception:
        plt.close(fig)
        raise
    return fig


@metric_group("confusion_matrices")
def compute_confusion_matrices(ctx: MetricsContext) -> GroupOutput:
    """Frequency and percent-normalized confusion matrices, rows/cols
    reordered by the clustering order, as CSV + figure artifacts."""
    out = GroupOutput()
    val_results = ctx.val_results
    order = _hierarchical_class_order(val_results)
    names = [
        ctx.ba_library.bagf_id_to_name(val_results.classes[i], ctx.gf_library)
        for i in order
    ]
    n = len(val_results.classes)
    for normalize, filestem in (
        (False, "confusion_matrix/frequencies"),
        (True, "confusion_matrix/percents"),
    ):
        matrix = confusion_matrix(val_results.gt, val_results.est, n, normalize)
        if normalize:
            # 0-1 fractions -> integer percents for readability.
            matrix = np.floor(matrix * 100).astype(np.int64)
        matrix = matrix[np.ix_(order, order)]
        out.table(
            Table(["-", *names],
                  [(name, *row) for name, row in zip(names, matrix.tolist())]),
            filestem,
        )
        # The raster cap, and no tight-bbox pass (the drawing already ran
        # tight_layout).
        dpi = min(100.0, _CONFUSION_MAX_RASTER_PX / _confusion_size(len(names)))
        out.figure(_confusion_figure, {"matrix": matrix, "names": names},
                   filestem + ".png", dpi=dpi, bbox_inches=None)
    return out


@metric_group("precision_recall_f1")
def compute_precision_recall_f1(ctx: MetricsContext) -> GroupOutput:
    """Per-label P/R/F1 (CSV) + macro P/R/F1 (scalars and YAML)."""
    val_results = ctx.val_results
    classes = list(val_results.classes)
    gt_labels = [classes[i] for i in val_results.gt]
    est_labels = [classes[i] for i in val_results.est]
    label_counts = Counter(gt_labels)

    # Per-label: one-vs-rest counts. For a single label, precision =
    # TP/(TP+FP) and recall = TP/(TP+FN) with 0 for empty denominators.
    per_label = []
    gt_arr = np.asarray(gt_labels)
    est_arr = np.asarray(est_labels)
    for label in classes:
        tp = int(np.sum((gt_arr == label) & (est_arr == label)))
        fp = int(np.sum((gt_arr != label) & (est_arr == label)))
        fn = int(np.sum((gt_arr == label) & (est_arr != label)))
        precision = tp / (tp + fp) if (tp + fp) else 0.0
        recall = tp / (tp + fn) if (tp + fn) else 0.0
        f1 = (
            2 * precision * recall / (precision + recall)
            if (precision + recall)
            else 0.0
        )
        per_label.append(
            {
                "bagf_name": ctx.ba_library.bagf_id_to_name(label, ctx.gf_library),
                "precision": ctx.format_func(precision),
                "recall": ctx.format_func(recall),
                "f1_score": ctx.format_func(f1),
                "n_samples": int(label_counts.get(label, 0)),
                "bagf_id": label,
            }
        )

    precision_macro, recall_macro = precision_recall_macro(gt_labels, est_labels)
    f1_macro = (
        2 * precision_macro * recall_macro / (precision_macro + recall_macro)
        if (precision_macro + recall_macro) > 0
        else 0.0
    )
    overall = {
        "precision_macro": ctx.format_func(precision_macro),
        "recall_macro": ctx.format_func(recall_macro),
        "f1_macro": ctx.format_func(f1_macro),
    }

    out = GroupOutput()
    for k, v in overall.items():
        out.scalar(k, v)
    out.table(Table.from_records(per_label), "metrics_per_label")
    out.mapping(overall, "metrics_overall.yaml")
    return out


@metric_group("balanced_accuracy_mcc")
def compute_balanced_accuracy_mcc(ctx: MetricsContext) -> GroupOutput:
    """Balanced accuracy (macro recall) + Matthews correlation coefficient."""
    classes = list(ctx.val_results.classes)
    gt_labels = [classes[i] for i in ctx.val_results.gt]
    est_labels = [classes[i] for i in ctx.val_results.est]
    return (
        GroupOutput()
        .scalar(
            "balanced_accuracy",
            ctx.format_func(balanced_accuracy_score(gt_labels, est_labels)),
        )
        .scalar("mcc", ctx.format_func(matthews_corrcoef(gt_labels, est_labels)))
    )
