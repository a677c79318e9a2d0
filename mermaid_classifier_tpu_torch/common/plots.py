"""Plotting helpers: annotated-point overlays on reef images, and the
confusion-matrix display the metric figures draw.

The port's own copy of ``mermaid_classifier_tpu/common/plots.py``
(``PointMarker``, ``group_style``, ``plot_point_markers``, ``plot_legend``)
plus ``matplotlib_importable``, ``pyplot`` and ``confusion_display``. matplotlib is imported inside
the calls only, so every module of the port imports where matplotlib does
not (the H100 machine has none).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from itertools import product
from typing import Any

import numpy as np


def matplotlib_importable() -> bool:
    """Whether matplotlib imports here (the H100 machine has none)."""
    try:
        importlib.import_module("matplotlib")
    except ImportError:
        return False
    return True


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, imported at call time."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


@dataclass
class PointMarker:
    """One annotated point: position, marker shape/color group, and an
    optional text label drawn next to it."""

    row: int
    col: int
    group: str = ""
    text: str = ""
    extras: dict[str, Any] = field(default_factory=dict)


_MARKER_CYCLE = ("o", "s", "^", "D", "v", "P", "X", "*")
_COLOR_CYCLE = (
    "#e6194b", "#3cb44b", "#ffe119", "#4363d8", "#f58231",
    "#911eb4", "#46f0f0", "#f032e6", "#bcf60c", "#fabebe",
)


def group_style(index: int) -> dict[str, Any]:
    """Deterministic marker/color pairing for the index-th group."""
    return {
        "marker": _MARKER_CYCLE[index % len(_MARKER_CYCLE)],
        "color": _COLOR_CYCLE[index % len(_COLOR_CYCLE)],
    }


def plot_point_markers(
    ax: Any,
    markers: list[PointMarker],
    *,
    marker_size: float = 90.0,
    text_size: float = 9.0,
    text_offset: tuple[float, float] = (6.0, -6.0),
) -> dict[str, dict[str, Any]]:
    """Draw grouped scatter markers with outlined text on ``ax``.

    Returns {group: style} so a legend can be built with ``plot_legend``.
    Groups are assigned styles in first-appearance order (stable across
    calls with the same marker list).
    """
    import matplotlib.patheffects as path_effects

    styles: dict[str, dict[str, Any]] = {}
    for m in markers:
        if m.group not in styles:
            styles[m.group] = group_style(len(styles))

    for group, style in styles.items():
        cols = [m.col for m in markers if m.group == group]
        rows = [m.row for m in markers if m.group == group]
        ax.scatter(
            cols,
            rows,
            s=marker_size,
            marker=style["marker"],
            facecolors="none",
            edgecolors=style["color"],
            linewidths=2.0,
            label=group,
        )
    for m in markers:
        if not m.text:
            continue
        txt = ax.annotate(
            m.text,
            (m.col, m.row),
            xytext=text_offset,
            textcoords="offset points",
            fontsize=text_size,
            color="white",
        )
        # White text with a black outline stays readable on any reef pixel.
        txt.set_path_effects(
            [path_effects.Stroke(linewidth=2.0, foreground="black"),
             path_effects.Normal()]
        )
    return styles


def plot_legend(styles: dict[str, dict[str, Any]], *, figsize=(4.0, None)):
    """Build a standalone legend figure from a {group: style} mapping.
    Returns the matplotlib Figure."""
    plt = pyplot()
    from matplotlib.lines import Line2D

    height = figsize[1] if figsize[1] is not None else max(1.0, 0.3 * len(styles))
    fig, ax = plt.subplots(figsize=(figsize[0], height))
    handles = [
        Line2D(
            [], [],
            marker=style["marker"],
            linestyle="none",
            markerfacecolor="none",
            markeredgecolor=style["color"],
            markeredgewidth=2.0,
            label=group,
        )
        for group, style in styles.items()
    ]
    ax.legend(handles=handles, loc="center", frameon=False)
    ax.axis("off")
    return fig


def confusion_display(ax: Any, matrix: np.ndarray, labels: list[str],
                      cmap: str = "Blues") -> None:
    """Draw an integer confusion matrix on ``ax`` as sklearn 1.9's
    ``ConfusionMatrixDisplay(matrix, display_labels=labels).plot(ax=ax,
    cmap=cmap, values_format="d", colorbar=False)`` draws it: the image,
    one centred count per cell in the colormap's far colour, the labels as
    ticks, "Predicted label" / "True label", rows top to bottom."""
    plt = pyplot()
    n = matrix.shape[0]
    im = ax.imshow(matrix, interpolation="nearest", cmap=cmap)
    cmap_min, cmap_max = im.cmap(0), im.cmap(1.0)
    thresh = (matrix.max() + matrix.min()) / 2.0
    for i, j in product(range(n), range(n)):
        color = cmap_max if matrix[i, j] < thresh else cmap_min
        ax.text(j, i, format(matrix[i, j], "d"), ha="center", va="center",
                color=color)
    ax.set(
        xticks=np.arange(n),
        yticks=np.arange(n),
        xticklabels=labels,
        yticklabels=labels,
        ylabel="True label",
        xlabel="Predicted label",
    )
    ax.set_ylim((n - 0.5, -0.5))
    plt.setp(ax.get_xticklabels(), rotation="horizontal")
