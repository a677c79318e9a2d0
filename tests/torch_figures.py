"""What a matplotlib figure plots, for holding the port's figures to the JAX
package's without comparing PNG bytes (the JAX confusion figures go
through sklearn's display, the port's through its own): the size, and per
axes the title, axis labels, ticks and tick labels, limits, ``imshow``
arrays, bars, lines, collections (scatter offsets, filled areas), texts
and legend entries. ``assert_same_plot`` holds strings equal and numbers
within 1e-12."""

from __future__ import annotations

import numpy as np


def plotted(fig) -> dict:
    fig.canvas.draw()
    axes = []
    for ax in fig.axes:
        legend = ax.get_legend()
        axes.append({
            "title": ax.get_title(),
            "xlabel": ax.get_xlabel(),
            "ylabel": ax.get_ylabel(),
            "xticks": list(ax.get_xticks()),
            "yticks": list(ax.get_yticks()),
            "xticklabels": [t.get_text() for t in ax.get_xticklabels()],
            "yticklabels": [t.get_text() for t in ax.get_yticklabels()],
            "xlim": list(ax.get_xlim()),
            "ylim": list(ax.get_ylim()),
            "images": [np.asarray(im.get_array(), float) for im in ax.images],
            "bars": [[p.get_x(), p.get_y(), p.get_width(), p.get_height()]
                     for p in ax.patches],
            "lines": [np.asarray(line.get_xydata(), float) for line in ax.get_lines()],
            "collections": [
                [np.asarray(c.get_offsets(), float)]
                + [np.asarray(p.vertices, float) for p in c.get_paths()]
                for c in ax.collections
            ],
            "texts": [[t.get_text(), *map(float, t.get_position())] for t in ax.texts],
            "legend": [t.get_text() for t in legend.get_texts()] if legend else None,
        })
    return {"size": list(map(float, fig.get_size_inches())), "axes": axes}


def assert_same_plot(got, want, where="figure"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            assert_same_plot(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape, where
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=where)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (
            where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_plot(g, w, f"{where}[{i}]")
    elif isinstance(want, str) or want is None:
        assert got == want, (where, got, want)
    else:
        assert abs(float(got) - float(want)) <= 1e-12, (where, got, want)
