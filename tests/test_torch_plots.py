"""The port's plotting helpers and ``Run.log_figure`` against the JAX
package's: ``plot_point_markers`` and ``plot_legend`` plot the same data
(``tests/torch_figures.py``), ``confusion_display`` plots what sklearn's
``ConfusionMatrixDisplay`` plots, and ``log_figure`` saves as the JAX
tracker saves (``bbox_inches="tight"`` unless the caller says otherwise)
and closes the figure even when saving fails."""

import numpy as np
import pytest

from mermaid_classifier_tpu.common import plots as jplots
from mermaid_classifier_tpu.tracking.local_tracker import LocalTracker as JTracker
from mermaid_classifier_tpu_torch.common import plots as tplots
from mermaid_classifier_tpu_torch.tracking.local_tracker import LocalTracker as TTracker
from tests.torch_figures import assert_same_plot, plotted


def _markers(mod, n=30, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.PointMarker(row=int(r), col=int(c), group=f"g{int(g)}",
                            text="" if i % 4 == 0 else f"{p:.2f}")
            for i, (r, c, g, p) in enumerate(zip(
                rng.integers(0, 90, n), rng.integers(0, 120, n),
                rng.integers(0, 11, n), rng.random(n)))]


def test_point_markers_and_legend_match_jax():
    import matplotlib.pyplot as plt

    out = {}
    for name, mod in (("jax", jplots), ("port", tplots)):
        fig, ax = plt.subplots()
        ax.imshow(np.zeros((90, 120, 3), np.uint8))
        styles = mod.plot_point_markers(ax, _markers(mod))
        legend = mod.plot_legend(styles)
        out[name] = (styles, plotted(fig), plotted(legend))
        plt.close(fig)
        plt.close(legend)
    assert out["port"][0] == out["jax"][0]
    assert len(out["jax"][0]) == 11  # the marker cycle wraps
    assert_same_plot(out["port"][1], out["jax"][1], "markers")
    assert_same_plot(out["port"][2], out["jax"][2], "legend")


@pytest.mark.parametrize("n", [1, 3, 7])
def test_confusion_display_matches_sklearn(n):
    import matplotlib.pyplot as plt
    from sklearn.metrics import ConfusionMatrixDisplay

    rng = np.random.default_rng(n)
    matrix = rng.integers(0, 40, (n, n))
    labels = [f"class {i}" for i in range(n)]
    fig_s, ax_s = plt.subplots()
    ConfusionMatrixDisplay(confusion_matrix=matrix, display_labels=labels).plot(
        ax=ax_s, cmap="Blues", values_format="d", colorbar=False)
    fig_t, ax_t = plt.subplots()
    tplots.confusion_display(ax_t, matrix, labels)
    try:
        assert_same_plot(plotted(fig_t), plotted(fig_s), "confusion")
        assert [t.get_color() for t in ax_t.texts] == [t.get_color() for t in ax_s.texts]
    finally:
        plt.close(fig_s)
        plt.close(fig_t)


def test_log_figure_saves_like_jax(tmp_path, monkeypatch):
    import matplotlib.pyplot as plt

    calls = {}
    for name, tracker in (("jax", JTracker), ("port", TTracker)):
        run = tracker(tmp_path / name).start_run("figs")
        fig, ax = plt.subplots()
        ax.plot([0, 1], [1, 0])
        seen = []
        real = fig.savefig
        monkeypatch.setattr(fig, "savefig", lambda path, **kw: (seen.append(kw),
                                                                 real(path, **kw)))
        run.log_figure(fig, "a/default.png")
        fig2, _ = plt.subplots()
        monkeypatch.setattr(fig2, "savefig", lambda path, **kw: (seen.append(kw),
                                                                 real(path, **kw)))
        run.log_figure(fig2, "a/capped.png", dpi=20, bbox_inches=None)
        calls[name] = seen
        assert run.artifact("a/default.png").read_bytes()[:4] == b"\x89PNG"
        assert not plt.fignum_exists(fig.number) and not plt.fignum_exists(fig2.number)
    assert calls["port"] == calls["jax"] == [
        {"bbox_inches": "tight"}, {"bbox_inches": None, "dpi": 20}]


def test_log_figure_closes_on_failure(tmp_path):
    import matplotlib.pyplot as plt

    run = TTracker(tmp_path).start_run("figs")
    fig, _ = plt.subplots()

    def broken(*args, **kwargs):
        raise OSError("disk full")

    fig.savefig = broken
    with pytest.raises(OSError, match="disk full"):
        run.log_figure(fig, "x.png")
    assert not plt.fignum_exists(fig.number)
