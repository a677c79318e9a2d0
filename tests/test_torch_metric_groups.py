"""All nine of the port's metric groups against the JAX ones, with a
dataset in the context (the cover and per-source groups need its val
images and their sources).

The same ``ValResults``, ``val_proba``, taxonomy and val images go through
each package's group: the scalars agree within 1e-12 (NaN where JAX has
NaN), the tables are equal as CSV text, and each figure plots the same
data (``tests/torch_figures.py``). The cases hold ties (sources with equal
annotation counts, classes with equal mean cover, more than 16 rows so
pandas' unstable sort decides their order), NaN cells (classes that never
occur in gt have no R²), no errors at all, and a source of one label.
Then both coordinators over the same context write the same artifacts, and
the port's with matplotlib hidden writes the same scalars and tables and
names every figure in ``figures_not_written``. Also each numpy counterpart
of an sklearn or pandas call against the original."""

import sys
import warnings
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import sklearn.metrics as skm

from mermaid_classifier_tpu.common import taxonomy as jtax
from mermaid_classifier_tpu.data.results import ValResults as JVal
from mermaid_classifier_tpu.metrics import MetricsContext as JCtx
from mermaid_classifier_tpu.metrics import MetricsCoordinator as JCoord
from mermaid_classifier_tpu.metrics import all_groups as jgroups
from mermaid_classifier_tpu.metrics import calibration as jcal
from mermaid_classifier_tpu.metrics import ranking as jrank
from mermaid_classifier_tpu.tracking.local_tracker import LocalTracker as JTracker
from mermaid_classifier_tpu_torch.common import taxonomy as ttax
from mermaid_classifier_tpu_torch.common.table import pandas_sort_order, to_csv_text
from mermaid_classifier_tpu_torch.data.results import ValResults as TVal
from mermaid_classifier_tpu_torch.metrics import MetricsContext as TCtx
from mermaid_classifier_tpu_torch.metrics import MetricsCoordinator as TCoord
from mermaid_classifier_tpu_torch.metrics import all_groups as tgroups
from mermaid_classifier_tpu_torch.metrics import calibration as tcal
from mermaid_classifier_tpu_torch.metrics import classification as tcls
from mermaid_classifier_tpu_torch.metrics import cover as tcover
from mermaid_classifier_tpu_torch.metrics import ranking as trank
from mermaid_classifier_tpu_torch.tracking.local_tracker import LocalTracker as TTracker
from tests.test_torch_metrics import taxonomy, val_inputs
from tests.torch_figures import assert_same_plot, plotted

NEW_GROUPS = ("taxonomic", "calibration", "cover", "per_source", "ranking")


def _images(n_points, sources, seed):
    """Val images (sorted keys -> point counts) and their sources."""
    rng = np.random.default_rng(seed)
    counts, source_of = {}, {}
    total, i = 0, 0
    while total < n_points:
        key = f"s/img{i:05d}.features.npz"
        n = int(min(rng.integers(5, 15), n_points - total))
        counts[key] = n
        source_of[key] = sources[i % len(sources)]
        total += n
        i += 1
    return counts, source_of


def case_inputs(case):
    """(taxonomy records, gfs, classes, gt, est, scores, proba, image point
    counts, image sources)."""
    records, gfs, classes = taxonomy(n_roots=3, per_root=4)
    k = len(classes)
    rng = np.random.default_rng(7)
    if case == "ties":
        # 20 sources of 2 or 3 images of 12 points: annotation counts tied
        # in two groups of sources, and every image holds the same gt
        # multiset (equal covers).
        per_image = [int(c) for c in rng.choice(k, 12)]
        counts, source_of = {}, {}
        for s in range(20):
            for j in range(3 if s % 3 else 2):
                key = f"s/src{s:02d}_img{j}.features.npz"
                counts[key] = 12
                source_of[key] = ("mermaid" if s % 2 else "coralnet", str(100 + s))
        gt = [c for key in sorted(counts) for c in rng.permutation(per_image)]
        n = len(gt)
        est = np.where(rng.random(n) < 0.7, gt, rng.integers(0, k, n)).tolist()
        logits = rng.normal(size=(n, k))
        logits[np.arange(n), est] += 4.0
        proba = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        scores = proba[np.arange(n), est].tolist()
        # Tied confidences: equal-mass bins must cut them the same way.
        scores = [round(s, 2) for s in scores]
        return records, gfs, classes, gt, est, scores, proba, counts, source_of
    kw = {"dense": {"n": 600}, "absent_classes": {"n": 600, "absent": (0, 5, 17)},
          "perfect": {"n": 400, "accuracy": 1.0}}[case]
    gt, est, scores, proba = val_inputs(classes, seed=3, **kw)
    sources = [("mermaid", "1"), ("coralnet", "22"), ("coralnet", "7"),
               ("mermaid", "5")]
    counts, source_of = _images(len(gt), sources, seed=5)
    return records, gfs, classes, gt, est, scores, proba, counts, source_of


def single_label_inputs():
    """Four classes; the first source holds one class only, all right (a
    single label in gt and est)."""
    records, gfs, _ = taxonomy(n_roots=2, per_root=2)
    classes = ["ba0-0::", "ba0-1::gf-br", "ba1-0::", "ba1-1::"]
    rng = np.random.default_rng(2)
    gt = [0] * 20 + rng.integers(0, 4, 60).tolist()
    est = [0] * 20 + rng.integers(0, 4, 60).tolist()
    proba = rng.dirichlet(np.ones(4), len(gt))
    scores = proba.max(1).tolist()
    counts = {f"s/img{i:03d}": 10 for i in range(8)}
    source_of = {key: ("mermaid", "1") if i < 2 else ("coralnet", "9")
                 for i, key in enumerate(sorted(counts))}
    return records, gfs, classes, gt, est, scores, proba, counts, source_of


CASES = ["dense", "ties", "absent_classes", "perfect", "single_label"]


def _inputs(case):
    return single_label_inputs() if case == "single_label" else case_inputs(case)


def contexts(case):
    records, gfs, classes, gt, est, scores, proba, counts, source_of = _inputs(case)
    out = {}
    for name, Val, Ctx, tax in (("jax", JVal, JCtx, jtax), ("port", TVal, TCtx, ttax)):
        dataset = SimpleNamespace(
            labels=SimpleNamespace(val=SimpleNamespace(
                data={key: [None] * n for key, n in counts.items()})),
            feature_path_to_source=dict(source_of),
        )
        out[name] = Ctx(
            val_results=Val(scores=list(scores), gt=list(gt), est=list(est),
                            classes=list(classes)),
            ba_library=tax.BenthicAttributeLibrary(records),
            gf_library=tax.GrowthFormLibrary(gfs),
            dataset=dataset,
            clf=SimpleNamespace(classes_=list(classes)),
            val_proba=proba,
            val_gt_labels=[classes[i] for i in gt],
        )
    return out


def _same_scalars(got, want, group):
    assert list(got) == list(want), group
    for name, w in want.items():
        g = got[name]
        if np.isnan(w):
            assert np.isnan(g), (group, name, g)
        else:
            assert g == pytest.approx(w, abs=1e-12, rel=0), (group, name)


@pytest.mark.parametrize("case", CASES)
def test_groups_match_jax(case):
    """Every group's scalars, tables as CSV text, and figures' plotted data
    (in the same artifact order) against the JAX group's."""
    import matplotlib.pyplot as plt

    ctxs = contexts(case)
    jby = {g.name: g for g in jgroups()}
    tby = {g.name: g for g in tgroups()}
    assert list(jby) == list(tby)
    n_figures = 0
    for name in jby:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jout = jby[name].compute(ctxs["jax"])
            tout = tby[name].compute(ctxs["port"])
        _same_scalars(tout.scalars, jout.scalars, name)
        assert [(a.kind, a.path, a.save_kwargs) for a in tout.artifacts] == [
            (a.kind, a.path, a.save_kwargs) for a in jout.artifacts], name
        for ja, ta in zip(jout.artifacts, tout.artifacts):
            if ja.kind == "table":
                assert to_csv_text(ta.payload) == ja.payload.to_csv(index=False), ja.path
            elif ja.kind == "mapping":
                assert ta.payload == ja.payload, ja.path
            else:
                fig = ta.payload.render()
                try:
                    assert_same_plot(plotted(fig), plotted(ja.payload), ja.path)
                finally:
                    plt.close(fig)
                    plt.close(ja.payload)
                n_figures += 1
    assert n_figures >= 6


def _run_coordinators(tmp_path, case, hide_matplotlib=False, monkeypatch=None):
    ctxs = contexts(case)
    jrun = JTracker(tmp_path / "jax").start_run("m")
    JCoord(ctxs["jax"], jrun).compute_and_log_all()
    if hide_matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    trun = TTracker(tmp_path / "port").start_run("m")
    tcoord = TCoord(ctxs["port"], trun)
    tcoord.compute_and_log_all()
    return jrun, trun, tcoord


@pytest.mark.parametrize("case", ["ties", "absent_classes"])
def test_coordinators_write_the_same_artifacts(tmp_path, case):
    jrun, trun, tcoord = _run_coordinators(tmp_path, case)
    assert list(tcoord.group_seconds) == [g.name for g in jgroups()]
    assert trun.list_artifacts() == jrun.list_artifacts()
    for path in jrun.list_artifacts():
        if path.endswith((".csv", ".yaml")):
            assert trun.artifact(path).read_bytes() == jrun.artifact(path).read_bytes(), path
    jm, tm = jrun.latest_metrics(), trun.latest_metrics()
    assert tm.keys() == jm.keys()
    for name in jm:
        assert tm[name] == pytest.approx(jm[name], abs=1e-12, rel=0), name
    assert "figures_not_written" not in trun.params()


def test_without_matplotlib_figures_are_named(tmp_path, monkeypatch):
    """matplotlib hidden from the port (``sys.modules["matplotlib"] =
    None``): the same scalars and tables as with it, no PNG, and one param
    naming every figure JAX drew, in log order."""
    jrun, trun, tcoord = _run_coordinators(tmp_path, "dense", True, monkeypatch)
    pngs = [p for p in jrun.list_artifacts() if p.endswith(".png")]
    assert len(pngs) == 10
    assert sorted(tcoord.figures_not_written) == pngs
    assert sorted(trun.params()["figures_not_written"].split(", ")) == pngs
    assert [p for p in trun.list_artifacts() if p.endswith(".png")] == []
    assert set(trun.list_artifacts()) == set(jrun.list_artifacts()) - set(pngs)
    for path in trun.list_artifacts():
        if path.endswith((".csv", ".yaml")):
            assert trun.artifact(path).read_bytes() == jrun.artifact(path).read_bytes(), path
    jm, tm = jrun.latest_metrics(), trun.latest_metrics()
    assert tm.keys() == jm.keys()
    for name in jm:
        assert tm[name] == pytest.approx(jm[name], abs=1e-12, rel=0), name


# -- numpy counterparts ---------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_r2_score_matches_sklearn(seed):
    rng = np.random.default_rng(seed)
    y = rng.random(40)
    cases = [(y, y + rng.normal(0, 0.1, 40)), (y, y), (np.full(40, 0.3), y),
             (np.full(40, 0.3), np.full(40, 0.3)), (y[:1], y[:1] + 1)]
    for a, b in cases:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = skm.r2_score(a, b)
        got = tcover.r2_score(a, b)
        if np.isnan(want):
            assert np.isnan(got)
        else:
            assert got == pytest.approx(want, abs=1e-12, rel=0)


@pytest.mark.parametrize("seed", range(4))
def test_prf_and_balanced_accuracy_match_sklearn(seed):
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 6, 80)
    est = rng.integers(2, 9, 80)
    p, r, f, _ = skm.precision_recall_fscore_support(gt, est, average="macro",
                                                     zero_division=0)
    got = tcls.precision_recall_fscore_macro(gt, est)
    assert got == pytest.approx((p, r, f), abs=1e-12, rel=0)
    for a, b in ((gt, est), (np.zeros(5, int), np.zeros(5, int))):
        with warnings.catch_warnings(record=True) as skw:
            warnings.simplefilter("always")
            want = skm.balanced_accuracy_score(a, b)
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            have = tcls.balanced_accuracy_score(a, b)
        assert have == pytest.approx(want, abs=1e-12, rel=0)
        assert sorted(str(w.message) for w in tw) == sorted(str(w.message) for w in skw)


@pytest.mark.parametrize("n", [5, 16, 17, 40, 300])
@pytest.mark.parametrize("ascending", [True, False])
def test_pandas_sort_order_matches_pandas(n, ascending):
    """Ties (values drawn from a few levels) and NaN, below and above
    numpy's 16-element insertion-sort cut-off, int and float columns."""
    rng = np.random.default_rng(n)
    ints = rng.integers(0, 4, n)
    floats = rng.integers(0, 5, n) / 3.0
    floats[rng.random(n) < 0.2] = np.nan
    for values in (ints, floats):
        want = pd.DataFrame({"v": values}).sort_values("v", ascending=ascending).index
        np.testing.assert_array_equal(pandas_sort_order(values, ascending), want)


def test_adaptive_ece_and_ranks_match_jax_with_ties():
    rng = np.random.default_rng(3)
    conf = np.round(rng.random(203), 1)            # many tied confidences
    gt, est = rng.integers(0, 5, 203), rng.integers(0, 5, 203)
    for bins in (20, 10, 7):
        assert tcal.adaptive_ece(conf, gt, est, bins) == jcal.adaptive_ece(
            conf, gt, est, bins)
    proba = np.round(rng.dirichlet(np.ones(12), 150), 1)  # tied probabilities
    classes = [f"c{i:02d}" for i in range(12)]
    labels = [classes[i] for i in rng.integers(0, 12, 150)]
    want, got = jrank.topk_and_mrr(proba, labels, classes), trank.topk_and_mrr(
        proba, labels, classes)
    np.testing.assert_array_equal(got["ranks"], want["ranks"])
    assert got["topk"] == want["topk"] and got["mrr"] == want["mrr"]
