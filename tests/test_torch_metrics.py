"""The port's metrics coordinator and its first four groups against the JAX
ones (the other five: tests/test_torch_metric_groups.py).

The same ``ValResults``, ``val_proba`` and taxonomy libraries go through
both coordinators (each logging into its own package's tracker, the
format function the identity, so nothing is rounded): the scalars of
``confusion_matrices``, ``precision_recall_f1``, ``balanced_accuracy_mcc``
and ``probability`` agree within 1e-12, and their tables match as CSV text
(``metrics_overall.yaml`` byte for byte). Each numpy counterpart of an
sklearn call is held to sklearn within 1e-12 on cases with labels missing
from gt or est; ``confusion_matrix`` exactly."""

from types import SimpleNamespace

import numpy as np
import pytest
import sklearn.metrics as skm
from sklearn.metrics.pairwise import cosine_distances as sk_cosine_distances

from mermaid_classifier_tpu.common import taxonomy as jtax
from mermaid_classifier_tpu.data.results import ValResults as JVal
from mermaid_classifier_tpu.metrics import MetricsContext as JCtx
from mermaid_classifier_tpu.metrics import MetricsCoordinator as JCoord
from mermaid_classifier_tpu.tracking.local_tracker import LocalTracker as JTracker
from mermaid_classifier_tpu_torch.common import taxonomy as ttax
from mermaid_classifier_tpu_torch.data.results import ValResults as TVal
from mermaid_classifier_tpu_torch.metrics import REPORT_ORDER, all_groups
from mermaid_classifier_tpu_torch.metrics import MetricsContext as TCtx
from mermaid_classifier_tpu_torch.metrics import MetricsCoordinator as TCoord
from mermaid_classifier_tpu_torch.metrics import classification as tcls
from mermaid_classifier_tpu_torch.tracking.local_tracker import LocalTracker as TTracker

SCALARS = ("precision_macro", "recall_macro", "f1_macro", "balanced_accuracy",
           "mcc", "log_loss")
TABLES = ("confusion_matrix/frequencies.csv", "confusion_matrix/percents.csv",
          "metrics_per_label.csv", "probability/per_category_log_loss.csv",
          "metrics_overall.yaml")


def taxonomy(n_roots=3, per_root=6):
    """A seeded two-level tree: ``n_roots`` roots, ``per_root`` children
    each; classes are each child with and without a growth form."""
    records = []
    for r in range(n_roots):
        records.append({"id": f"root{r}", "name": f"Root {r}", "parent": None})
        for c in range(per_root):
            records.append({"id": f"ba{r}-{c}", "name": f"Genus {r}.{c}",
                            "parent": f"root{r}"})
    gfs = {"gf-br": "branching", "gf-ma": "massive"}
    classes = sorted(
        f"ba{r}-{c}::{gf}" for r in range(n_roots) for c in range(per_root)
        for gf in ("", "gf-br"))
    return records, gfs, classes


def val_inputs(classes, n=900, accuracy=0.6, seed=0, absent=()):
    """gt / est indices with block confusion, per-row scores and a
    probability matrix whose argmax is est; the classes in ``absent`` never
    occur in gt."""
    rng = np.random.default_rng(seed)
    k = len(classes)
    present = [i for i in range(k) if i not in absent]
    gt = rng.choice(present, n)
    est = np.where(rng.random(n) < accuracy, gt,
                   (gt + rng.integers(1, 4, n)) % k)
    logits = rng.normal(size=(n, k))
    logits[np.arange(n), est] += 4.0
    proba = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    scores = proba[np.arange(n), est]
    return gt.tolist(), est.tolist(), scores.tolist(), proba


def run_both(tmp_path, classes, records, gfs, gt, est, scores, proba):
    out = {}
    for name, Val, Ctx, Coord, Tracker, tax in (
        ("jax", JVal, JCtx, JCoord, JTracker, jtax),
        ("port", TVal, TCtx, TCoord, TTracker, ttax),
    ):
        ctx = Ctx(
            val_results=Val(scores=list(scores), gt=list(gt), est=list(est),
                            classes=list(classes)),
            ba_library=tax.BenthicAttributeLibrary(records),
            gf_library=tax.GrowthFormLibrary(gfs),
            clf=SimpleNamespace(classes_=list(classes)),
            val_proba=proba,
            val_gt_labels=[classes[i] for i in gt],
        )
        run = Tracker(tmp_path / name).start_run("metrics")
        coord = Coord(ctx, run)
        coord.compute_and_log_all()
        out[name] = (run, coord)
    return out


@pytest.mark.parametrize("case", ["dense", "absent_classes", "accurate"])
def test_coordinators_agree(tmp_path, case):
    records, gfs, classes = taxonomy()
    kw = {"dense": {}, "absent_classes": {"absent": (0, 5, 17)},
          "accurate": {"accuracy": 0.97, "seed": 4}}[case]
    gt, est, scores, proba = val_inputs(classes, **kw)
    out = run_both(tmp_path, classes, records, gfs, gt, est, scores, proba)
    (jrun, _), (trun, tcoord) = out["jax"], out["port"]
    jm, tm = jrun.latest_metrics(), trun.latest_metrics()
    for name in SCALARS:
        assert tm[name] == pytest.approx(jm[name], abs=1e-12, rel=0), name
    for path in TABLES:
        assert trun.artifact(path).read_bytes() == jrun.artifact(path).read_bytes(), path
    # No dataset in the context: cover and per_source are gated out.
    assert list(tcoord.group_seconds) == [
        n for n in REPORT_ORDER if n not in ("cover", "per_source")]
    assert trun.artifact("metrics_group_seconds.json").is_file()
    assert "log_loss" in tm and len(trun.artifact(
        "probability/per_category_log_loss.csv").read_text().splitlines()) == 4


def test_small_taxonomy_without_categories(tmp_path):
    """Four classes, too few val points per top-level category: the
    category table is empty (header only) in both."""
    records, gfs, _ = taxonomy(n_roots=2, per_root=2)
    classes = ["ba0-0::", "ba0-1::gf-br", "ba1-0::", "ba1-1::"]
    gt, est, scores, proba = val_inputs(classes, n=40)
    out = run_both(tmp_path, classes, records, gfs, gt, est, scores, proba)
    (jrun, _), (trun, _) = out["jax"], out["port"]
    for path in TABLES:
        assert trun.artifact(path).read_bytes() == jrun.artifact(path).read_bytes(), path


def test_a_failing_group_is_isolated(tmp_path):
    """A group that raises leaves its scalars out; the others still log
    (the coordinator's per-group isolation)."""
    records, gfs, classes = taxonomy()
    gt, est, scores, proba = val_inputs(classes)
    ctx = TCtx(val_results=TVal(scores=scores, gt=gt, est=est, classes=classes),
               ba_library=ttax.BenthicAttributeLibrary(records),
               gf_library=ttax.GrowthFormLibrary(gfs),
               clf=SimpleNamespace(classes_=classes[:-1]),
               val_proba=proba, val_gt_labels=[classes[i] for i in gt])
    run = TTracker(tmp_path).start_run("m")
    TCoord(ctx, run).compute_and_log_all()
    metrics = run.latest_metrics()
    assert "log_loss" not in metrics
    assert {"mcc", "balanced_accuracy", "f1_macro"} <= set(metrics)


def test_report_order_keeps_nine_names():
    assert len(REPORT_ORDER) == 9
    assert [g.name for g in all_groups()] == list(REPORT_ORDER)


@pytest.mark.parametrize("seed", range(4))
def test_numpy_counterparts_match_sklearn(seed):
    rng = np.random.default_rng(seed)
    labels = np.array([f"c{i:02d}" for i in range(9)])
    gt = labels[rng.integers(0, 6, 300)]             # c06..c08 never in gt
    est = labels[rng.integers(2, 9, 300)]            # c00, c01 never in est
    p_sk = skm.precision_score(gt, est, average="macro", zero_division=0.0)
    r_sk = skm.recall_score(gt, est, average="macro", zero_division=0.0)
    p, r = tcls.precision_recall_macro(list(gt), list(est))
    assert p == pytest.approx(p_sk, abs=1e-12) and r == pytest.approx(r_sk, abs=1e-12)
    assert tcls.balanced_accuracy_score(gt, est) == pytest.approx(
        skm.balanced_accuracy_score(gt, est), abs=1e-12)
    assert tcls.matthews_corrcoef(gt, est) == pytest.approx(
        skm.matthews_corrcoef(gt, est), abs=1e-12)
    gi = rng.integers(0, 7, 200)
    ei = rng.integers(0, 7, 200)
    for normalize in (False, True):
        want = skm.confusion_matrix(gi, ei, labels=range(8),
                                    normalize="true" if normalize else None)
        np.testing.assert_array_equal(tcls.confusion_matrix(gi, ei, 8, normalize), want)
    profiles = skm.confusion_matrix(gi, ei, labels=range(8), normalize="true")
    np.testing.assert_allclose(tcls.cosine_distances(profiles),
                               sk_cosine_distances(profiles), atol=1e-12, rtol=0)


def test_mcc_degenerate_is_zero():
    assert tcls.matthews_corrcoef(["a"] * 5, ["a"] * 5) == 0.0
