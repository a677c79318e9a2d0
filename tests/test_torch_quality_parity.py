"""The port's composed quality check (``train/quality_parity.py``) against
the JAX package's, on the CPU.

Held, each as stated: the data generator, the split, the subsample and the
epoch stream equal JAX's bit for bit; the port's scorers equal
``sklearn.metrics`` within 1e-12; ``run_quality_parity`` at the CI spec
passes the JAX test's bands (``tests/train/test_quality_parity.py``), its
sklearn side is JAX's sklearn side exactly (the same function on the same
split), and its repo side lies within those bands of the JAX repo side;
under ``init="sklearn"`` (the same initial weights in both packages) the
two repo sides agree within a tighter stated bound; the multi-seed
structure tests are the JAX file's.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import sklearn.metrics as skm

from mermaid_classifier_tpu.train import quality_parity as jqp
from mermaid_classifier_tpu_torch.metrics.classification import (
    balanced_accuracy_score,
)
from mermaid_classifier_tpu_torch.scripts import quality_parity_bench as tbench
from mermaid_classifier_tpu_torch.train import quality_parity as tqp
from mermaid_classifier_tpu_torch.train.trainer import accuracy_score, log_loss
from tests.train.test_quality_parity import ACC_BAND, BAL_ACC_BAND, LOG_LOSS_BAND

CPU = {"device": "cpu", "enforce_torch_pin": False}

SPECS = {
    "ci": dict(),
    "small": dict(n_samples=3600, n_features=48, n_classes=8, cluster_std=4.0,
                  subsample_total=2400, min_per_class=40, seed=3),
    "tail_floor": dict(n_samples=1200, n_features=16, n_classes=20,
                       imbalance_exponent=2.0, subsample_total=500,
                       min_per_class=30, seed=5),
}


def _pair(name):
    return tqp.QualityRunSpec(**SPECS[name]), jqp.QualityRunSpec(**SPECS[name])


def _same_arrays(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == object:
        assert a.tolist() == b.tolist()
    else:
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", list(SPECS))
def test_data_split_and_subsample_equal_jax(name):
    tspec, jspec = _pair(name)
    tX, ty = tqp.make_imbalanced_clusters(tspec)
    jX, jy = jqp.make_imbalanced_clusters(jspec)
    _same_arrays(tX, jX)
    _same_arrays(ty, jy)
    tsplit = tqp.split_stratified(tX, ty, tspec)
    jsplit = jqp.split_stratified(jX, jy, jspec)
    for (ta, tb), (ja, jb) in zip(tsplit, jsplit):
        _same_arrays(ta, ja)
        _same_arrays(tb, jb)
    tsub = tqp.subsample_train(tsplit[0], tspec)
    jsub = jqp.subsample_train(jsplit[0], jspec)
    _same_arrays(tsub[0], jsub[0])
    _same_arrays(tsub[1], jsub[1])


def test_epoch_stream_equals_jax():
    got = [i.tolist() for i in tqp._epoch_stream(1003, 3, 256, 7)]
    assert got == [i.tolist() for i in jqp._epoch_stream(1003, 3, 256, 7)]


def _score_cases():
    rng = np.random.default_rng(0)
    classes = [f"class_{k:02d}" for k in range(6)]
    for case, dtype in enumerate([np.float64, np.float32, np.float64, np.float32]):
        n = 50 + 40 * case
        proba = rng.dirichlet(np.full(6, 0.3 + case), size=n).astype(dtype)
        y = np.asarray(classes, dtype=object)[rng.integers(0, 6 - (case == 2), n)]
        yield case, classes, y, proba


@pytest.mark.parametrize("case", range(4))
def test_scorers_equal_sklearn(case):
    _, classes, y, proba = dict((c[0], c) for c in _score_cases())[case]
    got = tqp._score(y, proba, classes)
    pred = np.asarray(classes, dtype=object)[np.argmax(proba, axis=1)]
    assert abs(got.accuracy - skm.accuracy_score(y, pred)) <= 1e-12
    assert abs(got.balanced_accuracy - skm.balanced_accuracy_score(y, pred)) <= 1e-12
    assert abs(got.log_loss - skm.log_loss(y, proba, labels=classes)) <= 1e-12
    assert accuracy_score(y, pred) == got.accuracy
    assert balanced_accuracy_score(y, pred) == got.balanced_accuracy
    assert log_loss(y, proba, classes) == got.log_loss


def test_score_needs_no_sklearn(monkeypatch):
    _, classes, y, proba = next(_score_cases())
    want = tqp._score(y, proba, classes)
    for name in [m for m in sys.modules if m.split(".")[0] == "sklearn"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    assert tqp._score(y, proba, classes) == want
    spec = tqp.QualityRunSpec(**SPECS["tail_floor"])
    X, yy = tqp.make_imbalanced_clusters(spec)
    split = tqp.split_stratified(X, yy, spec)
    with pytest.raises(ImportError):
        tqp.run_sklearn_pipeline(split[0], split[1], split[2], spec)


@pytest.fixture(scope="module")
def port_result():
    return tqp.run_quality_parity(tqp.QualityRunSpec(), **CPU)


@pytest.fixture(scope="module")
def jax_result():
    return jqp.run_quality_parity(jqp.QualityRunSpec())


class TestQualityParity:
    """The JAX keystone's checks on the port's run."""

    def test_problem_is_nontrivial(self, port_result):
        assert 0.55 < port_result["sklearn_accuracy"] < 0.97
        assert port_result["n_classes"] >= 15

    def test_accuracy_parity(self, port_result):
        assert abs(port_result["accuracy_delta"]) <= ACC_BAND, port_result

    def test_balanced_accuracy_parity(self, port_result):
        assert abs(port_result["balanced_accuracy_delta"]) <= BAL_ACC_BAND, port_result

    def test_log_loss_parity(self, port_result):
        assert abs(port_result["log_loss_delta"]) <= LOG_LOSS_BAND, port_result

    def test_calibrated_probabilities_sane(self, port_result):
        uniform = float(np.log(port_result["n_classes"]))
        assert port_result["repo_log_loss"] < 0.7 * uniform
        assert port_result["sklearn_log_loss"] < 0.7 * uniform


class TestAgainstJax:
    def test_same_keys_and_sizes(self, port_result, jax_result):
        assert list(port_result) == list(jax_result)
        for key in ("n_train", "n_val", "n_classes"):
            assert port_result[key] == jax_result[key]

    def test_sklearn_side_is_jax_sklearn_side(self, port_result, jax_result):
        for key in ("sklearn_accuracy", "sklearn_balanced_accuracy",
                    "sklearn_log_loss"):
            assert port_result[key] == jax_result[key], key

    @pytest.mark.parametrize("key, band", [("accuracy", ACC_BAND),
                                           ("balanced_accuracy", BAL_ACC_BAND),
                                           ("log_loss", LOG_LOSS_BAND)])
    def test_repo_side_within_bands_of_jax_repo_side(self, port_result,
                                                     jax_result, key, band):
        assert abs(port_result[f"repo_{key}"] - jax_result[f"repo_{key}"]) <= band


#: The same initial weights in both packages (sklearn's init stream): the
#: two repo sides differ only by float32 rounding in the training and the
#: calibration. Read on the CPU at the CI spec: accuracy (0.94587) and
#: balanced accuracy (0.90221) equal, log loss 1.1e-6 apart (0.253228 /
#: 0.253229); held at a tenth of the JAX bands. Under the default
#: "reference" init the packages draw different weights, and the sides read
#: 0.0056 / 0.0123 / 0.0363 apart (within the bands above).
SKLEARN_INIT_BOUND = {"accuracy": ACC_BAND / 10, "balanced_accuracy": BAL_ACC_BAND / 10,
                      "log_loss": LOG_LOSS_BAND / 10}


def test_sklearn_init_repo_sides_agree_tightly():
    tspec = tqp.QualityRunSpec(init="sklearn")
    jspec = jqp.QualityRunSpec(init="sklearn")
    X, y = tqp.make_imbalanced_clusters(tspec)
    train, ref, val = tqp.split_stratified(X, y, tspec)
    sub = tqp.subsample_train(train, tspec)
    got = tqp.run_repo_pipeline(sub, ref, val, tspec, **CPU)
    want = jqp.run_repo_pipeline(sub, ref, val, jspec)
    for key, bound in SKLEARN_INIT_BOUND.items():
        assert abs(getattr(got, key) - getattr(want, key)) <= bound, (
            key, getattr(got, key), getattr(want, key))
    assert got.extra == want.extra


MULTISEED_SPEC = tqp.QualityRunSpec(
    n_samples=3600,
    n_features=48,
    n_classes=8,
    cluster_std=4.0,
    hidden=(32, 16),
    epochs=10,
    subsample_total=2400,
    min_per_class=40,
    init="sklearn",
)


class TestQualityParityMultiseed:
    @pytest.fixture(scope="class")
    def multi(self):
        return tqp.run_quality_parity_multiseed(MULTISEED_SPEC, seeds=(0, 1, 2),
                                                **CPU)

    def test_structure(self, multi):
        assert multi["seeds"] == [0, 1, 2]
        assert len(multi["per_seed"]) == 3
        for key in ("accuracy_delta", "balanced_accuracy_delta",
                    "log_loss_delta"):
            band = multi["deltas"][key]
            assert band["ci95_low"] <= band["mean"] <= band["ci95_high"]
            assert band["std"] >= 0.0
            assert band["ci_contains_zero"] == (
                band["ci95_low"] <= 0.0 <= band["ci95_high"]
            )

    def test_seeds_actually_vary_the_draw(self, multi):
        accs = [r["sklearn_accuracy"] for r in multi["per_seed"]]
        assert len(set(accs)) > 1, accs

    def test_matched_init_band_is_tight(self, multi):
        for row in multi["per_seed"]:
            assert abs(row["balanced_accuracy_delta"]) <= 1.5 * BAL_ACC_BAND

    def test_too_few_seeds_rejected(self):
        with pytest.raises(ValueError):
            tqp.run_quality_parity_multiseed(MULTISEED_SPEC, seeds=(0,), **CPU)


def test_default_device_is_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tqp.QualityRunSpec(**SPECS["tail_floor"])
    X, y = tqp.make_imbalanced_clusters(spec)
    train, ref, val = tqp.split_stratified(X, y, spec)
    with pytest.raises(RuntimeError, match="is_available"):
        tqp.run_repo_pipeline(train, ref, val, spec)


SMALL_FLAGS = ["--samples", "3000", "--features", "32", "--classes", "6",
               "--hidden", "32", "16", "--epochs", "4", "--subsample-total",
               "1500", "--min-per-class", "40", "--device", "cpu",
               "--allow-unpinned-torch"]


def test_bench_repo_only_json(capsys):
    assert tbench.main([*SMALL_FLAGS, "--repo-only"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["metric"] == "quality_parity_repo_accuracy"
    assert result["value"] == result["repo_accuracy"]
    assert result["repo_seconds"] > 0 and result["n_classes"] == 6
    assert 0.0 < result["repo_balanced_accuracy"] <= 1.0


def test_bench_compare_json_equals_jax_keys(capsys, monkeypatch):
    assert tbench.main(SMALL_FLAGS) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    spec = jqp.QualityRunSpec(
        n_samples=3000, n_features=32, n_classes=6,
        cluster_std=jqp.QualityRunSpec().cluster_std * (32 / 96) ** 0.5,
        hidden=(32, 16), epochs=4, subsample_total=1500, min_per_class=40)
    want = jqp.run_quality_parity(spec)
    assert list(got) == [*want, "metric", "value"]
    assert got["metric"] == "quality_parity_accuracy_delta"
    for key in ("sklearn_accuracy", "sklearn_log_loss", "n_train", "n_val"):
        assert got[key] == want[key], key
