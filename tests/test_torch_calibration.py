"""The port's calibration against the JAX package's, on the CPU.

- The host fits (scipy L-BFGS-B sigmoid, bounded-Brent temperature) are the
  JAX module's numpy code: equal to it within 1e-12.
- The batched Newton solve, in torch on a CPU tensor: within rtol 1e-4 of the
  JAX ``fit_sigmoid_calibration_batch``, and both within the JAX test's
  bounds of the scipy path (rtol 2e-3, atol 2e-4;
  tests/train/test_calibration.py). Both solve in float32 and accept a step
  only if the float32 loss sum falls, so each stops where a step's gain is
  below that sum's rounding. On the weighted case the JAX solve itself stops
  2.0e-4 (relative) from scipy, so there the two are held to each other at
  rtol 5e-4.
"""

import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.train import calibration as jcal
from mermaid_classifier_tpu_torch.train import calibration as tcal


class _Frozen:
    """A prefit estimator: ``classes_`` and a row-index lookup of probabilities."""

    def __init__(self, proba, classes):
        self._proba = np.asarray(proba, dtype=np.float64)
        self.classes_ = np.asarray(classes)

    def predict_proba(self, X):
        return self._proba[np.asarray(X[:, 0], dtype=int)]


def _proba(rng, n, k):
    raw = rng.random((n, k))
    return raw / raw.sum(axis=1, keepdims=True)


def _case(name):
    """(estimator, scores, labels, sample_weight) for the fit_from_scores cases."""
    rng = np.random.default_rng({"multiclass": 10, "binary": 11, "weighted": 12}[name])
    k = 2 if name == "binary" else (12 if name == "multiclass" else 5)
    n = 1500 if name == "binary" else 1200
    classes = np.array([f"c{i}" for i in range(k)])
    proba = _proba(rng, n, k)
    y = classes[np.argmax(proba + rng.normal(0, 0.2, (n, k)), axis=1)]
    weight = rng.random(n) + 0.1 if name == "weighted" else None
    scores = proba[:, 1:] if name == "binary" else proba
    return _Frozen(proba, classes), scores, y, weight


CASES = ["multiclass", "binary", "weighted"]


@pytest.mark.parametrize("scale", [1.0, 50.0])
@pytest.mark.parametrize("weighted", [False, True])
def test_sigmoid_fit_equals_jax(scale, weighted):
    """scale 50 takes the max|F| >= 30 rescale branch."""
    rng = np.random.default_rng(0)
    scores = rng.normal(0, scale, 500) if scale > 1 else rng.random(500)
    y = (scores / scale + rng.normal(0, 0.3, 500) > 0.5 / scale).astype(int)
    w = rng.random(500) + 0.1 if weighted else None
    got = tcal.fit_sigmoid_calibration(scores, y, w)
    want = jcal.fit_sigmoid_calibration(scores, y, w)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", CASES)
def test_calibrated_classifier_scipy_equals_jax(name):
    est, scores, y, w = _case(name)
    got = tcal.CalibratedClassifier.fit_from_scores(est, scores, y, w)
    want = jcal.CalibratedClassifier.fit_from_scores(est, scores, y, w)
    np.testing.assert_allclose(got.calibration_a_, want.calibration_a_, rtol=1e-12)
    np.testing.assert_allclose(got.calibration_b_, want.calibration_b_, rtol=1e-12)
    X = np.arange(len(y), dtype=np.float64)[:, None]
    np.testing.assert_allclose(got.predict_proba(X), want.predict_proba(X),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got.predict(X), want.predict(X))


@pytest.mark.parametrize("weighted", [False, True])
def test_temperature_equals_jax(weighted):
    est, proba, y, _ = _case("weighted")
    w = np.random.default_rng(3).random(len(y)) + 0.1 if weighted else None
    got = tcal.TemperatureCalibratedClassifier.fit_from_scores(est, proba, y, w)
    want = jcal.TemperatureCalibratedClassifier.fit_from_scores(est, proba, y, w)
    assert got.temperature_ == pytest.approx(want.temperature_, rel=1e-12)
    X = np.arange(len(y), dtype=np.float64)[:, None]
    np.testing.assert_allclose(got.predict_proba(X), want.predict_proba(X),
                               rtol=1e-12, atol=1e-12)
    log_p = np.log(np.clip(proba, 1e-300, None))
    y_idx = np.searchsorted(est.classes_, y)
    assert tcal.fit_temperature(log_p, y_idx, w) == pytest.approx(
        jcal.fit_temperature(log_p, y_idx, w), rel=1e-12)


@pytest.mark.parametrize("name", CASES)
def test_device_backend_matches_jax_and_scipy(name):
    est, scores, y, w = _case(name)
    got = tcal.CalibratedClassifier.fit_from_scores(
        est, scores, y, w, backend="device", device="cpu")
    want = jcal.CalibratedClassifier.fit_from_scores(est, scores, y, w, backend="device")
    scipy = jcal.CalibratedClassifier.fit_from_scores(est, scores, y, w)
    rtol = 5e-4 if name == "weighted" else 1e-4
    for attr in ("calibration_a_", "calibration_b_"):
        np.testing.assert_allclose(getattr(got, attr), getattr(want, attr), rtol=rtol)
        for fit in (got, want):
            np.testing.assert_allclose(getattr(fit, attr), getattr(scipy, attr),
                                       rtol=2e-3, atol=2e-4)


def test_batch_large_scores_rescale_matches_jax_and_scipy():
    rng = np.random.default_rng(13)
    n = 900
    scores = np.column_stack([rng.normal(0, 50, n), rng.normal(0, 0.5, n)])
    targets = np.column_stack([scores[:, 0] > 0, scores[:, 1] > 0.2]).astype(float)
    a_t, b_t = tcal.fit_sigmoid_calibration_batch(scores, targets, device="cpu")
    a_j, b_j = jcal.fit_sigmoid_calibration_batch(scores, targets)
    np.testing.assert_allclose(a_t, a_j, rtol=1e-4)
    np.testing.assert_allclose(b_t, b_j, rtol=1e-4)
    for col in range(2):
        a_cpu, b_cpu = tcal.fit_sigmoid_calibration(scores[:, col], targets[:, col])
        # The JAX test's bounds for this case (b: atol 2e-3).
        assert a_t[col] == pytest.approx(a_cpu, rel=2e-3, abs=2e-4)
        assert b_t[col] == pytest.approx(b_cpu, rel=2e-3, abs=2e-3)


def test_batch_degenerate_columns_are_finite():
    """Constant scores and a class with no positives: finite, as in JAX."""
    n = 400
    rng = np.random.default_rng(14)
    scores = np.column_stack([np.full(n, 0.25), rng.random(n)])
    targets = np.column_stack([rng.integers(0, 2, n), np.zeros(n)]).astype(float)
    a, b = tcal.fit_sigmoid_calibration_batch(scores, targets, device="cpu")
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))


@pytest.mark.parametrize("bad", ["shape", "weight"])
def test_batch_input_checks_match_jax(bad):
    scores = np.zeros((10, 3))
    targets = np.zeros((10, 2)) if bad == "shape" else np.zeros((10, 3))
    weight = np.ones(9) if bad == "weight" else None
    with pytest.raises(ValueError) as jerr:
        jcal.fit_sigmoid_calibration_batch(scores, targets, weight)
    with pytest.raises(ValueError) as terr:
        tcal.fit_sigmoid_calibration_batch(scores, targets, weight, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_unknown_backend_rejected():
    est, scores, y, _ = _case("multiclass")
    with pytest.raises(ValueError, match="backend"):
        tcal.CalibratedClassifier.fit_from_scores(est, scores, y, backend="jax")


def test_device_backend_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    est, scores, y, _ = _case("multiclass")
    with pytest.raises(RuntimeError, match="is_available"):
        tcal.CalibratedClassifier.fit_from_scores(est, scores, y, backend="device")
    # The scipy default needs no device.
    tcal.CalibratedClassifier.fit_from_scores(est, scores, y)
