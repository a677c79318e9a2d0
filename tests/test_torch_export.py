"""The port's gated export, on the CPU, and artifacts read across packages.

- A head trained and calibrated by the port passes the 1e-6 parity gate.
- A head that diverges raises ParityError and writes nothing; a torch
  version other than PARITY_PROVEN_TORCH raises TorchPinError unless
  ``enforce_torch_pin=False``.
- The JAX ``load_predictor`` reads the port's artifact and the port's
  ``load_predictor`` reads the JAX package's, each agreeing with the other
  package's predictor within 1e-6 max abs (the gate's own tolerance).
"""

import json

import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.inference import export_artifact as j_export_artifact
from mermaid_classifier_tpu.inference import load_predictor as j_load_predictor
from mermaid_classifier_tpu.serve.release import validate_artifact
from mermaid_classifier_tpu.train.calibration import (
    CalibratedClassifier as JCalibrated,
)
from mermaid_classifier_tpu.train.mlp_classifier import MLPClassifier as JMLP
from mermaid_classifier_tpu_torch import inference as tinf
from mermaid_classifier_tpu_torch.inference import export as texport
from mermaid_classifier_tpu_torch.train.calibration import (
    CalibratedClassifier,
    TemperatureCalibratedClassifier,
)
from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier

D, K = 24, 5


def _data(n=400, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, K, size=n)
    X = rng.normal(size=(n, D)).astype(np.float32)
    X[:, :K] += 2.0 * np.eye(K, dtype=np.float32)[y]
    return X, np.array([f"ba-{i}::gf" for i in range(K)])[y]


def _calibrated(calibration="sigmoid", backend="scipy"):
    """A head trained and calibrated by the port, on the CPU."""
    X, y = _data()
    clf = MLPClassifier(hidden_layer_sizes=(16, 8), random_state=0,
                        learning_rate_init=0.01, device="cpu")
    for _ in range(5):
        clf.partial_fit(X, y, classes=np.unique(y))
    Xr, yr = _data(n=300, seed=1)
    proba = clf.predict_proba(Xr)
    if calibration == "temperature":
        return TemperatureCalibratedClassifier.fit_from_scores(clf, proba, yr), Xr
    return CalibratedClassifier.fit_from_scores(
        clf, proba, yr, backend=backend, device="cpu"), Xr


@pytest.mark.parametrize("calibration,backend", [
    ("sigmoid", "scipy"), ("sigmoid", "device"), ("temperature", None),
])
def test_port_trained_head_passes_the_gate(tmp_path, calibration, backend):
    model, Xr = _calibrated(calibration, backend)
    npz, manifest, diff = texport.export_artifact(
        model, tmp_path, Xr, enforce_torch_pin=False)
    assert diff <= 1e-6
    assert npz == tmp_path / "model.npz"
    assert json.loads((tmp_path / "model.json").read_text()) == manifest
    assert manifest["task"] == tinf.TASK_NAME
    assert manifest["calibration"] == calibration
    assert manifest["input_dim"] == D
    assert manifest["trained_with"] == {"torch": torch.__version__,
                                        "numpy": np.__version__}
    pred = tinf.load_predictor(tmp_path, device="cpu")
    assert np.abs(pred.predict_proba(Xr) - model.predict_proba(Xr)).max() <= 1e-6
    # The JAX release validator accepts it: same task, provenance present.
    assert validate_artifact(tmp_path)["classes"] == list(model.classes_)


def test_diverged_head_raises_parity_error(tmp_path):
    model, Xr = _calibrated()

    class Diverged:
        classes_ = model.classes_
        estimator = model.estimator
        calibration_a_ = model.calibration_a_
        calibration_b_ = model.calibration_b_

        def predict_proba(self, feats):
            return model.predict_proba(feats) + 1e-3

    with pytest.raises(tinf.ParityError, match="diverges"):
        texport.export_artifact(Diverged(), tmp_path, Xr, enforce_torch_pin=False)
    assert not (tmp_path / "model.npz").exists()
    assert not (tmp_path / "model.json").exists()


def test_torch_pin_gate(tmp_path, monkeypatch):
    model, Xr = _calibrated()
    monkeypatch.setattr(texport, "PARITY_PROVEN_TORCH", "0.0")
    with pytest.raises(tinf.TorchPinError, match="parity has only been proven"):
        texport.export_artifact(model, tmp_path, Xr)
    assert not (tmp_path / "model.npz").exists()
    texport.export_artifact(model, tmp_path, Xr, enforce_torch_pin=False)
    assert (tmp_path / "model.npz").exists()


@pytest.mark.parametrize("what,match", [
    ("binary", "multiclass"), ("classes", "does not match"),
    ("no estimator", "no .estimator"), ("calibrators", "per-class calibrators"),
])
def test_head_params_from_model_rejects(tmp_path, what, match):
    model, Xr = _calibrated()

    class Bad:
        classes_ = model.classes_
        estimator = model.estimator
        calibration_a_ = model.calibration_a_
        calibration_b_ = model.calibration_b_

    if what == "binary":
        Bad.classes_ = model.classes_[:2]
    elif what == "classes":
        Bad.classes_ = model.classes_[::-1]
    elif what == "no estimator":
        Bad.estimator = None
    else:
        Bad.calibration_a_ = model.calibration_a_[:-1]
    with pytest.raises(ValueError, match=match):
        texport.export_artifact(Bad(), tmp_path, Xr, enforce_torch_pin=False)


@pytest.mark.parametrize("calibration", ["sigmoid", "temperature"])
def test_jax_loader_reads_the_port_artifact(tmp_path, calibration):
    model, Xr = _calibrated(calibration)
    texport.export_artifact(model, tmp_path, Xr, enforce_torch_pin=False)
    want = tinf.load_predictor(tmp_path, device="cpu").predict_proba(Xr)
    jpred = j_load_predictor(tmp_path)
    assert jpred.classes == list(model.classes_)
    assert np.abs(jpred.predict_proba(Xr) - want).max() <= 1e-6


def test_port_loader_reads_the_jax_artifact(tmp_path):
    X, y = _data()
    clf = JMLP(hidden_layer_sizes=(16, 8), random_state=0, learning_rate_init=0.01)
    for _ in range(5):
        clf.partial_fit(X, y, classes=np.unique(y))
    Xr, yr = _data(n=300, seed=1)
    model = JCalibrated.fit_from_scores(clf, clf.predict_proba(Xr), yr)
    j_export_artifact(model, tmp_path, Xr, enforce_jax_pin=False)
    want = j_load_predictor(tmp_path).predict_proba(Xr)
    got = tinf.load_predictor(tmp_path, device="cpu").predict_proba(Xr)
    assert np.abs(got - want).max() <= 1e-6
