"""The port's calibrated head and artifact loader against the JAX package's:
an artifact written by the JAX ``save_head_npz`` plus a manifest is loaded
by both loaders, and the probabilities agree within 1e-6 (the export parity
gate's tolerance), for the sigmoid and the temperature head. Every load
gate raises ManifestError in both for the same tampering."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.inference import ManifestError as JManifestError
from mermaid_classifier_tpu.inference import export as jexport
from mermaid_classifier_tpu.inference import head as jhead
from mermaid_classifier_tpu.inference import loader as jloader
from mermaid_classifier_tpu_torch.inference import ManifestError as TManifestError
from mermaid_classifier_tpu_torch.inference import SCHEMA_VERSION
from mermaid_classifier_tpu_torch.inference import export as texport
from mermaid_classifier_tpu_torch.inference import head as thead
from mermaid_classifier_tpu_torch.inference import loader as tloader

DIMS = (128, 50, 30, 10, 7)


def _params(calibration: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    weights = [
        (rng.standard_normal((a, b)) * (2.0 / np.sqrt(a))).astype(np.float32)
        for a, b in zip(DIMS[:-1], DIMS[1:])
    ]
    biases = [(rng.standard_normal(b) * 0.1).astype(np.float32) for b in DIMS[1:]]
    if calibration == "temperature":
        return weights, biases, {"temperature": 1.7}
    k = DIMS[-1]
    return weights, biases, {
        "a": (-rng.random(k) * 4 - 1).astype(np.float32),
        "b": (rng.standard_normal(k) * 0.5).astype(np.float32),
    }


def write_artifact(out_dir, calibration: str, seed: int = 0):
    """Artifact written by the JAX package: save_head_npz + manifest."""
    weights, biases, cal = _params(calibration, seed)
    jexport.save_head_npz(out_dir / "model.npz",
                          jhead.HeadParams(weights, biases, **cal))
    manifest = {
        "schema_version": SCHEMA_VERSION,
        "task": "mermaid_mlp_classifier_tpu",
        "classes": [f"ba-{i}::" for i in range(DIMS[-1])],
        "input_dim": DIMS[0],
        "calibration": calibration,
        "config": {"patch_size": 224},
    }
    (out_dir / "model.json").write_text(json.dumps(manifest))
    return out_dir


def _features(n=40, seed=1):
    return np.random.default_rng(seed).standard_normal((n, DIMS[0])).astype(np.float32)


@pytest.mark.parametrize("calibration", ["sigmoid", "temperature"])
def test_probabilities_match_jax(tmp_path, calibration):
    art = write_artifact(tmp_path, calibration)
    jp = jloader.load_predictor(art)
    tp = tloader.load_predictor(art, device="cpu")
    assert tp.classes_ == jp.classes_ and tp.input_dim == jp.input_dim
    x = _features()
    want = jp.predict_proba(x)
    got = tp.predict_proba(x)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)
    # A tensor goes in as well as an array.
    np.testing.assert_array_equal(tp.predict_proba(torch.from_numpy(x)), got)


@pytest.mark.parametrize("calibration", ["sigmoid", "temperature"])
def test_port_written_npz_loads_in_jax(tmp_path, calibration):
    weights, biases, cal = _params(calibration, seed=2)
    texport.save_head_npz(tmp_path / "model.npz",
                          thead.HeadParams(weights, biases, **cal))
    with np.load(tmp_path / "model.npz", allow_pickle=False) as got:
        jexport.save_head_npz(tmp_path / "ref.npz",
                              jhead.HeadParams(weights, biases, **cal))
        with np.load(tmp_path / "ref.npz", allow_pickle=False) as want:
            assert set(got.files) == set(want.files)
            for key in want.files:
                np.testing.assert_array_equal(got[key], want[key])


def _tamper(art, what):
    manifest = json.loads((art / "model.json").read_text())
    if what == "schema_version":
        manifest["schema_version"] = 999
    elif what == "class-count":
        manifest["classes"] = manifest["classes"][:-1]
    elif what == "input_dim":
        manifest["input_dim"] += 1
    elif what == "calibration":
        manifest["calibration"] = "temperature"
    elif what in ("missing required array", "inconsistent params"):
        with np.load(art / "model.npz", allow_pickle=False) as archive:
            arrays = dict(archive)
        if what == "missing required array":
            del arrays["W0"]
        else:
            arrays["b1"] = arrays["b1"][:-1]
        np.savez(art / "model.npz", **arrays)
    (art / "model.json").write_text(json.dumps(manifest))


@pytest.mark.parametrize("what", [
    "schema_version", "class-count", "input_dim", "calibration",
    "missing required array", "inconsistent params",
])
def test_load_gates_match_jax(tmp_path, what):
    art = write_artifact(tmp_path, "sigmoid")
    _tamper(art, what)
    with pytest.raises(JManifestError, match=what):
        jloader.load_predictor(art)
    with pytest.raises(TManifestError, match=what):
        tloader.load_predictor(art, device="cpu")


def test_legacy_manifest_without_calibration_reads_sigmoid(tmp_path):
    art = write_artifact(tmp_path, "sigmoid")
    manifest = json.loads((art / "model.json").read_text())
    del manifest["calibration"]
    (art / "model.json").write_text(json.dumps(manifest))
    assert tloader.load_predictor(art, device="cpu").head_params.calibration == "sigmoid"


def test_single_non_directory_argument_raises(tmp_path):
    art = write_artifact(tmp_path, "sigmoid")
    with pytest.raises(TManifestError, match="not an artifact directory"):
        tloader.load_predictor(art / "model.npz", device="cpu")


def test_predictor_checks_feature_width(tmp_path):
    tp = tloader.load_predictor(write_artifact(tmp_path, "sigmoid"), device="cpu")
    with pytest.raises(ValueError, match=f"width {DIMS[0]}"):
        tp.predict_proba(np.zeros((3, DIMS[0] + 2), np.float32))
    with pytest.raises(ValueError, match="2-D"):
        tp.predict_proba(np.zeros((DIMS[0],), np.float32))


@pytest.mark.parametrize("bad", [
    dict(weights=[np.zeros((4, 3))], biases=[np.zeros(3)], a=None, b=None),
    dict(weights=[np.zeros((4, 3))], biases=[np.zeros(3)], a=np.zeros((3, 1)),
         b=np.zeros((3, 1))),
    dict(weights=[np.zeros((4, 3))], biases=[np.zeros(3)], a=np.zeros(3),
         b=np.zeros(2)),
    dict(weights=[np.zeros((4, 3))], biases=[], a=np.zeros(3), b=np.zeros(3)),
    dict(weights=[], biases=[], a=np.zeros(3), b=np.zeros(3)),
    dict(weights=[np.zeros(4)], biases=[np.zeros(3)], a=np.zeros(3), b=np.zeros(3)),
    dict(weights=[np.zeros((4, 3))], biases=[np.zeros(2)], a=np.zeros(3),
         b=np.zeros(3)),
    dict(weights=[np.zeros((4, 3)), np.zeros((5, 2))],
         biases=[np.zeros(3), np.zeros(2)], a=np.zeros(2), b=np.zeros(2)),
    dict(weights=[np.zeros((4, 3))], biases=[np.zeros(3)], a=np.zeros(4),
         b=np.zeros(4)),
    dict(weights=[np.zeros((4, 3))], biases=[np.zeros(3)], temperature=0.0),
    dict(weights=[np.zeros((4, 3))], biases=[np.zeros(3)], temperature=2.0,
         a=np.zeros(3), b=None),
])
def test_head_params_validation_matches_jax(bad):
    with pytest.raises(ValueError) as jerr:
        jhead.HeadParams(**bad)
    with pytest.raises(ValueError) as terr:
        thead.HeadParams(**bad)
    assert str(terr.value) == str(jerr.value)


def _both_heads(x, *args, **kwargs):
    jparams = jhead.HeadParams(*args, **kwargs)
    tparams = thead.HeadParams(*args, **kwargs)
    want = np.asarray(jhead.head_apply(jparams.as_pytree(), jnp.asarray(x)))
    got = thead.head_apply(tparams.as_tensors("cpu"), torch.from_numpy(x)).numpy()
    return got, want


def test_sigmoid_zero_denominator_gives_uniform_rows():
    weights, biases, _ = _params("sigmoid")
    k = DIMS[-1]
    # sigmoid(-(a p + b)) underflows to 0 for every class: sum is 0.
    got, want = _both_heads(_features(5), weights, biases, np.zeros(k),
                            np.full(k, 1e3))
    np.testing.assert_array_equal(got, np.full((5, k), 1.0 / k, np.float32))
    np.testing.assert_array_equal(got, want)


def test_sigmoid_overshoot_is_clipped_to_one():
    """One class with c > 0 and the rest exactly 0 gives proba 1 (or a
    rounding overshoot of it), clipped to exactly 1.0 as in the JAX head."""
    weights, biases, _ = _params("sigmoid")
    k = DIMS[-1]
    b = np.full(k, 1e3, np.float32)
    b[2] = 0.0
    got, want = _both_heads(_features(4), weights, biases, np.zeros(k), b)
    assert np.all(got[:, 2] == 1.0) and np.all(got <= 1.0)
    np.testing.assert_array_equal(got, want)


def test_temperature_underflow_maps_to_zero_not_nan():
    weights, biases, _ = _params("temperature")
    weights = [w * 200 for w in weights]  # saturated softmax: log(0) = -inf
    got, want = _both_heads(_features(6), weights, biases, temperature=0.5)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-6
