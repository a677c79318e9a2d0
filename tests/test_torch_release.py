"""The port's release flow (``serve/release.py``) on the cases of
tests/serve/test_release.py, on ``device="cpu"``: version names, artifact
validation, immutability, the fidelity-record gates, the refusal before
any write, rollback, and the ``v1`` / ``v12`` prefix rule. Also: one
port-exported artifact released by the JAX package and by the port into
two stores gives the same keys and bytes; the JAX ``validate_artifact``
accepts the port's artifact; and the ``release_artifact`` CLI publishes a
``models:/`` artifact once and refuses it the second time (exit 1, no
object changed)."""

import hashlib
import json
import logging
import shutil

import numpy as np
import pytest

from mermaid_classifier_tpu.data.store import LocalFSObjectStore as JStore
from mermaid_classifier_tpu.serve import release as jrelease
from mermaid_classifier_tpu_torch.config.settings import override_settings
from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
from mermaid_classifier_tpu_torch.inference import export_artifact
from mermaid_classifier_tpu_torch.serve.release import (
    ReleaseError,
    release_artifact,
    validate_artifact,
    validate_version,
)
from mermaid_classifier_tpu_torch.train.calibration import CalibratedClassifier
from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier

BUCKET = "release-bucket"


@pytest.fixture(scope="module")
def artifact_dir(tmp_path_factory):
    rng = np.random.default_rng(0)
    n, d, k = 150, 12, 3
    centers = rng.normal(0, 3, size=(k, d))
    y_idx = rng.integers(0, k, n)
    X = (rng.normal(0, 1, size=(n, d)) + centers[y_idx]).astype(np.float32)
    labels = np.array([f"ba-{i}::" for i in range(k)])
    clf = MLPClassifier(hidden_layer_sizes=(8,), random_state=0, device="cpu")
    for _ in range(4):
        clf.partial_fit(X, labels[y_idx], classes=list(labels))
    model = CalibratedClassifier.fit_from_scores(
        clf, clf.predict_proba(X), labels[y_idx], device="cpu")
    out = tmp_path_factory.mktemp("artifact")
    export_artifact(model, out, X[:16], enforce_torch_pin=False)
    return out


@pytest.fixture()
def store(tmp_path):
    return LocalFSObjectStore(tmp_path / "store")


def release(store, version, artifact, **kw):
    return release_artifact(store, BUCKET, version, artifact, device="cpu", **kw)


def objects(store):
    return {k: store.get_bytes(BUCKET, k) for k in store.list_keys(BUCKET)}


@pytest.mark.parametrize("version,ok", [
    ("v1", True), ("v42", True), ("1", False), ("v1.2", False),
    ("release-1", False), ("v", False), ("V3", False),
])
def test_version_regex(version, ok):
    if ok:
        validate_version(version)
    else:
        with pytest.raises(ReleaseError):
            validate_version(version)


def test_validate_artifact_ok(artifact_dir):
    manifest = validate_artifact(artifact_dir, device="cpu")
    assert manifest["classes"] == ["ba-0::", "ba-1::", "ba-2::"]
    assert jrelease.validate_artifact(artifact_dir) == manifest


@pytest.mark.parametrize("tamper,match", [
    (lambda m: m.pop("trained_with"), "provenance"),
    (lambda m: m.update(task="other-task"), "task"),
    (lambda m: m.update(schema_version=99), "load validation"),
    (lambda m: m.update(classes=["a"]), "load validation"),
])
def test_tampered_manifest_rejected(artifact_dir, tmp_path, tamper, match):
    bad = tmp_path / "bad"
    shutil.copytree(artifact_dir, bad)
    manifest = json.loads((bad / "model.json").read_text())
    tamper(manifest)
    (bad / "model.json").write_text(json.dumps(manifest))
    with pytest.raises(ReleaseError, match=match):
        validate_artifact(bad, device="cpu")
    with pytest.raises(jrelease.ReleaseError):
        jrelease.validate_artifact(bad)


def test_publish_and_immutability(store, artifact_dir):
    written = release(store, "v1", artifact_dir)
    assert sorted(written) == ["classifier/v1/model.json", "classifier/v1/model.npz"]
    assert store.exists(BUCKET, "classifier/v1/model.npz")
    before = objects(store)
    with pytest.raises(ReleaseError, match="immutable"):
        release(store, "v1", artifact_dir)
    assert objects(store) == before
    release(store, "v2", artifact_dir)


def _fidelity_record(path, weights_file, **overrides):
    record = {
        "all_green": True, "feature_mae": 2.1e-5, "feature_tol": 1e-4,
        "weights_sha256": hashlib.sha256(weights_file.read_bytes()).hexdigest(),
        "padding": "tf_same", **overrides,
    }
    path.write_text(json.dumps(record))
    return path


def test_backbone_extra_file_requires_fidelity_record(store, artifact_dir, tmp_path,
                                                      caplog):
    extra = tmp_path / "efficientnet_weights.npz"
    extra.write_bytes(b"weights")
    with pytest.raises(ReleaseError, match="fidelity"):
        release(store, "v1", artifact_dir, extra_files=[extra])
    assert list(store.list_keys(BUCKET, prefix="classifier/")) == []
    record = _fidelity_record(tmp_path / "fidelity.json", extra)
    written = release(store, "v1", artifact_dir, extra_files=[extra],
                      fidelity_record=record)
    assert "classifier/v1/efficientnet_weights.npz" in written
    with caplog.at_level(logging.WARNING,
                         logger="mermaid_classifier_tpu_torch.serve.release"):
        release(store, "v2", artifact_dir, extra_files=[extra],
                allow_unverified_backbone=True)
    assert any("UNVERIFIED" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("overrides,other,match", [
    ({}, True, "sha256 mismatch"),
    ({"all_green": False}, False, "FAILED"),
    ({"feature_mae": 2e-4}, False, "tolerance"),
    ("drop:feature_tol", False, "missing 'feature_tol'"),
    ("unreadable", False, "unreadable"),
])
def test_fidelity_record_gates(store, artifact_dir, tmp_path, overrides, other, match):
    extra = tmp_path / "efficientnet_weights.npz"
    extra.write_bytes(b"weights")
    source = tmp_path / "other.npz"
    source.write_bytes(b"different weights")
    record = _fidelity_record(tmp_path / "r.json", source if other else extra,
                              **(overrides if isinstance(overrides, dict) else {}))
    if overrides == "drop:feature_tol":
        data = json.loads(record.read_text())
        del data["feature_tol"]
        record.write_text(json.dumps(data))
    elif overrides == "unreadable":
        record.write_text("{not json")
    with pytest.raises(ReleaseError, match=match):
        release(store, "v1", artifact_dir, extra_files=[extra], fidelity_record=record)
    with pytest.raises(jrelease.ReleaseError, match=match):
        jrelease.release_artifact(JStore(tmp_path / "jstore"), BUCKET, "v1",
                                  artifact_dir, extra_files=[extra],
                                  fidelity_record=record)
    assert list(store.list_keys(BUCKET)) == []


def test_config_sidecar_needs_no_record(store, artifact_dir, tmp_path):
    sidecar = tmp_path / "backbone.config.json"
    sidecar.write_text("{}")
    assert "classifier/v1/backbone.config.json" in release(
        store, "v1", artifact_dir, extra_files=[sidecar])


def test_missing_extra_file_refused_before_write(store, artifact_dir):
    with pytest.raises(ReleaseError, match="does not exist"):
        release(store, "v1", artifact_dir, extra_files=["/nope/missing.npz"])
    assert list(store.list_keys(BUCKET, prefix="classifier/")) == []


def test_rollback_on_failure(store, artifact_dir, monkeypatch):
    calls = {"n": 0}
    real_put = store.put_bytes

    def failing_put(bucket, key, data):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk full")
        real_put(bucket, key, data)

    monkeypatch.setattr(store, "put_bytes", failing_put)
    with pytest.raises(OSError):
        release(store, "v1", artifact_dir)
    assert list(store.list_keys(BUCKET, prefix="classifier/")) == []


def test_v1_not_blocked_by_v12(store, artifact_dir):
    release(store, "v12", artifact_dir)
    assert "classifier/v1/model.npz" in release(store, "v1", artifact_dir)
    with pytest.raises(ReleaseError, match="immutable"):
        release(store, "v12", artifact_dir)


def test_release_keys_and_bytes_equal_jax(artifact_dir, tmp_path):
    extra = tmp_path / "efficientnet_weights.npz"
    extra.write_bytes(b"weights")
    record = _fidelity_record(tmp_path / "fidelity.json", extra)
    tstore, jstore = LocalFSObjectStore(tmp_path / "t"), JStore(tmp_path / "j")
    for version in ("v1", "v12"):
        tw = release(tstore, version, artifact_dir, extra_files=[extra],
                     fidelity_record=record)
        jw = jrelease.release_artifact(jstore, BUCKET, version, artifact_dir,
                                       extra_files=[extra], fidelity_record=record)
        assert tw == jw
    assert objects(tstore) == objects(jstore)


def test_release_artifact_cli(artifact_dir, tmp_path):
    from mermaid_classifier_tpu_torch.scripts import release_artifact as cli
    from mermaid_classifier_tpu_torch.tracking.local_tracker import LocalTracker

    tracker = LocalTracker(tmp_path / "tracking")
    tracker.register_model("reef", [artifact_dir / "model.npz",
                                    artifact_dir / "model.json"])
    argv = ["--artifact", "models:/reef", "--bucket", "releases",
            "--tracker-root", str(tracker.root), "--device", "cpu"]
    store = LocalFSObjectStore(tmp_path / "store")
    with override_settings(object_store_root=str(tmp_path / "store")):
        assert cli.main(["--version", "v1", *argv]) == 0
        before = {k: store.get_bytes("releases", k) for k in store.list_keys("releases")}
        assert sorted(before) == ["classifier/v1/model.json", "classifier/v1/model.npz"]
        assert before["classifier/v1/model.npz"] == (artifact_dir / "model.npz").read_bytes()
        assert cli.main(["--version", "v1", *argv]) == 1
        assert {k: store.get_bytes("releases", k)
                for k in store.list_keys("releases")} == before
        assert cli.main(["--version", "v12", *argv]) == 0
        assert cli.main(["--version", "v2", "--artifact", "models:/missing",
                         "--bucket", "releases", "--tracker-root", str(tracker.root),
                         "--device", "cpu"]) == 1
        assert cli.main(["--version", "2", *argv]) == 1
