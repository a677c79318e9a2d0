"""The port's ``annotate_image`` CLI against the JAX script on the same
image, points CSV, weights bundle (with its config sidecar) and head
artifact: the predictions written back into the points CSV agree (scores
within 1e-4, the slice bound of tests/test_torch_annotation.py; labels
wherever neighbouring scores are more than 1e-4 apart). Then the port's
report directory, the ``store://`` image and artifact specs, and the
``models:/`` error."""

import csv
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
from mermaid_classifier_tpu_torch.models.convert import save_backbone_npz
from mermaid_classifier_tpu_torch.models.extractor import build_extractor
from mermaid_classifier_tpu_torch.scripts import annotate_image as tcli
from mermaid_classifier_tpu_torch.serve import annotation as tann
from tests.models.test_efficientnet import TINY
from tests.test_torch_efficientnet import (
    jax_variables_numpy,
    perturbed,
    port_config,
)

REPO = Path(__file__).resolve().parents[1]
K = 4
ROWS = [0, 10, 50, 80, 95, 33, 60]
COLS = [0, 12, 64, 120, 127, 5, 99]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(dir, weights bundle, artifact dir, image png, points csv)."""
    from PIL import Image

    from mermaid_classifier_tpu_torch.inference import SCHEMA_VERSION
    from mermaid_classifier_tpu_torch.inference.export import save_head_npz
    from mermaid_classifier_tpu_torch.inference.head import HeadParams

    root = tmp_path_factory.mktemp("annotate")
    variables = perturbed(jax_variables_numpy(TINY), seed=21)
    weights = root / "weights.npz"
    save_backbone_npz(str(weights), variables, port_config(TINY))
    image = np.random.default_rng(1).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    Image.fromarray(image).save(root / "reef.png")
    points = root / "points.csv"
    points.write_text("Row,Column,note\n" + "".join(
        f"{r},{c},p{i}\n" for i, (r, c) in enumerate(zip(ROWS, COLS))))
    # A head whose first layer standardizes this image's features, so the
    # points get distinct probabilities.
    feats = build_extractor(variables, port_config(TINY), device="cpu").extract_features(
        image, np.stack([ROWS, COLS], 1))
    mean, std = feats.mean(0), feats.std(0) + 1e-12
    rng = np.random.default_rng(0)
    d = TINY.feature_dim
    w0 = rng.standard_normal((d, 12)) / (std[:, None] * np.sqrt(d))
    params = HeadParams(
        [w0.astype(np.float32), (rng.standard_normal((12, K)) * 2).astype(np.float32)],
        [(-(mean @ w0)).astype(np.float32), (rng.standard_normal(K) * 0.1).astype(np.float32)],
        (-rng.random(K) * 4 - 1).astype(np.float32),
        (rng.standard_normal(K) * 0.5).astype(np.float32))
    artifact = root / "artifact"
    artifact.mkdir()
    save_head_npz(artifact / "model.npz", params)
    (artifact / "model.json").write_text(json.dumps({
        "schema_version": SCHEMA_VERSION, "task": "t", "input_dim": d,
        "classes": [f"ba-{i}::gf-{i}" for i in range(K)], "calibration": "sigmoid"}))
    return root, weights, artifact, root / "reef.png", points


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "_jax_annotate_image", REPO / "scripts" / "annotate_image.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read(path):
    with open(path, newline="") as fh:
        reader = csv.DictReader(fh)
        return reader.fieldnames, list(reader)


def _args(weights, artifact, image, points, *extra):
    return ["--image", str(image), "--points", str(points), "--classifier",
            str(artifact), "--backbone-weights", str(weights), "--top-n", str(K),
            *extra]


def test_written_predictions_match_jax(inputs, tmp_path):
    _, weights, artifact, image, points = inputs
    jpoints, tpoints = tmp_path / "jax.csv", tmp_path / "port.csv"
    shutil.copy(points, jpoints)
    shutil.copy(points, tpoints)
    assert _jax_cli().main(_args(weights, artifact, image, jpoints)) == 0
    assert tcli.main(_args(weights, artifact, image, tpoints, "--device", "cpu")) == 0
    jcols, jrows = _read(jpoints)
    tcols, trows = _read(tpoints)
    assert tcols == jcols == ["row", "col", "note"] + [
        f"{kind}_{i}" for i in range(1, K + 1) for kind in ("pred", "score")]
    assert len(trows) == len(jrows) == len(ROWS)
    for jr, tr in zip(jrows, trows):
        assert (tr["row"], tr["col"], tr["note"]) == (jr["row"], jr["col"], jr["note"])
        want = {jr[f"pred_{i}"]: float(jr[f"score_{i}"]) for i in range(1, K + 1)}
        got = {tr[f"pred_{i}"]: float(tr[f"score_{i}"]) for i in range(1, K + 1)}
        assert set(got) == set(want)
        assert max(abs(got[k] - want[k]) for k in want) <= 1e-4
        scores = [float(jr[f"score_{i}"]) for i in range(1, K + 1)]
        for i in range(K - 1):
            if scores[i] - scores[i + 1] > 1e-4:
                assert tr[f"pred_{i + 1}"] == jr[f"pred_{i + 1}"]


def test_report_dir_matches_annotation_run(inputs, tmp_path):
    _, weights, artifact, image, points = inputs
    out = tmp_path / "report"
    assert tcli.main(_args(weights, artifact, image, points, "--device", "cpu",
                           "--output-dir", str(out))) == 0
    assert sorted(p.name for p in out.iterdir()) == ["predictions.csv", "summary.json"]
    from mermaid_classifier_tpu_torch.models.convert import load_backbone_bundle

    run = tann.AnnotationRun(
        str(image), points, artifact, top_n=K,
        extractor=build_extractor(*load_backbone_bundle(str(weights)), device="cpu"))
    run.write_predictions(tmp_path / "want.csv")
    assert (out / "predictions.csv").read_text() == (tmp_path / "want.csv").read_text()
    assert json.loads((out / "summary.json").read_text()) == run.summary()


def test_store_specs(inputs, tmp_path, monkeypatch):
    _, weights, artifact, image, points = inputs
    store = LocalFSObjectStore(tmp_path / "store")
    store.upload(image, "imgs", "s1/reef.png")
    for name in ("model.npz", "model.json"):
        store.upload(artifact / name, "models", f"reef/{name}")
    monkeypatch.setenv("OBJECT_STORE_ROOT", str(tmp_path / "store"))
    out_store, out_local = tmp_path / "a", tmp_path / "b"
    assert tcli.main(_args(weights, "store://models/reef", "store://imgs/s1/reef.png",
                           points, "--device", "cpu", "--output-dir",
                           str(out_store))) == 0
    assert tcli.main(_args(weights, artifact, image, points, "--device", "cpu",
                           "--output-dir", str(out_local))) == 0
    assert (out_store / "predictions.csv").read_text() == (
        out_local / "predictions.csv").read_text()


def test_resolve_store_spec_into_cache_dir(inputs, tmp_path):
    _, _, artifact, _, _ = inputs
    store = LocalFSObjectStore(tmp_path / "store")
    for name in ("model.npz", "model.json"):
        store.upload(artifact / name, "models", f"reef/v2/{name}")
    got = tann.resolve_classifier_artifact(
        "store://models/reef/v2/", store=store, cache_dir=tmp_path / "cache")
    assert got == tmp_path / "cache"
    assert (got / "model.json").read_bytes() == (artifact / "model.json").read_bytes()
    with pytest.raises(Exception, match="not found"):
        tann.resolve_classifier_artifact("store://models/none", store=store,
                                         cache_dir=tmp_path / "c2")


def test_registry_spec_names_tracking():
    with pytest.raises(ValueError, match="tracking/"):
        tann.resolve_classifier_artifact("models:/reef-model/v3")
