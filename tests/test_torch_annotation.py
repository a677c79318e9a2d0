"""The whole slice: ``AnnotationRun`` through the port and through the JAX
package on the same image, points CSV, weights and head artifact. The JAX
side runs ``backbone_impl="fused", use_pallas=True`` in interpret mode, the
port its CPU plain versions. Probabilities agree within 1e-4, and the top-N
labels agree wherever neighbouring scores are more than 1e-4 apart."""

import csv

import numpy as np
import pytest

from mermaid_classifier_tpu.models import extractor as jext
from mermaid_classifier_tpu.serve import annotation as jann
from mermaid_classifier_tpu_torch.models import extractor as text
from mermaid_classifier_tpu_torch.serve import annotation as tann
from tests.models.test_efficientnet import TINY
from tests.test_torch_efficientnet import (
    jax_variables_numpy,
    perturbed,
    port_config,
)

K = 5


class _ArrayFetcher:
    """ImageFetcher stand-in for the JAX run: serves one decoded array."""

    def __init__(self, image):
        self.image = image

    def fetch(self, spec):
        return self.image


ROWS = [0, 10, 50, 80, 95, 33, 60, 7, 88, 41, 12]
COLS = [0, 12, 64, 120, 127, 5, 99, 70, 30, 64, 127]


def _image():
    rng = np.random.default_rng(1)
    return rng.integers(0, 256, size=(96, 128, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory, extractors):
    """A sigmoid head whose first layer standardizes the image's features
    (seeded random weights over seeded random features would give every
    point nearly the same probabilities, and the test would compare
    little)."""
    import json

    from mermaid_classifier_tpu.inference.export import save_head_npz
    from mermaid_classifier_tpu.inference.head import HeadParams

    feats = extractors[0].extract_features(_image(), np.stack([ROWS, COLS], 1))
    mean, std = feats.mean(0), feats.std(0) + 1e-12
    rng = np.random.default_rng(0)
    dims = (TINY.feature_dim, 20, K)
    w0 = rng.standard_normal(dims[:2]) / (std[:, None] * np.sqrt(dims[0]))
    weights = [w0.astype(np.float32),
               (rng.standard_normal(dims[1:]) * 2.0).astype(np.float32)]
    biases = [(-(mean @ w0)).astype(np.float32),
              (rng.standard_normal(K) * 0.1).astype(np.float32)]
    a = (-rng.random(K) * 4 - 1).astype(np.float32)
    b = (rng.standard_normal(K) * 0.5).astype(np.float32)
    out = tmp_path_factory.mktemp("artifact")
    save_head_npz(out / "model.npz", HeadParams(weights, biases, a, b))
    (out / "model.json").write_text(json.dumps({
        "schema_version": 1, "task": "t", "input_dim": dims[0],
        "classes": [f"ba-{i}::gf-{i}" for i in range(K)],
        "calibration": "sigmoid",
    }))
    return out


@pytest.fixture(scope="module")
def extractors():
    weights = perturbed(jax_variables_numpy(TINY), seed=21)
    opts = dict(backbone_batch=8, point_bucket=4, image_bucket=64)
    return (
        jext.build_extractor(weights, TINY, backbone_impl="fused",
                             use_pallas=True, **opts),
        text.build_extractor(weights, port_config(TINY), device="cpu",
                             backbone_impl="fused", **opts),
    )


@pytest.fixture()
def image_and_points(tmp_path):
    image = _image()
    points_path = tmp_path / "points.csv"
    with open(points_path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["Row", "Column", "note"])
        for i, (r, c) in enumerate(zip(ROWS, COLS)):
            writer.writerow([r, c, f"p{i}"])
    return image, points_path


def _runs(image, points_path, artifact, extractors, tmp_path):
    jx, tx = extractors
    jrun = jann.AnnotationRun("reef", points_path, str(artifact), extractor=jx,
                              top_n=K, fetcher=_ArrayFetcher(image))
    trun = tann.AnnotationRun(image, points_path, str(artifact), extractor=tx,
                              top_n=K)
    return jrun, trun


def test_slice_matches_jax(image_and_points, artifact, extractors, tmp_path):
    image, points_path = image_and_points
    jrun, trun = _runs(image, points_path, artifact, extractors, tmp_path)
    jpreds, tpreds = jrun.run(), trun.run()
    assert len(tpreds) == len(jpreds) == 11
    assert trun.proba.shape == (11, K)
    np.testing.assert_allclose(trun.proba.sum(axis=1), 1.0, atol=1e-6)
    for jp, tp in zip(jpreds, tpreds):
        assert (tp.row, tp.col) == (jp.row, jp.col)
        assert tp.scores == sorted(tp.scores, reverse=True)
        want = dict(zip(jp.labels, jp.scores))
        got = dict(zip(tp.labels, tp.scores))
        assert set(got) == set(want)
        assert max(abs(got[k] - want[k]) for k in want) <= 1e-4
        for i in range(K - 1):
            if jp.scores[i] - jp.scores[i + 1] > 1e-4:
                assert tp.labels[: i + 1] == jp.labels[: i + 1]
    assert trun.summary()["label_counts"] == jrun.summary()["label_counts"]
    assert trun.summary()["n_points"] == 11


def test_write_predictions_matches_jax(image_and_points, artifact, extractors,
                                       tmp_path):
    image, points_path = image_and_points
    jrun, trun = _runs(image, points_path, artifact, extractors, tmp_path)
    jout = jrun.write_predictions(tmp_path / "jax.csv")
    tout = trun.write_predictions(tmp_path / "port.csv")
    with open(jout, newline="") as fh:
        jrows = list(csv.DictReader(fh))
    with open(tout, newline="") as fh:
        reader = csv.DictReader(fh)
        tcols = reader.fieldnames
        trows = list(reader)
    assert tcols == ["row", "col", "note"] + [
        f"{kind}_{i}" for i in range(1, K + 1) for kind in ("pred", "score")]
    assert len(trows) == len(jrows)
    for jr, tr in zip(jrows, trows):
        assert (tr["row"], tr["col"], tr["note"]) == (jr["row"], jr["col"], jr["note"])
        assert tr["pred_1"] == jr["pred_1"]
        assert abs(float(tr["score_1"]) - float(jr["score_1"])) <= 1e-4


def test_image_paths(tmp_path, image_and_points, artifact, extractors):
    image, points_path = image_and_points
    np.save(tmp_path / "reef.npy", image)
    from PIL import Image

    Image.fromarray(image).save(tmp_path / "reef.png")
    _, tx = extractors
    want = tann.AnnotationRun(image, points_path, artifact, extractor=tx)
    want.run()
    for name in ("reef.npy", "reef.png"):
        run = tann.AnnotationRun(tmp_path / name, points_path, artifact,
                                 extractor=tx)
        run.run()
        np.testing.assert_array_equal(run.proba, want.proba)


def test_read_points_csv_aliases(tmp_path):
    for header in (["row", "col"], ["Row", "Column"], ["ROW", "COL"],
                   ["Row", "column"]):
        path = tmp_path / "p.csv"
        path.write_text(",".join(header + ["label"]) + "\n3,4,x\n5,6,y\n")
        table = tann.read_points_csv(path)
        assert table.columns == ["row", "col", "label"]
        np.testing.assert_array_equal(table.rowcols(), [[3, 4], [5, 6]])
        assert table.records[1]["label"] == "y"


def test_read_points_csv_missing_column(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("x\n1\n")
    with pytest.raises(ValueError, match="no row column"):
        tann.read_points_csv(path)


def test_resolve_classifier_artifact(tmp_path, artifact):
    assert tann.resolve_classifier_artifact(artifact) == artifact
    with pytest.raises(FileNotFoundError, match="does not exist"):
        tann.resolve_classifier_artifact(tmp_path / "nope")
    (tmp_path / "half").mkdir()
    (tmp_path / "half" / "model.npz").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="missing model.json"):
        tann.resolve_classifier_artifact(tmp_path / "half")
    with pytest.raises(FileNotFoundError, match="no registered model"):
        tann.resolve_classifier_artifact("models:/reef-model",
                                         tracker_root=tmp_path / "tracking")


def test_feature_dim_mismatch_raises(image_and_points, artifact):
    from dataclasses import replace

    image, points_path = image_and_points
    wrong = text.build_extractor(
        config=port_config(replace(TINY, feature_dim=8)), device="cpu")
    run = tann.AnnotationRun(image, points_path, artifact, extractor=wrong)
    with pytest.raises(ValueError, match=f"expects {TINY.feature_dim}"):
        run.run()
