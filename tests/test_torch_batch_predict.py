"""The port's bulk feature classification against the JAX package's: the
same feature files and the same exported artifact through JAX
``load_predictor`` / ``predict_feature_files`` and the port's (head on the
CPU). Labels are identical and scores within 1e-6. Then the cases of
tests/serve/test_batch_predict.py on the port (without the sharded ones),
and the port's ``predict_features`` CLI, also from a ``store://`` spec."""

import csv

import numpy as np
import pytest

from mermaid_classifier_tpu.data.features_io import write_feature_file
from mermaid_classifier_tpu.inference import export_artifact
from mermaid_classifier_tpu.inference.loader import load_predictor as jload
from mermaid_classifier_tpu.serve import batch_predict as jbp
from mermaid_classifier_tpu.train.calibration import CalibratedClassifier
from mermaid_classifier_tpu.train.mlp_classifier import MLPClassifier
from mermaid_classifier_tpu_torch.inference.loader import load_predictor
from mermaid_classifier_tpu_torch.serve import batch_predict as tbp
from tests.torch_store_env import store_root_env  # noqa: F401

DIM, K = 16, 3


@pytest.fixture(scope="module")
def artifact_dir(tmp_path_factory):
    rng = np.random.default_rng(0)
    n = 200
    centers = rng.normal(0, 3, size=(K, DIM))
    y_idx = rng.integers(0, K, n)
    X = (rng.normal(0, 1, size=(n, DIM)) + centers[y_idx]).astype(np.float32)
    labels = np.array([f"ba-{i}::" for i in range(K)])
    clf = MLPClassifier(hidden_layer_sizes=(8,), random_state=0)
    for _ in range(5):
        clf.partial_fit(X, labels[y_idx], classes=list(labels))
    model = CalibratedClassifier.fit_from_scores(
        clf, clf.predict_proba(X), labels[y_idx])
    out = tmp_path_factory.mktemp("artifact")
    export_artifact(model, out, X[:16])
    return out


@pytest.fixture(scope="module")
def predictor(artifact_dir):
    return load_predictor(artifact_dir, device="cpu")


def _files(tmp_path, counts, seed=1):
    rng = np.random.default_rng(seed)
    paths = []
    for i, n_points in enumerate(counts):
        rowcols = rng.integers(0, 100, size=(n_points, 2)).astype(np.int64)
        features = rng.normal(0, 2, size=(n_points, DIM)).astype(np.float32)
        p = tmp_path / f"i{i}.features.npz"
        write_feature_file(p, rowcols, features)
        paths.append(p)
    return paths


@pytest.fixture()
def feature_files(tmp_path):
    paths = _files(tmp_path, (5, 1, 7))
    bare = tmp_path / "extra.npy"
    np.save(bare, np.random.default_rng(2).normal(size=(4, DIM)).astype(np.float32))
    return [*paths, bare]


def _assert_rows_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.source_file, g.row, g.col) == (w.source_file, w.row, w.col)
        assert g.labels == w.labels
        np.testing.assert_allclose(g.scores, w.scores, rtol=0, atol=1e-6)


@pytest.mark.parametrize("top_n,batch_size", [(K, 6), (1, 4096), (2, 5), (5, 1)])
def test_matches_jax(artifact_dir, predictor, feature_files, top_n, batch_size):
    want = jbp.predict_feature_files(jload(artifact_dir), feature_files,
                                     top_n=top_n, batch_size=batch_size)
    got = tbp.predict_feature_files(predictor, feature_files, top_n=top_n,
                                    batch_size=batch_size)
    _assert_rows_match(got, want)
    assert len(got) == 17


def test_csv_matches_jax(artifact_dir, predictor, feature_files, tmp_path):
    rows = {}
    for name, mod, pred in (("jax", jbp, jload(artifact_dir)),
                            ("port", tbp, predictor)):
        out = tmp_path / f"{name}.csv"
        mod.write_predictions_csv(
            mod.predict_feature_files(pred, feature_files, top_n=2), out, top_n=2)
        with out.open() as f:
            rows[name] = list(csv.reader(f))
    assert rows["port"][0] == rows["jax"][0]
    assert len(rows["port"]) == len(rows["jax"]) == 18
    # The CSV prints scores at 6 decimals: scores within 1e-6 may print one
    # unit of the last digit further apart.
    for g, w in zip(rows["port"][1:], rows["jax"][1:]):
        assert g[:4] == w[:4] and g[5] == w[5]
        assert abs(float(g[4]) - float(w[4])) <= 1e-6 + 1e-6
        assert abs(float(g[6]) - float(w[6])) <= 1e-6 + 1e-6


def test_load_feature_matrix_matches_jax(feature_files):
    for path in feature_files:
        for got, want in zip(tbp.load_feature_matrix(path),
                             jbp.load_feature_matrix(path)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_packed_matches_per_file(predictor, feature_files):
    rows = tbp.predict_feature_files(predictor, feature_files, top_n=K, batch_size=6)
    offset = 0
    for path in feature_files:
        _, features = tbp.load_feature_matrix(path)
        proba = predictor.predict_proba(features)
        for i in range(len(features)):
            r = rows[offset + i]
            assert r.source_file == str(path)
            order = np.argsort(proba[i])[::-1]
            assert list(r.labels) == [predictor.classes[j] for j in order]
            np.testing.assert_allclose(r.scores, proba[i][order], rtol=1e-5,
                                       atol=1e-7)
        offset += len(features)
    assert offset == len(rows) == 17


def test_npy_rowcols_are_minus_one(predictor, feature_files):
    rows = tbp.predict_feature_files(predictor, [feature_files[-1]], top_n=1)
    assert all(r.row == -1 and r.col == -1 for r in rows)


def test_csv_shape(predictor, feature_files, tmp_path):
    rows = tbp.predict_feature_files(predictor, feature_files[:1], top_n=2)
    out = tmp_path / "preds.csv"
    tbp.write_predictions_csv(rows, out, top_n=2)
    with out.open() as f:
        records = list(csv.reader(f))
    assert records[0] == [
        "file", "row", "col", "label_1", "score_1", "label_2", "score_2"]
    assert len(records) == 6
    assert float(records[1][4]) >= float(records[1][6])


def test_top_n_validation(predictor, feature_files):
    with pytest.raises(ValueError, match="top_n"):
        tbp.predict_feature_files(predictor, feature_files, top_n=0)


def test_bad_npy_shape_rejected(tmp_path):
    p = tmp_path / "bad.npy"
    np.save(p, np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="2-D"):
        tbp.load_feature_matrix(p)


def test_single_file_much_larger_than_batch(predictor, tmp_path):
    (p,) = _files(tmp_path, (53,), seed=7)
    rowcols, features = tbp.load_feature_matrix(p)
    rows = tbp.predict_feature_files(predictor, [p], top_n=1, batch_size=8)
    want = np.argmax(predictor.predict_proba(features), axis=1)
    assert [predictor.classes.index(r.labels[0]) for r in rows] == want.tolist()
    assert [(r.row, r.col) for r in rows] == [(int(a), int(b)) for a, b in rowcols]


def test_exact_batch_multiples_leave_no_leftovers(predictor, tmp_path):
    paths = _files(tmp_path, (4, 4, 8), seed=8)
    rows = tbp.predict_feature_files(predictor, paths, top_n=1, batch_size=8)
    assert [r.source_file for r in rows] == (
        [str(paths[0])] * 4 + [str(paths[1])] * 4 + [str(paths[2])] * 8)


def test_empty_file_among_inputs(predictor, tmp_path):
    empty = tmp_path / "empty.features.npz"
    write_feature_file(empty, np.zeros((0, 2), np.int64), np.zeros((0, DIM), np.float32))
    (full,) = _files(tmp_path, (3,), seed=9)
    rows = tbp.predict_feature_files(predictor, [empty, full, empty], top_n=1,
                                     batch_size=4)
    assert len(rows) == 3 and all(r.source_file == str(full) for r in rows)


class TestCLI:
    def test_end_to_end(self, artifact_dir, feature_files, tmp_path):
        from mermaid_classifier_tpu_torch.scripts import predict_features as cli

        out = tmp_path / "p.csv"
        rc = cli.main(["--classifier", str(artifact_dir), "--output", str(out),
                       "--top-n", "2", "--device", "cpu",
                       *[str(p) for p in feature_files]])
        assert rc == 0
        assert len(out.read_text().splitlines()) == 18

    def test_store_spec(self, artifact_dir, feature_files, tmp_path, store_root_env,
                        predictor):
        from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
        from mermaid_classifier_tpu_torch.scripts import predict_features as cli

        store = LocalFSObjectStore(tmp_path / "store")
        for name in ("model.npz", "model.json"):
            store.upload(artifact_dir / name, "models", f"reef/v1/{name}")
        store_root_env(tmp_path / "store")
        out = tmp_path / "s.csv"
        assert cli.main(["--classifier", "store://models/reef/v1/", "--output",
                         str(out), "--device", "cpu", str(feature_files[0])]) == 0
        want = tmp_path / "want.csv"
        tbp.write_predictions_csv(tbp.predict_feature_files(
            predictor, feature_files[:1]), want, top_n=3)
        assert out.read_text() == want.read_text()
