"""The port's data containers (``data/features_io.py``, ``data/labels.py``,
``data/results.py``) against the JAX package's, on the same seeded files.

Every comparison here is exact: the same split, the same image order, batch
boundaries, label order and row indices, the same feature bytes, and the
resident staging bits (int8 rows and scales equal; bf16 compared as uint16
against ``jnp.bfloat16``)."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.data import features_io as jio
from mermaid_classifier_tpu.data import labels as jlabels
from mermaid_classifier_tpu.data import results as jresults
from mermaid_classifier_tpu.train import trainer as jtrainer
from mermaid_classifier_tpu_torch.data import features_io as tio
from mermaid_classifier_tpu_torch.data import labels as tlabels
from mermaid_classifier_tpu_torch.data import results as tresults
from mermaid_classifier_tpu_torch.train import trainer as ttrainer

from tests.torch_training_data import port_labels, synthetic_tasks
from tests.data.test_labels import build_synthetic_labels

SPLITS = ("train", "ref", "val")


@pytest.fixture()
def tasks(tmp_path):
    # 37 images of 7 points: batches of 64 close on an image boundary, so
    # they vary in size and leave a short tail.
    return synthetic_tasks(tmp_path, n_images=37, pts_per_image=7,
                           n_classes=4, dim=6, seed=3)


@pytest.mark.parametrize("ratios", [(0.15, 0.15), (0.1, 0.1), (0.0, 0.3)])
def test_split_equals_jax(tmp_path, ratios):
    jt, tt = synthetic_tasks(tmp_path, split_ratios=ratios, n_images=23,
                             pts_per_image=5, n_classes=5, seed=1)
    for name in SPLITS:
        assert getattr(tt, name).data == getattr(jt, name).data, name
    assert tt.label_count == jt.label_count


def test_split_errors_equal_jax(tmp_path):
    labels, _ = build_synthetic_labels(tmp_path, n_images=3)
    for ratios in ((0.5, 0.5), (-0.1, 0.2)):
        with pytest.raises(ValueError) as jerr:
            jlabels.preprocess_labels(labels, split_ratios=ratios)
        with pytest.raises(ValueError) as terr:
            tlabels.preprocess_labels(port_labels(labels), split_ratios=ratios)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("seed", [None, 0, 1, 7])
@pytest.mark.parametrize("batch_size", [1, 20, 64, 1000])
def test_index_batches_equal_jax(tasks, seed, batch_size):
    """iter_index_batches: the JAX image order, batch boundaries, indices and
    labels, for every split."""
    jt, tt = tasks
    for name in SPLITS:
        want = list(getattr(jt, name).iter_index_batches(batch_size, seed))
        got = list(getattr(tt, name).iter_index_batches(batch_size, seed))
        assert len(got) == len(want)
        for (gi, gy), (wi, wy) in zip(got, want):
            assert gi.dtype == np.int32
            np.testing.assert_array_equal(gi, wi)
            assert gy == wy


@pytest.mark.parametrize("seed", [None, 0, 5])
def test_data_batches_equal_jax_and_index_twin(tasks, seed):
    """load_data_in_batches equals JAX's, and each batch is load_all's rows
    at the index twin's indices."""
    jt, tt = tasks
    for name in SPLITS:
        jsplit, tsplit = getattr(jt, name), getattr(tt, name)
        x_all, y_all = tsplit.load_all()
        batches = zip(tsplit.load_data_in_batches(64, seed),
                      jsplit.load_data_in_batches(64, seed),
                      tsplit.iter_index_batches(64, seed))
        for (tx, ty), (jx, jy), (idx, iy) in batches:
            np.testing.assert_array_equal(tx, jx)
            assert ty == jy == iy
            np.testing.assert_array_equal(tx, x_all[idx])
            assert ty == [y_all[i] for i in idx]


def test_label_views_equal_jax(tasks):
    jt, tt = tasks
    for name in SPLITS:
        j, t = getattr(jt, name), getattr(tt, name)
        assert t.row_ranges() == j.row_ranges()
        assert t.classes_set == j.classes_set
        assert t.label_count_per_class == j.label_count_per_class
        assert list(t.annotation_items()) == list(j.annotation_items())
        assert t.image_keys == j.image_keys and len(t) == len(j)
        key = t.image_keys[0]
        for got, want in zip(t.load_image_data(key), j.load_image_data(key)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError, match="already added"):
        tt.train.add_image(tt.train.image_keys[0], [])


def _stage(task, dtype, workers, jax_side):
    """The three splits into one [train | ref | val] buffer, as the trainer
    stages them; returns (rows, scale)."""
    spans = [getattr(task, n) for n in SPLITS if len(getattr(task, n))]
    pos = sum(s.label_count for s in spans)
    dim = spans[0].load_all()[0].shape[1]
    scale = transform = None
    if dtype == "int8":
        out = np.empty((pos, dim), np.int8)
        scale = np.empty(pos, np.float32)
        transform = (_jax_int8_transform(scale) if jax_side
                     else ttrainer._int8_rows_into(scale))
    elif dtype == "bfloat16":
        out = (np.empty((pos, dim), jnp.bfloat16) if jax_side
               else torch.empty((pos, dim), dtype=torch.bfloat16))
    else:
        out = np.empty((pos, dim), np.float32)
    seen = []
    lock = threading.Lock()

    def filled(start, n):
        with lock:
            seen.append((start, n))

    off = 0
    for split in spans:
        split.load_into(out, off, max_workers=workers, row_transform=transform,
                        on_rows_filled=filled)
        off += split.label_count
    covered = np.zeros(pos, int)
    for start, n in seen:
        covered[start:start + n] += 1
    assert (covered == 1).all()  # every row published exactly once
    return out, scale


def _jax_int8_transform(scale_vec):
    """The JAX trainer's inline int8 transform (trainer.py, resident
    staging), taken as it is there."""
    tiny = np.finfo(np.float32).tiny

    def row_transform(x, out_rows, buffer_row):
        s = np.maximum(x.max(axis=1), -x.min(axis=1))
        s /= 127.0
        s[s < tiny] = 1.0
        inv = (1.0 / s).astype(np.float32)
        t = x * inv[:, None]
        np.rint(t, out=t)
        np.clip(t, -127.0, 127.0, out=t)
        out_rows[...] = t
        scale_vec[buffer_row: buffer_row + len(s)] = s

    return row_transform


@pytest.mark.parametrize("workers", [None, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_load_into_staging_bits_equal_jax(tasks, dtype, workers):
    """The resident staging buffer, bit for bit: f32 rows, int8 rows and
    scales, bf16 rows as uint16 against ``jnp.bfloat16`` staging (the JAX
    trainer's), and against the JAX int8 formula on the f32 rows."""
    jt, tt = tasks
    got, got_scale = _stage(tt, dtype, workers, jax_side=False)
    want, want_scale = _stage(jt, dtype, workers, jax_side=True)
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(want).view(np.uint16))
        f32, _ = _stage(tt, "float32", workers, jax_side=False)
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16),
            np.asarray(jnp.asarray(f32, jnp.bfloat16)).view(np.uint16))
    else:
        np.testing.assert_array_equal(got, want)
    if dtype == "int8":
        np.testing.assert_array_equal(got_scale, want_scale)
        from mermaid_classifier_tpu.train.mlp_classifier import MLPClassifier as JMLP

        f32, _ = _stage(tt, "float32", workers, jax_side=False)
        scale = JMLP._int8_row_scales(f32)
        np.testing.assert_array_equal(got_scale, scale)
        np.testing.assert_array_equal(
            got, JMLP._quantize_matrix_int8(f32, (1.0 / scale).astype(np.float32)))


def test_load_into_rejects_small_buffer(tasks):
    _, tt = tasks
    n = tt.train.label_count
    with pytest.raises(ValueError, match="cannot hold"):
        tt.train.load_into(np.empty((n - 1, 6), np.float32))
    with pytest.raises(ValueError, match="cannot hold"):
        tt.train.load_into(torch.empty((n, 6), dtype=torch.bfloat16), offset=1)


def test_load_into_reordered_points(tmp_path):
    """Annotations in another order than the file's points go through the
    gather, into numpy and into a bf16 tensor alike."""
    rng = np.random.default_rng(0)
    rowcols = np.stack([np.arange(6) * 3, np.arange(6) * 5], 1).astype(np.int32)
    feats = rng.standard_normal((6, 5)).astype(np.float32)
    path = str(tmp_path / "a.features.npz")
    tio.write_feature_file(path, rowcols, feats)
    order = [4, 0, 5]
    labels = tlabels.ImageLabels()
    labels.add_image(path, [(int(rowcols[i, 0]), int(rowcols[i, 1]), f"c{i}")
                            for i in order])
    out = np.zeros((3, 5), np.float32)
    labels.load_into(out)
    np.testing.assert_array_equal(out, feats[order])
    out16 = torch.zeros((3, 5), dtype=torch.bfloat16)
    labels.load_into(out16)
    assert torch.equal(out16, torch.from_numpy(feats[order]).to(torch.bfloat16))


def test_feature_io_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    rowcols = rng.integers(0, 3000, (17, 2)).astype(np.int32)
    feats = rng.standard_normal((17, 31)).astype(np.float32)
    tio.write_feature_file(tmp_path / "t.features.npz", rowcols, feats)
    jio.write_feature_file(tmp_path / "j.features.npz", rowcols, feats)
    for path in ("t.features.npz", "j.features.npz"):
        for reader in (tio.read_feature_file, tio.read_feature_file_mapped,
                       jio.read_feature_file, jio.read_feature_file_mapped):
            r, f = reader(tmp_path / path)
            np.testing.assert_array_equal(r, rowcols)
            np.testing.assert_array_equal(np.asarray(f), feats)
    assert isinstance(tio.read_feature_file_mapped(tmp_path / "t.features.npz")[1],
                      np.memmap)
    assert list(tmp_path.glob("*.part")) == []
    want = [(int(rowcols[i, 0]), int(rowcols[i, 1])) for i in (5, 0, 16)]
    np.testing.assert_array_equal(tio.select_point_features(rowcols, feats, want),
                                  jio.select_point_features(rowcols, feats, want))
    for bad in ([(1, 1)],):
        with pytest.raises(KeyError) as jerr:
            jio.select_point_rows(rowcols, bad)
        with pytest.raises(KeyError) as terr:
            tio.select_point_rows(rowcols, bad)
        assert str(terr.value) == str(jerr.value)


def test_feature_io_shape_errors_equal_jax(tmp_path):
    for args in ((np.zeros((2, 3)), np.zeros((2, 4))),
                 (np.zeros((2, 2)), np.zeros((3, 4)))):
        with pytest.raises(ValueError) as jerr:
            jio.write_feature_file(tmp_path / "x.npz", *args)
        with pytest.raises(ValueError) as terr:
            tio.write_feature_file(tmp_path / "x.npz", *args)
        assert str(terr.value) == str(jerr.value)


class _Frozen:
    """A fixed linear scorer with classes_ and predict_proba."""

    def __init__(self, classes, dim, seed=0):
        self.classes_ = np.asarray(classes)
        self.w = np.random.default_rng(seed).standard_normal((dim, len(classes)))

    def predict_proba(self, x):
        z = np.asarray(x, np.float64) @ self.w
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("batch_size", [16, 5000])
def test_evaluate_classifier_equals_jax(tasks, batch_size):
    jt, tt = tasks
    clf = _Frozen(sorted(tt.ref.classes_set), 6)
    got = tlabels.evaluate_classifier(clf, tt.val, batch_size=batch_size)
    want = jlabels.evaluate_classifier(clf, jt.val, batch_size=batch_size)
    assert got == want


def test_results_equal_jax():
    args = dict(scores=[0.5, 0.9], gt=[0, 1], est=[1, 1], classes=["a", "b"])
    assert tresults.ValResults(**args).to_dict() == jresults.ValResults(**args).to_dict()
    msg = dict(acc=0.5, pc_accs=[0.1], ref_accs=[0.2, 0.3], runtime=1.5,
               extra={"k": 1})
    assert (tresults.TrainClassifierReturnMsg(**msg).to_dict()
            == jresults.TrainClassifierReturnMsg(**msg).to_dict())
    for bad in (dict(args, gt=[0]), dict(args, est=[0, 2])):
        with pytest.raises(ValueError) as jerr:
            jresults.ValResults(**bad)
        with pytest.raises(ValueError) as terr:
            tresults.ValResults(**bad)
        assert str(terr.value) == str(jerr.value)


def test_trainer_constants_equal_jax():
    assert ttrainer.PRODUCTION_HIDDEN_LAYERS == jtrainer.PRODUCTION_HIDDEN_LAYERS
    assert ttrainer.PRODUCTION_LEARNING_RATE == jtrainer.PRODUCTION_LEARNING_RATE
    assert ttrainer.PRODUCTION_RANDOM_STATE == jtrainer.PRODUCTION_RANDOM_STATE
