"""The port's packed feature cache (``native/fastbatch.{py,cpp}``) against
the JAX package's, and the port's trainer with and without it, on the CPU.

Held: the port's ``features.bin`` and ``index.json`` are the JAX writer's
bytes on the same feature files (through ``pack_feature_files`` and through
``ImageLabels.build_packed_cache``); the native gather, the numpy gather
and the JAX gather return the same bits, for empty index lists and repeated
indices too, and refuse the same out-of-range indices; each package reads
the other's cache; batches, ``load_into`` and a whole ``MermaidTrainer``
run (weights, loss curve, calibrated probabilities) are bit for bit the
same with the cache as without it, streamed and resident.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.data import labels as jlabels
from mermaid_classifier_tpu.native import fastbatch as jfb
from mermaid_classifier_tpu_torch.data import labels as tlabels
from mermaid_classifier_tpu_torch.data.features_io import write_feature_file
from mermaid_classifier_tpu_torch.native import fastbatch as tfb
from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier as TMLP
from mermaid_classifier_tpu_torch.train.trainer import MermaidTrainer

from tests.torch_training_data import port_labels, synthetic_tasks

DIM = 24


@pytest.fixture(scope="module")
def feature_items(tmp_path_factory):
    """(image_id, feature file, labels) of seeded files: 0 to 9 points."""
    tmp = tmp_path_factory.mktemp("feats")
    rng = np.random.default_rng(0)
    items = []
    for i, n in enumerate((3, 7, 1, 9, 4, 6)):
        path = tmp / f"img_{i:02d}.features.npz"
        rowcols = np.stack([np.arange(n) * 5 + 2, np.arange(n) * 3 + 1], 1)
        write_feature_file(path, rowcols.astype(np.int32),
                           rng.normal(size=(n, DIM)).astype(np.float32))
        items.append((f"img-{i}", path, [f"c{(i + j) % 3}" for j in range(n)]))
    return items


@pytest.fixture(scope="module")
def caches(tmp_path_factory, feature_items):
    """(port cache dir, JAX cache dir) packed from the same items."""
    tmp = tmp_path_factory.mktemp("caches")
    tfb.pack_feature_files(tmp / "port", feature_items, DIM).close()
    jfb.pack_feature_files(tmp / "jax", feature_items, DIM).close()
    return tmp / "port", tmp / "jax"


def test_native_library_builds_here():
    path = tfb.ensure_built()
    assert path is not None and path.parent.name == "_build"
    assert path.parent.parent.name == "mermaid_classifier_tpu_torch"
    assert tfb.native_available()


@pytest.mark.parametrize("name", [tfb.DATA_FILE, tfb.INDEX_FILE])
def test_cache_files_equal_jax_bytes(caches, name):
    port, jax = caches
    assert (port / name).read_bytes() == (jax / name).read_bytes()
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax))


INDEX_CASES = {
    "empty": [],
    "one": [4],
    "repeated": [5, 5, 0, 5, 29, 0, 29],
    "all_shuffled": list(np.random.default_rng(1).permutation(30)),
    "large": list(np.random.default_rng(2).integers(0, 30, 5000)),
}


@pytest.mark.parametrize("case", list(INDEX_CASES))
def test_gathers_agree_bit_for_bit(caches, case):
    port, jax = caches
    idx = np.asarray(INDEX_CASES[case], dtype=np.int64)
    with tfb.PackedFeatureCache(port, use_native=True) as native, \
            tfb.PackedFeatureCache(port, use_native=False) as numpy_path, \
            jfb.PackedFeatureCache(jax, use_native=True) as jnative:
        assert native.use_native and not numpy_path.use_native
        got = native.gather(idx, n_threads=4)
        assert got.dtype == np.float32 and got.shape == (len(idx), DIM)
        assert got.tobytes() == numpy_path.gather(idx).tobytes()
        assert got.tobytes() == jnative.gather(idx).tobytes()
        assert native.labels_at(idx) == jnative.labels_at(idx)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("bad", [-1, 30, 10**9])
def test_out_of_range_refused_as_in_jax(caches, use_native, bad):
    port, jax = caches
    idx = np.array([0, 3, bad], dtype=np.int64)
    with tfb.PackedFeatureCache(port, use_native=use_native) as cache, \
            pytest.raises(IndexError, match=f"index {bad} out of range"):
        cache.gather(idx)
    with jfb.PackedFeatureCache(jax, use_native=use_native) as cache, \
            pytest.raises(IndexError, match=f"index {bad} out of range"):
        cache.gather(idx)


def test_each_package_reads_the_others_cache(caches, feature_items):
    port, jax = caches
    with tfb.PackedFeatureCache(jax) as tcache, jfb.PackedFeatureCache(port) as jcache:
        assert tcache.images == jcache.images
        for image_id, path, labels in feature_items:
            rows = tcache.image_rows(image_id)
            np.testing.assert_array_equal(rows, jcache.image_rows(image_id))
            want = np.load(path)["features"]
            assert tcache.gather(rows).tobytes() == want.tobytes()
            assert tcache.labels_at(rows) == labels


def test_writer_refusals(tmp_path):
    writer = tfb.PackedFeatureCacheWriter(tmp_path / "c", DIM)
    writer.add_image("a", np.zeros((2, DIM), np.float32), ["x", "y"])
    with pytest.raises(ValueError, match="already added"):
        writer.add_image("a", np.zeros((1, DIM), np.float32), ["x"])
    with pytest.raises(ValueError, match="features must be"):
        writer.add_image("b", np.zeros((1, DIM + 1), np.float32), ["x"])
    with pytest.raises(ValueError, match="labels for"):
        writer.add_image("b", np.zeros((2, DIM), np.float32), ["x"])
    writer.abort()
    assert list((tmp_path / "c").iterdir()) == []


def test_truncated_data_file_refused(tmp_path, feature_items):
    tfb.pack_feature_files(tmp_path / "c", feature_items, DIM).close()
    data = tmp_path / "c" / tfb.DATA_FILE
    data.write_bytes(data.read_bytes()[:-4])
    with pytest.raises(ValueError, match="declares"):
        tfb.PackedFeatureCache(tmp_path / "c")


def test_failed_build_warns_and_falls_back(tmp_path, monkeypatch, caplog, caches):
    bad = tmp_path / "fastbatch.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tfb, "_SRC", bad)
    monkeypatch.setattr(tfb, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tfb, "_lib", None)
    monkeypatch.setattr(tfb, "_lib_failed", False)
    with caplog.at_level(logging.WARNING, logger=tfb.__name__):
        assert tfb.ensure_built() is None
        assert not tfb.native_available()
    assert any("native build failed" in r.getMessage() for r in caplog.records)
    assert [p.name for p in (tmp_path / "_build").iterdir()] == []
    with tfb.PackedFeatureCache(caches[0]) as cache:
        assert not cache.use_native
        assert cache.gather(np.array([1, 1])).shape == (2, DIM)


@pytest.fixture()
def both(tmp_path):
    return synthetic_tasks(tmp_path, n_images=24, pts_per_image=12, n_classes=4,
                           dim=DIM, seed=3)


def test_build_packed_cache_equals_jax(both, tmp_path):
    jtask, ttask = both
    for split in ("train", "ref", "val"):
        getattr(ttask, split).build_packed_cache(tmp_path / "t" / split)
        getattr(jtask, split).build_packed_cache(tmp_path / "j" / split)
        for name in (tfb.DATA_FILE, tfb.INDEX_FILE):
            assert (tmp_path / "t" / split / name).read_bytes() == \
                (tmp_path / "j" / split / name).read_bytes(), (split, name)


def test_reordered_annotations_pack_in_annotation_order(tmp_path, feature_items):
    """Annotations in another order than the file's rows (and a subset):
    the packed rows follow the annotations, as the file-backed path does."""
    labels = tlabels.ImageLabels()
    jl = jlabels.ImageLabels()
    for _, path, _ in feature_items:
        rowcols = np.load(path)["rowcols"]
        anns = [(int(r), int(c), f"k{i % 2}")
                for i, (r, c) in enumerate(rowcols[::-1][: max(1, len(rowcols) - 1)])]
        labels.add_image(str(path), anns)
        jl.add_image(str(path), anns)
    files = [labels.load_image_data(k)[0] for k in sorted(labels.data)]
    labels.build_packed_cache(tmp_path / "t")
    jl.build_packed_cache(tmp_path / "j")
    for key, want in zip(sorted(labels.data), files):
        assert labels.load_image_data(key)[0].tobytes() == want.tobytes()
    assert (tmp_path / "t" / tfb.DATA_FILE).read_bytes() == \
        (tmp_path / "j" / tfb.DATA_FILE).read_bytes()


@pytest.mark.parametrize("out_kind", ["numpy", "bf16_tensor"])
def test_load_into_equal_with_cache(both, tmp_path, out_kind):
    _, ttask = both
    split = ttask.train
    n = split.label_count

    def fill():
        if out_kind == "numpy":
            out = np.full((n + 3, DIM), -1.0, np.float32)
        else:
            out = torch.full((n + 3, DIM), -1.0, dtype=torch.bfloat16)
        split.load_into(out, offset=2, max_workers=3)
        return out.tobytes() if out_kind == "numpy" else \
            out.view(torch.int16).numpy().tobytes()

    plain = fill()
    split.build_packed_cache(tmp_path / "train")
    assert fill() == plain


def test_batches_equal_with_cache(both, tmp_path):
    _, ttask = both
    plain = list(ttask.train.load_data_in_batches(50, random_seed=4))
    ttask.train.build_packed_cache(tmp_path / "train")
    packed = list(ttask.train.load_data_in_batches(50, random_seed=4))
    assert [y for _, y in packed] == [y for _, y in plain]
    assert [x.tobytes() for x, _ in packed] == [x.tobytes() for x, _ in plain]


class _SmallTrainer(MermaidTrainer):
    def _make_classifier(self, class_weight):
        return TMLP(hidden_layer_sizes=(16,), learning_rate_init=1e-2,
                    class_weight=class_weight, random_state=0, device="cpu")


@pytest.mark.parametrize("resident", [False, True])
def test_trainer_with_cache_equals_without(tmp_path, resident):
    """The same run with ``packed_cache_dir`` and without it: the same
    weights, loss curve and calibrated probabilities, bit for bit."""
    runs = []
    for packed in (False, True):
        _, task = synthetic_tasks(tmp_path / str(packed), n_images=24,
                                  pts_per_image=12, n_classes=4, dim=DIM, seed=3)
        trainer = _SmallTrainer(
            batch_size=60, device="cpu", device_resident=resident,
            packed_cache_dir=str(tmp_path / f"cache_{packed}") if packed else None)
        clf_cal, val, msg = trainer(task, nbr_epochs=3, pc_models=[])
        # A file-backed copy of the val split: both runs see the same rows.
        x, _ = port_labels(task.val).load_all()
        runs.append((clf_cal, val, msg, x, trainer))
    (a, va, ma, xa, _), (b, vb, mb, xb, tb) = runs
    assert tb.packing_seconds is not None and runs[0][4].packing_seconds is None
    assert a.estimator.loss_curve_ == b.estimator.loss_curve_
    for wa, wb in zip(a.estimator.coefs_ + a.estimator.intercepts_,
                      b.estimator.coefs_ + b.estimator.intercepts_):
        assert np.asarray(wa).tobytes() == np.asarray(wb).tobytes()
    assert ma.ref_accs == mb.ref_accs and ma.acc == mb.acc
    assert va.scores == vb.scores and va.est == vb.est
    assert a.predict_proba(xa).tobytes() == b.predict_proba(xb).tobytes()
