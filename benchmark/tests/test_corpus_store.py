"""The bulk mix's corpus and the in-memory store."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.corpus import Corpus, decode_jpeg
from benchmark.store import MemoryObjectStore
from mermaid_classifier_tpu_torch.data.feature_bucket import (
    FeatureBucketBuilder,
    annotations_key,
    feature_key,
)
from mermaid_classifier_tpu_torch.data.features_io import read_feature_file
from mermaid_classifier_tpu_torch.data.store import ObjectStoreError
from mermaid_classifier_tpu_torch.models.extractor import FeatureReadback

TRAFFIC = json.loads((Path(__file__).resolve().parents[1] / "traffic" / "bulk_200pt.json")
                     .read_text())


def test_the_jpegs_decode_at_the_three_sizes_with_200_points_each():
    store = MemoryObjectStore()
    corpus = Corpus(dict(TRAFFIC, jpeg_pool=3), seed=2**31 + 5, store=store)
    images = corpus.add_source("1", 6)
    assert [(i.h, i.w) for i in images] == [tuple(s) for s in TRAFFIC["image_sizes"]] * 2
    for img in images:
        pixels = decode_jpeg(store.get_bytes("imgs", img.key))
        assert pixels.shape == (img.h, img.w, 3) and pixels.dtype == np.uint8
        assert img.rowcols.shape == (200, 2)
        assert (img.rowcols >= 0).all() and (img.rowcols < [img.h, img.w]).all()
    lines = store.get_bytes("imgs", annotations_key("1")).decode().splitlines()
    assert len(lines) == 1 + 6 * 200
    again = Corpus(dict(TRAFFIC, jpeg_pool=3), seed=2**31 + 5, store=MemoryObjectStore())
    assert again.pool == corpus.pool
    assert np.array_equal(again.add_source("1", 6)[5].rowcols, images[5].rowcols)


class _ZeroExtractor:
    """Features of zeros, at once: only the builder's bookkeeping runs."""

    def extract_features_async(self, image, rowcols):
        import torch

        return FeatureReadback(torch.zeros((len(rowcols), 8)))


def test_a_source_run_leaves_every_expected_key(tmp_path):
    store = MemoryObjectStore()
    corpus = Corpus(dict(TRAFFIC, image_sizes=[[48, 64], [40, 56], [32, 48]], jpeg_pool=3,
                         points_per_image=5), seed=9, store=store)
    images = corpus.add_source("4", 5)
    result = FeatureBucketBuilder(store, "imgs", "out", _ZeroExtractor()).run(["4"])
    assert result.exit_code == 0 and result.sources[0].images_done == 5
    keys = set(store.list_keys("out"))
    assert keys == {annotations_key("4")} | {feature_key("4", i.image_id) for i in images}
    for img in images:
        (tmp_path / "f.npz").write_bytes(store.get_bytes("out", feature_key("4", img.image_id)))
        rowcols, features = read_feature_file(tmp_path / "f.npz")
        assert np.array_equal(rowcols, img.rowcols) and features.shape == (5, 8)


def test_the_store_keeps_bytes_by_bucket_and_key():
    store = MemoryObjectStore()
    store.put_bytes("a", "x/1", b"one")
    store.put_bytes("a", "y/2", b"two")
    store.put_bytes("b", "x/3", b"three")
    assert store.exists("a", "x/1") and not store.exists("b", "x/1")
    assert list(store.list_keys("a", prefix="x/")) == ["x/1"]
    assert store.get_bytes("b", "x/3") == b"three"
    store.delete("a", "x/1")
    with pytest.raises(ObjectStoreError):
        store.get_bytes("a", "x/1")
    assert list(store.list_keys("a")) == ["y/2"]


def test_the_store_keeps_only_what_it_is_told_to_keep():
    store = MemoryObjectStore(keep=lambda bucket, key: key.endswith(".csv"))
    store.put_bytes("t", "a.csv", b"kept")
    store.put_bytes("t", "f.npz", b"dropped bytes")
    assert store.get_bytes("t", "a.csv") == b"kept"
    assert store.exists("t", "f.npz") and store.size("t", "f.npz") == 13
    assert list(store.list_keys("t")) == ["a.csv", "f.npz"]
    with pytest.raises(ObjectStoreError):
        store.get_bytes("t", "f.npz")
