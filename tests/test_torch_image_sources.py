"""The port's ``ImageFetcher`` against the JAX package's on the same specs:
a local file, a digit-named local file, ``store://`` URIs (through an
injected store and through ``OBJECT_STORE_ROOT``), CoralNet IDs through a
fake transport and the suffix-preserving cache, and the image-view page
parser. Also the port's ``.npy`` decode and the ``AnnotationRun`` image
route through the fetcher."""

import io
from pathlib import Path

import numpy as np
import pytest

from mermaid_classifier_tpu.data.store import LocalFSObjectStore as JStore
from mermaid_classifier_tpu.serve import image_sources as jsrc
from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore as TStore
from mermaid_classifier_tpu_torch.serve import image_sources as tsrc
from tests.torch_store_env import store_root_env  # noqa: F401


def png_bytes(seed: int, size=(6, 9)) -> bytes:
    from PIL import Image

    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, size=(*size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


class FakeTransport:
    def __init__(self):
        self.calls: list[int] = []

    def __call__(self, image_id: int):
        self.calls.append(image_id)
        return png_bytes(image_id), ".png"


def _both(fn):
    """fn(module, store class) for the JAX package and the port."""
    return [fn(jsrc, JStore), fn(tsrc, TStore)]


def test_local_paths_match_jax(tmp_path, monkeypatch):
    (tmp_path / "reef.png").write_bytes(png_bytes(1))
    (tmp_path / "00123").write_bytes(png_bytes(2))
    monkeypatch.chdir(tmp_path)

    def refuse(image_id):
        raise AssertionError("transport must not be called")

    for spec in (str(tmp_path / "reef.png"), tmp_path / "reef.png", "00123"):
        want, got = _both(lambda m, s: m.ImageFetcher(
            coralnet_transport=refuse).fetch(spec))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.uint8 and got.shape == (6, 9, 3)


def test_store_uri_matches_jax(tmp_path, store_root_env):
    def fetch(mod, store_cls):
        store = store_cls(tmp_path / mod.__name__.split(".")[0])
        store.put_bytes("imgs", "s1/i9.png", png_bytes(9))
        return mod.ImageFetcher(store=store).fetch("store://imgs/s1/i9.png")

    want, got = _both(fetch)
    np.testing.assert_array_equal(got, want)

    # Without an injected store, the port reads OBJECT_STORE_ROOT through
    # its settings.
    TStore(tmp_path / "root").put_bytes("imgs", "a.png", png_bytes(4))
    store_root_env(tmp_path / "root")
    np.testing.assert_array_equal(
        tsrc.ImageFetcher().fetch("store://imgs/a.png"),
        jsrc.decode_image_bytes(png_bytes(4)))


def test_coralnet_ids_and_cache_match_jax(tmp_path):
    def fetch(mod, _store_cls):
        transport = FakeTransport()
        cache = tmp_path / mod.__name__.split(".")[0] / "cache"
        fetcher = mod.ImageFetcher(cache_dir=cache, coralnet_transport=transport)
        images = [fetcher.fetch(42), fetcher.fetch("42"), fetcher.fetch(7)]
        (cache / "i5.jpeg").write_bytes(png_bytes(5))  # decoded by content
        images.append(fetcher.fetch(5))
        return images, transport.calls, sorted(p.name for p in cache.iterdir())

    (want, jcalls, jcache), (got, tcalls, tcache) = _both(fetch)
    assert tcalls == jcalls == [42, 7]
    assert tcache == jcache == ["i42.png", "i5.jpeg", "i7.png"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_coralnet_id_without_cache_calls_transport_each_time():
    transport = FakeTransport()
    fetcher = tsrc.ImageFetcher(coralnet_transport=transport)
    fetcher.fetch(123)
    fetcher.fetch("123")
    assert transport.calls == [123, 123]


@pytest.mark.parametrize("html,want", [
    ("""<html><body><div id="thumbnails"><img src="/thumb.png"></div>
        <div id="original_image_container"><div class="inner">
        <img src="https://cdn.example/full_i5.jpg"></div></div></body></html>""",
     "https://cdn.example/full_i5.jpg"),
    ("<html><img src='/x.png'></html>", None),
    ("""<div id="original_image_container"><div></div></div>
        <img src="/after.png">""", None),
])
def test_image_view_parser_matches_jax(html, want):
    parsers = [jsrc._OriginalImageParser(), tsrc._OriginalImageParser()]
    for p in parsers:
        p.feed(html)
    assert parsers[1].image_url == parsers[0].image_url == want


def test_npy_bytes_decode(tmp_path):
    image = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    buf = io.BytesIO()
    np.save(buf, image)
    np.testing.assert_array_equal(tsrc.decode_image_bytes(buf.getvalue()), image)
    bad = io.BytesIO()
    np.save(bad, image.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        tsrc.decode_image_bytes(bad.getvalue())


def test_annotation_run_fetches_its_image(tmp_path):
    """The CoralNet-ID route of ``AnnotationRun`` through an injected
    fetcher, with a stub extractor and head."""
    import torch

    from mermaid_classifier_tpu_torch.inference.loader import Predictor
    from mermaid_classifier_tpu_torch.serve.annotation import AnnotationRun

    predictor = Predictor(
        lambda arr: np.tile([0.75, 0.25], (len(arr), 1)), ["a::", "b::"],
        input_dim=4)

    class StubExtractor:
        device = torch.device("cpu")

        def extract_features_device(self, image, rowcols):
            assert image.shape == (6, 9, 3)
            return torch.ones((len(rowcols), 4))

    points = Path(tmp_path) / "points.csv"
    points.write_text("row,col\n2,3\n4,5\n")
    transport = FakeTransport()
    run = AnnotationRun("314", points, predictor, extractor=StubExtractor(),
                        fetcher=tsrc.ImageFetcher(coralnet_transport=transport))
    predictions = run.run()
    assert transport.calls == [314]
    assert [p.labels[0] for p in predictions] == ["a::", "a::"]
    assert run.summary()["image"] == "314"
