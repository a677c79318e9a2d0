"""The port's FeatureExtractor against the JAX package's, on the TINY config
of tests/models/test_efficientnet.py: the JAX side runs
``backbone_impl="fused", use_pallas=True`` (Pallas crop and fused block in
interpret mode), the port ``backbone_impl="fused"`` on the CPU (plain
versions). Bound: rel 1e-4, the JAX extractor tests' own."""

import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.models import extractor as jext
from mermaid_classifier_tpu_torch.models import extractor as text
from mermaid_classifier_tpu_torch.ops import fused_mbconv, patch_crop
from tests.models.test_efficientnet import TINY
from tests.test_torch_efficientnet import (
    jax_variables_numpy,
    perturbed,
    port_config,
)

OPTS = dict(backbone_batch=8, point_bucket=4, image_bucket=64)


@pytest.fixture(scope="module")
def weights():
    return perturbed(jax_variables_numpy(TINY), seed=11)


@pytest.fixture(scope="module")
def jax_extractor(weights):
    return jext.build_extractor(
        weights, TINY, backbone_impl="fused", use_pallas=True, **OPTS
    )


@pytest.fixture(scope="module")
def port_extractor(weights):
    return text.build_extractor(
        weights, port_config(TINY), device="cpu", backbone_impl="fused", **OPTS
    )


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _image_and_points(seed, h=70, w=90, n=11):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    pts = np.stack([rng.integers(0, h, n), rng.integers(0, w, n)], 1)
    pts[:3] = [[0, 0], [h - 1, w - 1], [0, w - 1]]
    return image, pts.astype(np.int32)


class TestAgainstJax:
    @pytest.mark.parametrize("impl", ["fused", "folded", "module"])
    def test_features_match(self, weights, jax_extractor, impl):
        port = text.build_extractor(
            weights, port_config(TINY), device="cpu", backbone_impl=impl, **OPTS
        )
        image, pts = _image_and_points(0)  # 11 points: two backbone chunks
        want = jax_extractor.extract_features(image, pts)
        got = port.extract_features(image, pts)
        assert got.shape == want.shape == (11, TINY.feature_dim)
        assert got.dtype == np.float32
        assert _rel(got, want) < 1e-4, impl

    def test_bucketing_matches_jax(self, jax_extractor, port_extractor):
        image, pts = _image_and_points(1, h=61, w=130, n=5)
        np.testing.assert_array_equal(
            port_extractor._prepare_image(image),
            jax_extractor._prepare_image(image),
        )
        np.testing.assert_array_equal(
            port_extractor._pad_starts(pts, 4), jax_extractor._pad_starts(pts, 4)
        )

    @pytest.mark.parametrize("hw", [(61, 130), (40, 20), (33, 1)])
    def test_features_match_on_raw_shapes(self, jax_extractor, port_extractor,
                                          hw):
        """Images off the 64-px buckets, narrower than a patch (20 < 32)
        and one pixel wide: the raw upload with the pad folded into the crop
        gives the JAX extractor's features."""
        image, pts = _image_and_points(8, h=hw[0], w=hw[1], n=5)
        want = jax_extractor.extract_features(image, pts)
        got = port_extractor.extract_features(image, pts)
        assert _rel(got, want) < 1e-4

    def test_patches_match_pallas_crop(self, jax_extractor, port_extractor):
        image, pts = _image_and_points(2)
        want = np.asarray(jax_extractor.extract_patches(image, pts))
        got = port_extractor.extract_patches(image, pts).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


class TestExtractor:
    def test_point_padding_does_not_leak(self, port_extractor):
        image, pts = _image_and_points(3, n=5)
        f_all = port_extractor.extract_features(image, pts)  # 5 -> 8
        f_first4 = port_extractor.extract_features(image, pts[:4])  # exact
        np.testing.assert_allclose(f_all[:4], f_first4, rtol=0, atol=1e-5)

    def test_crop_receives_the_raw_image(self, port_extractor, monkeypatch):
        """The extractor builds no padded copy: the crop is handed the raw
        (H, W, 3) uint8 image, once, with pad ps//2."""
        calls = []

        def capture(image, starts, patch_size, *args, **kwargs):
            calls.append((tuple(image.shape), image.dtype, kwargs.get("pad")))
            return patch_crop.extract_patches(image, starts, patch_size,
                                              *args, **kwargs)

        monkeypatch.setattr(text, "extract_patches", capture)
        image, pts = _image_and_points(9, h=61, w=130, n=5)
        port_extractor.extract_features(image, pts)
        assert calls == [((61, 130, 3), torch.uint8, TINY.patch_size // 2)]

    def test_non_uint8_image_is_cast_as_before(self, port_extractor):
        """An integer image of another dtype is cast to uint8 on upload, as
        the host-padded copy did."""
        image, pts = _image_and_points(10, n=3)
        np.testing.assert_array_equal(
            port_extractor.extract_features(image.astype(np.int64), pts),
            port_extractor.extract_features(image, pts))

    def test_empty_points(self, port_extractor):
        out = port_extractor.extract_features(
            np.zeros((50, 50, 3), np.uint8), np.zeros((0, 2), np.int32))
        assert out.shape == (0, TINY.feature_dim)

    def test_out_of_image_point_raises(self, port_extractor):
        image = np.zeros((50, 50, 3), np.uint8)
        for bad in ([[50, 10]], [[-1, 10]], [[10, 50]]):
            with pytest.raises(ValueError, match="outside the image"):
                port_extractor.extract_features(image, np.array(bad))
        with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
            port_extractor.extract_features(
                np.zeros((50, 50), np.uint8), np.array([[1, 1]]))

    def test_many_equals_per_image(self, port_extractor):
        items = [_image_and_points(4, n=5), _image_and_points(5, h=40, w=33, n=3),
                 (np.zeros((30, 30, 3), np.uint8), np.zeros((0, 2), np.int32)),
                 _image_and_points(6, n=9)]
        many = port_extractor.extract_features_many(items)
        assert [m.shape[0] for m in many] == [5, 3, 0, 9]
        assert port_extractor.extract_features_many([]) == []
        for got, (image, pts) in zip(many, items):
            np.testing.assert_allclose(
                got, port_extractor.extract_features(image, pts),
                rtol=0, atol=1e-5)

    def test_verify_device_numerics_passes(self, port_extractor):
        assert port_extractor.verify_device_numerics(n_patches=3) > 0.999

    def test_verify_device_numerics_catches_divergence(self, weights):
        ext = text.build_extractor(weights, port_config(TINY), device="cpu", **OPTS)
        forward = ext._forward
        ext._forward = lambda x: forward(x) + torch.randn(
            (x.shape[0], TINY.feature_dim), generator=torch.Generator().manual_seed(0))
        with pytest.raises(text.DeviceNumericsError, match="min cosine"):
            ext.verify_device_numerics(n_patches=3)

    def test_seeded_weights_reproducible(self):
        a = text.build_extractor(config=port_config(TINY), seed=7, device="cpu")
        b = text.build_extractor(config=port_config(TINY), seed=7, device="cpu")
        image = np.full((40, 40, 3), 128, np.uint8)
        pts = np.array([[20, 20]])
        np.testing.assert_array_equal(
            a.extract_features(image, pts), b.extract_features(image, pts))

    def test_rejects_unknown_impl(self):
        with pytest.raises(ValueError, match="backbone_impl"):
            text.build_extractor(config=port_config(TINY), device="cpu",
                                 backbone_impl="flax")


class TestNoFallback:
    def test_cuda_device_without_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            text.build_extractor(config=port_config(TINY), device="cuda")

    def test_device_is_required(self):
        with pytest.raises(TypeError):
            text.build_extractor(config=port_config(TINY))

    def test_cpu_extraction_launches_no_kernel(self, port_extractor):
        crop, fused = patch_crop.launches, fused_mbconv.launches
        image, pts = _image_and_points(7)
        port_extractor.extract_features(image, pts)
        assert (patch_crop.launches, fused_mbconv.launches) == (crop, fused)
