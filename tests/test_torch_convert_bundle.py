"""Backbone weight bundles across the two packages: a bundle saved by the
JAX package (npz + config sidecar) loads in the port to the same arrays and
config, one saved by the port loads in the JAX package, and the port's own
save/load round trip is exact, with and without a sidecar."""

import json
from dataclasses import replace

import numpy as np
import pytest

from mermaid_classifier_tpu.models import convert as jconv
from mermaid_classifier_tpu_torch.models import convert as tconv
from mermaid_classifier_tpu_torch.models import efficientnet as teff
from tests.models.test_efficientnet import TINY
from tests.test_torch_efficientnet import (
    flatten,
    jax_variables_numpy,
    perturbed,
    port_config,
)

CONFIG = replace(TINY, padding="tf_same", bn_eps=1e-5, compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def variables():
    return perturbed(jax_variables_numpy(TINY), seed=5)


def _assert_same_tree(got, want):
    got, want = flatten(got), flatten(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_jax_bundle_loads_in_port(tmp_path, variables):
    path = str(tmp_path / "weights.npz")
    jconv.save_backbone_npz(path, variables, CONFIG)
    got, config = tconv.load_backbone_bundle(path)
    _assert_same_tree(got, variables)
    assert config == port_config(CONFIG)
    assert config.to_dict() == CONFIG.to_dict()


def test_port_bundle_loads_in_jax(tmp_path, variables):
    path = str(tmp_path / "weights.npz")
    tconv.save_backbone_npz(path, variables, port_config(CONFIG))
    got, config = jconv.load_backbone_bundle(path)
    _assert_same_tree(got, variables)
    assert config == CONFIG


@pytest.mark.parametrize("with_config", [True, False])
def test_port_round_trip(tmp_path, variables, with_config):
    path = str(tmp_path / "w.npz")
    config = port_config(CONFIG) if with_config else None
    tconv.save_backbone_npz(path, variables, config)
    got, loaded = tconv.load_backbone_bundle(path)
    _assert_same_tree(got, variables)
    assert loaded == config
    assert tconv.backbone_sidecar_path(path) == str(tmp_path / "w.config.json")
    if with_config:
        sidecar = json.loads((tmp_path / "w.config.json").read_text())
        assert teff.EfficientNetConfig.from_dict(sidecar) == config


def test_flat_layout_matches_jax(variables):
    got = tconv.variables_to_flat_arrays(variables)
    want = jconv.variables_to_flat_arrays(variables)
    assert list(got) == list(want)
    _assert_same_tree(tconv.flat_arrays_to_variables(got), variables)
    assert tconv.backbone_sidecar_path("a/b") == jconv.backbone_sidecar_path("a/b")


def test_bundle_drives_the_port_extractor(tmp_path, variables):
    """Features from a loaded bundle equal those of the variables it holds."""
    from mermaid_classifier_tpu_torch.models.extractor import build_extractor

    path = str(tmp_path / "w.npz")
    config = port_config(TINY)
    tconv.save_backbone_npz(path, variables, config)
    loaded, loaded_config = tconv.load_backbone_bundle(path)
    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    rowcols = np.array([[0, 0], [39, 49], [20, 25]], np.int32)
    want = build_extractor(variables, config, device="cpu").extract_features(
        image, rowcols)
    got = build_extractor(loaded, loaded_config, device="cpu").extract_features(
        image, rowcols)
    np.testing.assert_array_equal(got, want)
