"""The port's EfficientNet against the JAX package's: config round trip,
seeded initializer (bitwise), and the nn.Module forward with carried-over
weights against the flax forward (feature MAE < 1e-4, the fidelity gate of
tests/models/test_efficientnet.py)."""

import copy
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.models import efficientnet as jeff
from mermaid_classifier_tpu_torch.models import efficientnet as teff
from tests.models.test_efficientnet import TINY


def perturbed(variables: dict, seed: int) -> dict:
    """A copy of numpy variables with non-trivial BN statistics and affine
    (the seeded init has scale 1, var 1, mean 0, which hides folding and
    layout errors)."""
    out = copy.deepcopy(variables)
    rng = np.random.default_rng(seed)

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif key == "mean":
                tree[key] = (rng.standard_normal(val.shape) * 0.1).astype(np.float32)
            elif key == "var":
                tree[key] = (rng.random(val.shape) * 0.5 + 0.75).astype(np.float32)

    walk(out["batch_stats"])

    def walk_bn(tree):
        for key, val in tree.items():
            if key == "bn":
                val["scale"] = (1.0 + rng.standard_normal(val["scale"].shape) * 0.1).astype(np.float32)
                val["bias"] = (rng.standard_normal(val["bias"].shape) * 0.1).astype(np.float32)
            elif isinstance(val, dict):
                walk_bn(val)

    walk_bn(out["params"])
    return out


def jax_variables_numpy(config: jeff.EfficientNetConfig, seed: int = 0) -> dict:
    """The JAX package's seeded variables as nested dicts of numpy."""
    return jax.tree.map(np.asarray, jeff.init_backbone_params(seed, config))


def flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}['{key}']"
        if isinstance(val, dict) or hasattr(val, "items"):
            out.update(flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def port_config(config: jeff.EfficientNetConfig) -> teff.EfficientNetConfig:
    return teff.EfficientNetConfig.from_dict(config.to_dict())


class TestConfig:
    @pytest.mark.parametrize("variant", ["default", "b0", "b3"])
    def test_to_dict_matches_jax(self, variant):
        if variant == "default":
            j, t = jeff.EfficientNetConfig(), teff.EfficientNetConfig()
        else:
            j, t = jeff.variant_config(variant), teff.variant_config(variant)
        assert t.to_dict() == j.to_dict()
        assert teff.EfficientNetConfig.from_dict(j.to_dict()) == t
        assert jeff.EfficientNetConfig.from_dict(t.to_dict()) == j

    def test_from_dict_rejects_unknown_keys(self):
        with pytest.raises(ValueError, match="unknown EfficientNetConfig"):
            teff.EfficientNetConfig.from_dict({"patch_sise": 224})

    def test_partial_dict_takes_defaults(self):
        cfg = teff.EfficientNetConfig.from_dict({"feature_dim": 1280})
        assert cfg.feature_dim == 1280 and cfg.patch_size == 224

    def test_unknown_variant_raises(self):
        with pytest.raises(ValueError, match="unknown EfficientNet variant"):
            teff.variant_config("b9")

    @pytest.mark.parametrize("mode", ["symmetric", "tf_same"])
    def test_conv_padding_matches_jax(self, mode):
        for k in (1, 3, 5):
            for s in (1, 2):
                for size in (7, 14, 15, 28, 60, 112, 224):
                    assert tuple(teff.conv_padding(k, s, size, size + 1, mode)) == tuple(
                        jeff.conv_padding(k, s, size, size + 1, mode)
                    )
        with pytest.raises(ValueError, match="unknown padding mode"):
            teff.conv_padding(3, 1, 8, 8, "valid")


class TestInit:
    @pytest.mark.parametrize("which", ["tiny", "b0"])
    @pytest.mark.parametrize("seed", [0, 7])
    def test_bitwise_equal_to_jax(self, which, seed):
        jcfg = TINY if which == "tiny" else jeff.EfficientNetConfig()
        want = flatten(jax_variables_numpy(jcfg, seed))
        got = flatten(teff.init_backbone_params(seed, port_config(jcfg)))
        assert set(got) == set(want)
        for path, arr in want.items():
            assert got[path].dtype == arr.dtype and got[path].shape == arr.shape, path
            np.testing.assert_array_equal(got[path], arr, err_msg=path)


class TestModuleForward:
    @pytest.mark.parametrize("padding", ["symmetric", "tf_same"])
    def test_matches_flax(self, padding):
        jcfg = replace(TINY, padding=padding)
        variables = perturbed(jax_variables_numpy(jcfg), seed=3)
        x = np.random.default_rng(0).random((4, 32, 32, 3)).astype(np.float32)
        want = np.asarray(jeff.EfficientNetBackbone(config=jcfg).apply(
            jax.tree.map(jnp.asarray, variables), jnp.asarray(x)))
        module = teff.EfficientNetBackbone(port_config(jcfg)).eval()
        teff.load_jax_variables(module, variables)
        with torch.no_grad():
            got = module(torch.from_numpy(x)).numpy()
        assert got.shape == (4, TINY.feature_dim)
        mae = float(np.mean(np.abs(got - want)))
        assert mae < 1e-4, mae
        np.testing.assert_allclose(got, want, atol=5e-4)

    def test_tf_same_differs_from_symmetric(self):
        """The padding mode reaches the forward: on the same weights the
        two modes give different features (stride-2 at even sizes)."""
        variables = perturbed(jax_variables_numpy(TINY), seed=4)
        x = torch.from_numpy(
            np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32))
        outs = []
        for padding in ("symmetric", "tf_same"):
            module = teff.EfficientNetBackbone(
                port_config(replace(TINY, padding=padding))).eval()
            teff.load_jax_variables(module, variables)
            with torch.no_grad():
                outs.append(module(x).numpy())
        assert np.abs(outs[0] - outs[1]).max() > 1e-4

    def test_load_rejects_mismatched_variables(self):
        variables = jax_variables_numpy(TINY)
        module = teff.EfficientNetBackbone(
            port_config(replace(TINY, feature_dim=TINY.head_channels)))
        with pytest.raises(ValueError, match="do not match the module"):
            teff.load_jax_variables(module, variables)
