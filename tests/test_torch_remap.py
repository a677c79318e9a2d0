"""The port's backbone-weight landing strip against the JAX package's:
``models/remap.py`` and ``torch_state_dict_to_variables`` on the same
checkpoints, and the converted port backbone against each checkpoint's own
forward.

The checkpoints are the two public module layouts rebuilt in
``tests/parity/foreign_checkpoints.py`` (torchvision with a DataParallel
``module.`` prefix; lukemelas, the pyspacer lineage, saved as CoralNet's
``{'net': {'module.<key>': ...}}`` dict) and the canonical mirror of each
package, all full B0 geometry from numpy / torch seeds. Remap and
conversion must give the JAX package's dict, table, dropped keys and
variables tree bit for bit; the port's backbone on the CPU must reproduce
each foreign forward at feature MAE < 1e-4 (the reference's contract), and
the lukemelas weights under symmetric padding must not.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.models import convert as jconv
from mermaid_classifier_tpu.models import efficientnet as jeff
from mermaid_classifier_tpu.models import remap as jremap
from mermaid_classifier_tpu_torch.models import canonical_mirror as tmirror
from mermaid_classifier_tpu_torch.models import convert as tconv
from mermaid_classifier_tpu_torch.models import efficientnet as teff
from mermaid_classifier_tpu_torch.models import remap as tremap
from tests.parity import foreign_checkpoints as fc
from tests.parity import torch_efficientnet_ref as jmirror
from tests.test_torch_efficientnet import flatten, port_config

FEATURE_TOL = 1e-4
PROBE = 3

# The JAX config each naming scheme's checkpoint is converted under.
CONFIGS = {
    "torchvision": jeff.EfficientNetConfig(feature_dim=1280, bn_eps=1e-5),
    "lukemelas": jeff.EfficientNetConfig(feature_dim=4096, padding="tf_same"),
    "canonical": jeff.EfficientNetConfig(feature_dim=4096),
}


def _load_pt(path):
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload.get("net", payload)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{scheme: (model whose forward is the oracle, state_dict as loaded
    from disk)}."""
    tmp = tmp_path_factory.mktemp("ckpt")
    out = {}
    tv = fc.build_torchvision_b0(seed=11)
    torch.save({f"module.{k}": v for k, v in tv.state_dict().items()},
               tmp / "tv.pt")
    out["torchvision"] = (tv, _load_pt(tmp / "tv.pt"))
    lm = fc.build_lukemelas_b0(seed=23, feature_dim=4096)
    fc.save_pyspacer_efficientnet_pt(lm, tmp / "efficientnet.pt")
    out["lukemelas"] = (lm, _load_pt(tmp / "efficientnet.pt"))
    torch.manual_seed(5)
    mirror = tmirror.CanonicalMirror(port_config(CONFIGS["canonical"]))
    tmirror.randomize_bn_stats(mirror, seed=5)
    mirror.eval()
    torch.save(mirror.state_dict(), tmp / "canonical.pt")
    out["canonical"] = (mirror, _load_pt(tmp / "canonical.pt"))
    return out


@pytest.fixture(scope="module")
def remapped(checkpoints):
    """{scheme: ((port dict, table, dropped), (JAX dict, table, dropped))}."""
    out = {}
    for scheme, (_model, sd) in checkpoints.items():
        jcfg = CONFIGS[scheme]
        out[scheme] = (
            tremap.remap_state_dict(tremap.strip_module_prefix(sd), port_config(jcfg)),
            jremap.remap_state_dict(jremap.strip_module_prefix(sd), jcfg),
        )
    return out


def _probe(seed=7, size=224):
    rng = np.random.default_rng(seed)
    nhwc = rng.normal(size=(PROBE, size, size, 3)).astype(np.float32)
    return nhwc, np.transpose(nhwc, (0, 3, 1, 2)).copy()


def _port_forward(variables, config, probe_nhwc):
    module = teff.EfficientNetBackbone(config)
    teff.load_jax_variables(module, variables)
    with torch.no_grad():
        return module.eval()(torch.from_numpy(probe_nhwc)).numpy()


def _oracle_forward(model, probe_nchw):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(probe_nchw)).numpy()


def _assert_same_tree(got, want):
    got, want = flatten(got), flatten(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("scheme", list(CONFIGS))
def test_scheme_detected_as_in_jax(checkpoints, scheme):
    sd = tremap.strip_module_prefix(checkpoints[scheme][1])
    assert tremap.detect_naming_scheme(sd) == scheme
    assert jremap.detect_naming_scheme(jremap.strip_module_prefix(
        checkpoints[scheme][1])) == scheme


@pytest.mark.parametrize("scheme", list(CONFIGS))
def test_remap_equals_jax(remapped, scheme):
    (tsd, tapplied, tdropped), (jsd, japplied, jdropped) = remapped[scheme]
    assert list(tsd) == list(jsd)
    for key in jsd:
        assert torch.equal(torch.as_tensor(tsd[key]), torch.as_tensor(jsd[key])), key
    assert tapplied == japplied
    assert tdropped == jdropped


@pytest.mark.parametrize("scheme", list(CONFIGS))
def test_every_checkpoint_key_accounted(checkpoints, remapped, scheme):
    (_, applied, dropped), _ = remapped[scheme]
    keys = set(tremap.strip_module_prefix(checkpoints[scheme][1]))
    assert set(applied) | set(dropped) == keys


def test_dropped_keys_are_heads_and_bookkeeping(remapped):
    (_, _, tv_dropped), _ = remapped["torchvision"]
    assert {"classifier.1.weight", "classifier.1.bias"} <= set(tv_dropped)
    assert all(k.startswith("classifier.") or k.endswith("num_batches_tracked")
               for k in tv_dropped)
    (_, lm_applied, lm_dropped), _ = remapped["lukemelas"]
    assert lm_applied["_fc.weight"] == "feature_projection.weight"
    assert all(k.endswith("num_batches_tracked") for k in lm_dropped)


@pytest.mark.parametrize("scheme", list(CONFIGS))
def test_conversion_equals_jax_bit_for_bit(remapped, scheme):
    (tsd, _, _), (jsd, _, _) = remapped[scheme]
    got = tconv.torch_state_dict_to_variables(tsd, port_config(CONFIGS[scheme]))
    want = jconv.torch_state_dict_to_variables(jsd, CONFIGS[scheme])
    _assert_same_tree(got, want)


def test_conversion_takes_numpy_and_tensors_alike(remapped):
    (tsd, _, _), _ = remapped["lukemelas"]
    config = port_config(CONFIGS["lukemelas"])
    as_numpy = {k: v.numpy() for k, v in tsd.items()}
    _assert_same_tree(tconv.torch_state_dict_to_variables(as_numpy, config),
                      tconv.torch_state_dict_to_variables(tsd, config))


@pytest.mark.parametrize("scheme", list(CONFIGS))
def test_port_backbone_reproduces_checkpoint_forward(checkpoints, remapped, scheme):
    (tsd, _, _), _ = remapped[scheme]
    config = port_config(CONFIGS[scheme])
    variables = tconv.torch_state_dict_to_variables(tsd, config)
    probe_nhwc, probe_nchw = _probe(seed=8)
    ours = _port_forward(variables, config, probe_nhwc)
    theirs = _oracle_forward(checkpoints[scheme][0], probe_nchw)
    assert ours.shape == theirs.shape == (PROBE, config.feature_dim)
    mae = float(np.mean(np.abs(ours - theirs)))
    assert mae < FEATURE_TOL, f"{scheme}: feature MAE {mae:.2e}"
    if scheme != "canonical":
        # The foreign weights keep the forward input-sensitive, so the MAE
        # is a claim about the propagation, not about a bias-dominated
        # constant (the default-initialised mirror's features are one).
        assert float(np.std(theirs, axis=0).mean()) > 100 * FEATURE_TOL


def test_lukemelas_under_symmetric_padding_does_not_reproduce(checkpoints, remapped):
    (tsd, _, _), _ = remapped["lukemelas"]
    wrong = port_config(jeff.EfficientNetConfig(feature_dim=4096))
    variables = tconv.torch_state_dict_to_variables(tsd, wrong)
    probe_nhwc, probe_nchw = _probe(seed=8)
    ours = _port_forward(variables, wrong, probe_nhwc)
    theirs = _oracle_forward(checkpoints["lukemelas"][0], probe_nchw)
    assert float(np.mean(np.abs(ours - theirs))) > FEATURE_TOL


def test_lukemelas_imagenet_fc_is_dropped_as_in_jax(tmp_path):
    model = fc.build_lukemelas_b0(seed=3, feature_dim=1000)
    sd = model.state_dict()
    got = tremap.remap_state_dict(sd, teff.EfficientNetConfig(), "lukemelas")
    want = jremap.remap_state_dict(sd, jeff.EfficientNetConfig(), "lukemelas")
    assert {"_fc.weight", "_fc.bias"} <= set(got[2])
    assert got[1] == want[1] and got[2] == want[2]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_truncated_checkpoint_raises(checkpoints, package):
    remap, conv, cfg = ((tremap, tconv, port_config(CONFIGS["torchvision"]))
                        if package == "port" else
                        (jremap, jconv, CONFIGS["torchvision"]))
    sd = dict(checkpoints["torchvision"][0].state_dict())
    sd.pop("features.3.0.block.1.0.weight")
    canonical, _, _ = remap.remap_state_dict(sd, cfg, "torchvision")
    with pytest.raises(conv.WeightConversionError, match="missing key"):
        conv.torch_state_dict_to_variables(canonical, cfg)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_alien_key_raises(checkpoints, package):
    remap, cfg = ((tremap, port_config(CONFIGS["torchvision"]))
                  if package == "port" else (jremap, CONFIGS["torchvision"]))
    sd = dict(checkpoints["torchvision"][0].state_dict())
    sd["features.3.0.block.9.0.weight"] = torch.zeros(1)
    with pytest.raises(remap.RemapError, match="no mapping"):
        remap.remap_state_dict(sd, cfg, "torchvision")


def test_unconsumed_and_misshapen_keys_raise(remapped):
    (tsd, _, _), _ = remapped["canonical"]
    config = port_config(CONFIGS["canonical"])
    extra = dict(tsd, **{"stray.weight": torch.zeros(1)})
    with pytest.raises(tconv.WeightConversionError, match="unconsumed"):
        tconv.torch_state_dict_to_variables(extra, config)
    tconv.torch_state_dict_to_variables(extra, config, strict=False)
    bad = dict(tsd, **{"feature_projection.bias": torch.zeros(7)})
    with pytest.raises(tconv.WeightConversionError, match="shape"):
        tconv.torch_state_dict_to_variables(bad, config)


def test_unrecognized_naming_raises():
    with pytest.raises(tremap.RemapError, match="unrecognized"):
        tremap.detect_naming_scheme(["resnet.layer1.weight"])
    with pytest.raises(tremap.RemapError, match="unknown scheme"):
        tremap.remap_state_dict({"stem.conv.weight": 0}, scheme="keras")


def test_module_prefix_only_when_uniform():
    assert tremap.strip_module_prefix({"module.a": 1, "module.b": 2}) == {"a": 1, "b": 2}
    mixed = {"module.a": 1, "b": 2}
    assert tremap.strip_module_prefix(mixed) == jremap.strip_module_prefix(mixed) == mixed


@pytest.mark.parametrize("variant", ["b0", "b3"])
def test_tables_equal_jax(variant):
    jcfg = jeff.variant_config(variant)
    tcfg = teff.variant_config(variant)
    assert tremap._torchvision_table(tcfg) == jremap._torchvision_table(jcfg)
    assert tremap._lukemelas_table(tcfg) == jremap._lukemelas_table(jcfg)


class TestCanonicalMirror:
    """The port's mirror is the JAX test mirror: the same parameters from
    the same torch seed, the same forward."""

    @pytest.mark.parametrize("padding", ["symmetric", "tf_same"])
    def test_state_and_forward_equal_jax_mirror(self, padding):
        jcfg = jeff.EfficientNetConfig(feature_dim=256, padding=padding,
                                       patch_size=64)
        torch.manual_seed(3)
        want = jmirror.TorchEfficientNetBackbone(jcfg)
        jmirror.randomize_bn_stats(want, seed=3)
        torch.manual_seed(3)
        got = tmirror.CanonicalMirror(port_config(jcfg))
        tmirror.randomize_bn_stats(got, seed=3)
        wsd, gsd = want.state_dict(), got.state_dict()
        assert list(gsd) == list(wsd)
        assert all(torch.equal(gsd[k], wsd[k]) for k in wsd)
        _, probe = _probe(seed=2, size=64)
        np.testing.assert_array_equal(_oracle_forward(got, probe),
                                      _oracle_forward(want, probe))

    def test_does_not_run_the_port_forward(self):
        import inspect

        source = inspect.getsource(tmirror)
        assert "EfficientNetBackbone" not in source
        assert "conv_padding" not in source and "pad_nchw" not in source
