"""The port's full-trunk A/B harness against the JAX package's, on the CPU.

Every schedule that ``chip_smoke.py`` drives runs on tests/ops/
test_trunk_ab.py's ``TINY`` and on the 64-px full-B0-topology config of
tests/test_torch_fused_mbconv.py, with the same perturbed weights and
inputs on both sides. The JAX side runs its Pallas kernels in interpret
mode through ``apply_folded(..., interpret=True)`` on the same folded (or
``quantize_folded``) bundle, as tests/ops/test_trunk_ab.py does; on the
port side the kernel wrappers take their plain versions for CPU tensors.
Bounds: f32 rel <= 1e-5 (max abs diff over max abs), ``flax`` MAE < 1e-4
(the fidelity gate), bf16 min per-patch cosine >= 0.999 (the
reduced-precision gate)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.experiments import trunk_ab as jta
from mermaid_classifier_tpu.models.efficientnet import EfficientNetBackbone
from mermaid_classifier_tpu.ops import fused_mbconv as jfm
from mermaid_classifier_tpu_torch.experiments import trunk_ab as ta
from mermaid_classifier_tpu_torch.models import efficientnet as teff
from mermaid_classifier_tpu_torch.ops import fused_mbconv as tfm
from tests.ops.test_trunk_ab import TINY
from tests.test_torch_efficientnet import (
    jax_variables_numpy,
    perturbed,
    port_config,
)
from tests.test_torch_fused_mbconv import CONFIG as CONFIG64

SCHEDULES = [
    "flax", "folded", "folded+dwp5", "folded+dwp3+dwp5", "folded+taps5",
    "folded+im2col", "folded+w8", "folded+fused", "folded+fused+dwp3",
    "folded+fused+w8", "folded+split8",
]
CONFIGS = {"tiny": TINY, "64px": CONFIG64}


@pytest.fixture(scope="module")
def variables():
    return {name: perturbed(jax_variables_numpy(cfg), seed=5)
            for name, cfg in CONFIGS.items()}


def _jax_features(schedule, config, variables, chunks):
    """The JAX harness's forward for ``schedule`` over a list of chunks."""
    base, split = ta.parse_split(schedule)
    x = jnp.asarray(np.concatenate(chunks))
    if base == "flax":
        fwd, weights = jta.build_forward(
            "flax", EfficientNetBackbone(config=config),
            jax.tree.map(jnp.asarray, variables), config)
        return np.asarray(fwd(weights, x))
    kwargs, w8 = ta._folded_options(base)
    bundle = jfm.fold_backbone(variables, config)
    if w8:
        bundle = jfm.quantize_folded(bundle)
    if split is not None:
        mids = [jfm.apply_folded_prefix(bundle, config, jnp.asarray(c), split)
                for c in chunks]
        return np.asarray(jfm.apply_folded_suffix(
            bundle, config, jnp.concatenate(mids), split))
    if "dw_pallas_kernels" in kwargs or "fused" in kwargs:
        return np.asarray(jfm.apply_folded(bundle, config, x, interpret=True,
                                           **kwargs))
    fwd, weights = jta.build_forward(base, None, variables, config)
    return np.asarray(fwd(weights, x))


def _port_features(schedule, config, variables, chunks):
    base, split = ta.parse_split(schedule)
    cfg = port_config(config)
    fwd, weights = ta.build_forward(base, teff.EfficientNetBackbone(cfg),
                                    variables, cfg, device="cpu")
    tchunks = [torch.from_numpy(c) for c in chunks]
    with torch.inference_mode():
        if split is not None:
            return ta.split_forward(weights, cfg, tchunks, split).numpy()
        return fwd(weights, torch.cat(tchunks)).numpy()


def _min_cosine(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    num = np.sum(a * b, axis=1)
    return float(np.min(num / (np.linalg.norm(a, axis=1)
                               * np.linalg.norm(b, axis=1))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_matches_jax(schedule, name, dtype, variables):
    config = replace(CONFIGS[name], compute_dtype=dtype)
    ps = config.patch_size
    rng = np.random.default_rng(11)
    chunks = [rng.standard_normal((2, ps, ps, 3)).astype(np.float32)
              for _ in range(2)]
    want = _jax_features(schedule, config, variables[name], chunks)
    got = _port_features(schedule, config, variables[name], chunks)
    assert got.shape == want.shape == (4, config.feature_dim)
    assert np.isfinite(got).all()
    if dtype == "bfloat16":
        assert _min_cosine(got, want) >= 0.999
    elif schedule == "flax":
        assert float(np.mean(np.abs(got - want))) < 1e-4
    else:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= 1e-5, rel


@pytest.mark.parametrize("schedule,dw_calls,fused_calls", [
    ("folded", 0, 0), ("folded+dwp5", 7, 0), ("folded+dwp3", 5, 0),
    ("folded+dwp3+dwp5", 12, 0), ("folded+dwp5+dwp3", 12, 0),
    ("folded+taps5", 0, 0), ("folded+fused", 0, 11),
    ("folded+fused+dwp3", 1, 11), ("folded+fused+w8", 0, 11),
])
def test_routing_counts_on_b0_topology(schedule, dw_calls, fused_calls,
                                       variables, monkeypatch):
    """Which blocks reach the depthwise and fused wrappers (JAX's routing:
    fused first, then the depthwise kernel at stride 1, then taps, then
    cuDNN), per chunk of the 64-px full-B0 trunk: the counts chip_smoke.py
    asserts as launches at 224 px."""
    calls = {"dw": 0, "fused": 0}
    real_dw, real_fused = tfm.depthwise_conv, tfm.fused_mbconv

    def dw(*args, **kwargs):
        calls["dw"] += 1
        return real_dw(*args, **kwargs)

    def fused(*args, **kwargs):
        calls["fused"] += 1
        return real_fused(*args, **kwargs)

    monkeypatch.setattr(tfm, "depthwise_conv", dw)
    monkeypatch.setattr(tfm, "fused_mbconv", fused)
    cfg = port_config(CONFIG64)
    fwd, weights = ta.build_forward(schedule, None, variables["64px"], cfg,
                                    device="cpu")
    fwd(weights, torch.zeros((1, 64, 64, 3)))
    assert (calls["dw"], calls["fused"]) == (dw_calls, fused_calls)


@pytest.mark.parametrize("name", ["64px", "b0_224"])
def test_quantize_folded_bitwise_equal_to_jax(name, variables):
    config = CONFIG64 if name == "64px" else teff.EfficientNetConfig()
    raw = (variables["64px"] if name == "64px"
           else jax_variables_numpy(config))
    folded = jfm.fold_backbone(raw, config)
    want, got = jfm.quantize_folded(folded), tfm.quantize_folded(folded)

    def entries(q):
        out = [q["stem"], q["head"], q["proj"]]
        for blk in q["blocks"]:
            out += [blk[k] for k in ("expand", "depthwise", "se_reduce",
                                     "se_expand", "project") if k in blk]
        return out

    assert len(entries(got)) == len(entries(want))
    for g, w in zip(entries(got), entries(want)):
        assert len(g) == len(w) == 3
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    dev = tfm.to_device(got, "cpu")
    w_q, scale, b = dev["blocks"][1]["expand"]
    assert (w_q.dtype, scale.dtype, b.dtype) == (
        torch.int8, torch.float32, torch.float32)


def test_gate_cosine_self_is_one_and_w8_passes(variables):
    cfg = port_config(TINY)
    f_ref, w_ref = ta.build_forward("folded", None, variables["tiny"], cfg,
                                    device="cpu")
    assert ta.gate_cosine(f_ref, w_ref, f_ref, w_ref, cfg, device="cpu",
                          chunk=4) >= 1 - 1e-6
    f_w8, w_w8 = ta.build_forward("folded+w8", None, variables["tiny"], cfg,
                                  device="cpu")
    cos = ta.gate_cosine(f_ref, w_ref, f_w8, w_w8, cfg, device="cpu", chunk=4)
    assert cos >= 0.999, cos


@pytest.mark.parametrize("split", [0, 3, 8, 16])
def test_split_equals_unsplit(split, variables):
    cfg = port_config(CONFIG64)
    fwd, weights = ta.build_forward("folded", None, variables["64px"], cfg,
                                    device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        want = fwd(weights, x)
        got = ta.split_forward(weights, cfg, [x[:2], x[2:]], split)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("schedule", [
    "folded+nope", "quantum", "folded+dwp7", "folded+split", "folded+w8+split2",
    "flax+split2",
])
def test_unknown_schedules_raise(schedule, variables):
    cfg = port_config(TINY)
    with pytest.raises(ValueError):
        base, _ = ta.parse_split(schedule)
        ta.build_forward(base, teff.EfficientNetBackbone(cfg),
                         variables["tiny"], cfg, device="cpu")


def test_main_fails_loudly(monkeypatch):
    with pytest.raises(ValueError, match="unknown schedule mod"):
        ta.main(["--device", "cpu", "--schedules", "folded", "folded+nope"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ta.main(["--device", "cuda", "--schedules", "folded"])


@pytest.mark.parametrize("split", [None, 1])
def test_time_trunk_positive_rate_on_cpu(split, variables):
    cfg = port_config(TINY)
    fwd, weights = ta.build_forward("folded", None, variables["tiny"], cfg,
                                    device="cpu")
    rate, runs = ta.time_trunk(fwd, weights, cfg, device="cpu", points=8,
                               chunk=4, iters=1, repeats=1, split=split)
    assert rate > 0 and len(runs) == 1


def test_main_runs_on_cpu(capsys):
    """The CLI end to end at B0 224 (2 points, 1 iteration)."""
    assert ta.main(["--device", "cpu", "--schedules", "folded",
                    "folded+taps5", "folded+split8", "--points", "2",
                    "--chunk", "2", "--iters", "1", "--repeats", "1",
                    "--numerics-gate"]) == 0
    out = capsys.readouterr().out
    assert "folded+taps5" in out and "[PASS]" in out and "best:" in out
