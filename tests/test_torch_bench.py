"""The port's bench (``mermaid_classifier_tpu_torch.bench``) on the CPU: its
roofline model against the JAX bench's (root ``bench.py``) and an
independent per-layer FLOP count, its serve and annotate heads against the
JAX head, its CPU cross-check against the JAX f32 flax extractor, the gate
and failure exits, the refusal to run ``cuda`` without a card, ``main`` end
to end at the smallest sizes, and the quality leg's two output shapes."""

import json
import sys
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from mermaid_classifier_tpu.inference import head as jhead
from mermaid_classifier_tpu.models import extractor as jext
from mermaid_classifier_tpu.models.efficientnet import EfficientNetConfig as JConfig
from mermaid_classifier_tpu_torch import bench
from mermaid_classifier_tpu_torch.inference.head import head_apply, make_head_fn
from mermaid_classifier_tpu_torch.models import efficientnet as teff
from tests.models.test_efficientnet import TINY
from tests.test_torch_efficientnet import jax_variables_numpy, perturbed, port_config

# The smallest sizes main runs at: every leg but quality and the recipe.
SMALL = ["--device", "cpu", "--points", "2", "--chunk", "2", "--iters", "1",
         "--warmup", "1", "--repeats", "1", "--probe-reps", "1", "--image-size", "256",
         "--bucket-images", "1", "--bucket-points", "4", "--train-rows", "300",
         "--train-epochs", "1", "--serve-batch", "64", "--no-quality",
         "--no-full-recipe"]


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("dtype,mb", [("bfloat16", 13.48), ("float32", 26.95)])
def test_roofline_matches_the_jax_bench(dtype, mb):
    want = jbench.modeled_roofline(JConfig(compute_dtype=dtype), dtype, 14150.0,
                                   hbm_gbps=3350.0, traffic_factor=2.0)
    got = bench.modeled_roofline(teff.EfficientNetConfig(compute_dtype=dtype), dtype,
                                 "fused", 14150.0, 3350.0)
    assert got["materialized_mb_per_patch"] == want["materialized_mb_per_patch"] == mb
    assert got["traffic_factor"] == want["traffic_factor"] == bench.TRAFFIC_FACTOR
    assert got["roofline_fraction"] == want["roofline_fraction"]
    assert got["bound_by"] == "bytes"
    assert got["flop_bound_us_per_patch"] < got["schedule_hbm_bound_us_per_patch"]
    cpu = bench.modeled_roofline(teff.EfficientNetConfig(), dtype, "fused", None, 3350.0)
    assert cpu["achieved_us_per_patch"] is None
    assert cpu["roofline_fraction"] is None and cpu["schedule_roofline_fraction"] is None


@pytest.mark.parametrize("backbone", ["fused", "folded", "module"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["b0", "b3"])
def test_schedule_bytes_count_what_the_fused_blocks_write(name, dtype, backbone):
    """``schedule_bytes`` against a count over the fused kernel's own
    parameters: each block ``apply_folded`` hands to the fused kernel (only
    under ``fused``; at B0 the 11 launches per chunk) writes its f32
    depthwise scratch and its output, no expand output; every other block
    writes as the unfused model."""
    from mermaid_classifier_tpu_torch.ops.fused_mbconv import fold_backbone, fusable

    config = replace(teff.variant_config(name), compute_dtype=dtype)
    act = 2 if dtype == "bfloat16" else 4
    want = bench.trunk_cost(config)[0] * act
    folded = fold_backbone(teff.init_backbone_params(0, config), config)
    fused_blocks = [b["meta"] for b in folded["blocks"] if fusable(b["meta"])]
    if backbone == "fused":
        for m in fused_blocks:
            mid_map = m.h * m.w * m.mid_channels  # stride 1: expand map == depthwise map
            want -= mid_map * act  # the expand output stays on chip
            want += mid_map * (4 - act)  # the depthwise output is written in f32
    assert bench.schedule_bytes(config, dtype, backbone) == want
    if name == "b0":
        assert len(fused_blocks) == 11
    roofline = bench.modeled_roofline(config, dtype, backbone, 14150.0, 3350.0)
    assert roofline["schedule_materialized_mb_per_patch"] == round(want / 1e6, 2)


@pytest.mark.parametrize("name", ["b0", "b3", "tiny"])
def test_flops_equal_a_per_layer_count(name):
    """``trunk_cost``'s FLOPs equal two per multiply-add of every Conv2d the
    nn.Module forward runs, counted by forward hooks, plus the feature
    projection's (the forward applies it with ``F.linear``, past its hook)."""
    config = (port_config(TINY) if name == "tiny" else teff.variant_config(name))
    module = teff.EfficientNetBackbone(config).eval()
    counted = [2 * layer.in_features * layer.out_features
               for layer in module.modules() if isinstance(layer, torch.nn.Linear)]
    assert len(counted) == (config.feature_dim != config.head_channels)

    def hook(layer, inputs, out):
        per_output = layer.in_channels // layer.groups * layer.kernel_size[0] \
            * layer.kernel_size[1]
        counted.append(2 * out[0].numel() * per_output)

    for layer in module.modules():
        if isinstance(layer, torch.nn.Conv2d):
            layer.register_forward_hook(hook)
    ps = config.patch_size
    with torch.no_grad():
        module(torch.zeros(1, ps, ps, 3))
    assert bench.trunk_cost(config)[1] == sum(counted)


@pytest.mark.parametrize("which", ["serve", "annotate"])
def test_heads_match_jax_head_apply(which):
    params, rng = bench.serve_head(4096) if which == "serve" else bench.annotate_head(4096)
    x = rng.standard_normal((64, 4096)).astype(np.float32)
    jparams = jhead.HeadParams(params.weights, params.biases, params.a, params.b)
    want = np.asarray(jhead.head_apply(jparams.as_pytree(), jnp.asarray(x)))
    got = head_apply(params.as_tensors("cpu"), torch.from_numpy(x)).numpy()
    assert got.shape == (64, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_annotate_cpu_reference_matches_jax_flax():
    """The annotate leg's CPU cross-check (f32 ``module`` extractor + head)
    against the JAX f32 flax extractor on the same image, points and
    carried weights; both heads on the same features."""
    weights = perturbed(jax_variables_numpy(TINY), seed=11)
    rng = np.random.default_rng(7)
    image = rng.integers(0, 256, size=(70, 90, 3), dtype=np.uint8)
    rowcols = np.stack([rng.integers(0, 70, 25), rng.integers(0, 90, 25)], 1)
    rowcols = rowcols.astype(np.int32)
    params, _ = bench.annotate_head(TINY.feature_dim)
    feats, proba = bench.cpu_reference(weights, port_config(TINY), image, rowcols, params)
    jax_extractor = jext.FeatureExtractor(
        weights, replace(TINY, compute_dtype="float32"), backbone_batch=25,
        backbone_impl="flax")
    want = jax_extractor.extract_features(image, rowcols)
    assert feats.shape == want.shape == (25, TINY.feature_dim)
    assert float(np.mean(np.abs(feats - want))) < 1e-4
    jparams = jhead.HeadParams(params.weights, params.biases, params.a, params.b)
    np.testing.assert_allclose(make_head_fn(params, "cpu")(want),
                               jhead.make_head_fn(jparams)(want), rtol=0, atol=1e-6)
    assert proba.shape == (25, 80)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-6)


def test_gate_below_threshold_exits_1(monkeypatch, tmp_path):
    """A trunk that returns noise fails the gate: exit 1, nothing timed,
    no payload."""

    class Noise:
        def features_for_patches_device(self, patches):
            return torch.randn(patches.shape[0], 4096)

    def no_loop(*a, **kw):
        raise AssertionError("the device loop ran after a failed gate")

    monkeypatch.setattr(bench, "make_extractor", lambda *a, **kw: Noise())
    monkeypatch.setattr(bench, "run_device_loop", no_loop)
    out = tmp_path / "payload.json"
    assert bench.main([*SMALL, "--output-json", str(out)]) == 1
    assert not out.exists()


def _failing_serve(*a, **kw):
    raise RuntimeError("serve broke")


@pytest.mark.parametrize("broken", ["serve_raises", "quality_exits_3", "recipe_times_out"])
def test_failed_leg_is_reported_and_exits_1(monkeypatch, tmp_path, capsys, broken):
    args = [*SMALL, "--no-bucket", "--no-annotate", "--no-train", "--output-json",
            str(tmp_path / "payload.json")]
    if broken == "serve_raises":
        monkeypatch.setattr(bench, "run_serve", _failing_serve)
        want = ("serve", "RuntimeError: serve broke")
    elif broken == "quality_exits_3":
        monkeypatch.setattr(bench, "_module_cmd", lambda *a: [
            sys.executable, "-c", "import sys; sys.exit(3)"])
        args = [a for a in args if a != "--no-quality"] + ["--quality-seeds", "2"]
        want = ("quality", "RuntimeError: quality_parity_bench")
    elif broken == "recipe_times_out":
        monkeypatch.setattr(bench, "_module_cmd", lambda *a: [
            sys.executable, "-c", "import time; time.sleep(60)"])
        args = [a for a in args if a != "--no-full-recipe"] + ["--recipe-timeout", "1"]
        want = ("full_recipe", "TimeoutExpired")
    assert bench.main(args) == 1
    payload = json.loads((tmp_path / "payload.json").read_text())
    head = _last_json(capsys.readouterr().out)
    for record in (payload, head):
        (failed,) = record["failed_legs"]
        assert failed["leg"] == want[0] and failed["error"].startswith(want[1])
    assert payload["value"] > 0 and head["metric"] == "patch_features_per_sec"


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    """``--device cuda`` where torch sees no card raises before any leg, and
    nothing runs on the CPU in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(bench, "make_extractor", lambda *a, **kw: ran.append(a))
    monkeypatch.setattr(bench, "numerics_gate", lambda *a, **kw: ran.append(a))
    out = tmp_path / "payload.json"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.main([*SMALL[2:], "--device", "cuda", "--output-json", str(out)])
    assert ran == [] and not out.exists()


def test_main_end_to_end_on_cpu(tmp_path, capsys):
    out = tmp_path / "payload.json"
    assert bench.main([*SMALL, "--output-json", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    head, payload = json.loads(lines[-1]), json.loads(lines[-2])
    assert payload == json.loads(out.read_text())
    assert head["device"]["type"] == payload["device"]["type"] == "cpu"
    assert head["roofline_fraction"] is None and payload["failed_legs"] == []
    assert head["schedule_roofline_fraction"] is None
    assert (head["dtype"], head["backbone"]) == ("bfloat16", "fused")
    assert head["numerics_gate_cosine"] >= 0.999
    for key in ("value", "bucket_patches_per_sec", "annotate_latency_ms",
                "train_samples_per_sec", "serve_rows_per_sec"):
        assert head[key] > 0, key
    assert payload["roofline"]["bound_by"] == "bytes"
    annotate = payload["annotate"]
    assert annotate["cpu_parity_min_cosine"] >= 0.999
    assert 0 <= annotate["cpu_parity_max_logit_diff"] < annotate["cpu_parity_max_abs_logit"]
    assert 0 <= annotate["softmax_one_hot_rows"] <= annotate["points"]
    budget = payload["stage_budget"]
    assert budget["points_per_image"] == 4
    assert budget["decode_ms_smooth_images"] > 0
    assert 0 < budget["jpeg_kb_smooth_images"] < budget["jpeg_kb"]
    assert payload["bucket_images"] == 1 and len(payload["bucket_runs_pps"]) == 1
    # The plain versions run on the CPU: no kernel launch is counted.
    assert payload["device_loop"]["crop_launches_per_step"] == 0
    assert payload["full_recipe_committed_record"]["source"].startswith(
        "docs/torch_runs/full_recipe")


@pytest.mark.parametrize("have_sklearn", [True, False], ids=["sklearn", "repo_only"])
def test_quality_leg_parses_both_outputs(have_sklearn):
    out = bench.run_quality("cpu", 2, extra=("--ci-scale", "--allow-unpinned-torch"),
                            have_sklearn=have_sklearn)
    quality = out["quality"]
    assert quality["seeds"] == 2 and len(quality["per_seed"]) == 2
    if have_sklearn:
        assert quality["sklearn"] == "installed"
        assert abs(quality["balanced_accuracy_delta"]) < 0.1
        low, high = quality["balanced_accuracy_delta_ci95"]
        assert low <= quality["balanced_accuracy_delta"] <= high
        assert set(bench.QUALITY_KEYS) <= set(out["quality_reference_init"])
    else:
        assert quality["sklearn"] == "not installed" and "quality_reference_init" not in out
        for key in ("accuracy_delta", "balanced_accuracy_delta", "log_loss_delta",
                    "balanced_accuracy_delta_ci95"):
            assert quality[key] is None, key
        assert [r["seed"] for r in quality["per_seed"]] == [0, 1]
        assert quality["repo_accuracy_mean"] == round(
            float(np.mean([r["repo_accuracy"] for r in quality["per_seed"]])), 4)
        assert 0.8 < quality["repo_accuracy_mean"] <= 1.0


def test_recipe_leg_carries_the_drive_record():
    """The recipe leg runs the C2 drive as a subprocess (here tiny, on the
    CPU) and carries its record's keys."""
    recipe = bench.run_full_recipe(
        "cpu", pool_rows=3000, resident_dtype="int8", timeout=600,
        extra=("--allow-unpinned-torch", "--classes", "10", "--dim", "48",
               "--points-per-image", "50", "--sources", "3", "--epochs", "4",
               "--patience", "2"))
    assert set(recipe) == set(bench.RECIPE_KEYS)
    assert recipe["device"]["type"] == "cpu"
    assert recipe["export_parity_max_abs_diff"] <= 1e-6
    assert recipe["subsample_realized"] > 0 and 0 < recipe["accuracy"] <= 1
