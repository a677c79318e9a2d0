"""The port's committed run records (``docs/torch_runs/``) keep their
contract: each parses, names the card it ran on (``device.name`` and
``device.power_limit`` as nvidia-smi gives them), carries the keys its
drive's or the bench's comparisons rely on, and is indexed in the
directory's README.
The JAX package's records (``docs/runs/``) are tests/test_run_records.py's."""

import json
import math
from pathlib import Path

RUNS_DIR = Path(__file__).resolve().parents[1] / "docs" / "torch_runs"

RECIPE_KEYS = {"train_full_recipe_minutes", "stage_seconds", "subsample_realized",
               "splits", "train_stage_breakdown", "accuracy", "balanced_accuracy",
               "log_loss", "export_parity_max_abs_diff", "device", "recipe"}
BUCKET_KEYS = {"images_total", "points_total", "stage_seconds", "kill_resume",
               "kernel_launches", "device", "ok"}
BENCH_KEYS = {"metric", "value", "device_runs_pps", "numerics_gate_cosine", "roofline",
              "bucket_patches_per_sec", "annotate_latency_ms", "train_samples_per_sec",
              "serve_rows_per_sec", "quality", "full_recipe", "device"}


def _records(prefix: str = "") -> dict[str, dict]:
    return {p.name: json.loads(p.read_text())
            for p in sorted(RUNS_DIR.glob(f"{prefix}*.json"))}


def test_both_drives_have_a_record():
    assert _records("full_recipe_"), "no committed C2 recipe record of the port"
    assert _records("feature_bucket_"), "no committed bulk-build record of the port"


def test_every_record_is_indexed():
    index = (RUNS_DIR / "README.md").read_text()
    unindexed = [name for name in _records() if name not in index]
    assert not unindexed, f"docs/torch_runs/README.md does not mention {unindexed}"


def test_every_record_names_its_card():
    for name, record in _records().items():
        device = record.get("device") or {}
        assert device.get("type") == "cuda", name
        for key in ("name", "power_limit"):
            assert isinstance(device.get(key), str) and device[key], (name, key)


def test_recipe_records_pass_the_gate():
    for name, record in _records("full_recipe_").items():
        missing = sorted(RECIPE_KEYS - record.keys())
        assert not missing, f"{name} lacks {missing}"
        assert 0 < record["train_full_recipe_minutes"] < 24 * 60
        for key in ("accuracy", "balanced_accuracy"):
            assert 0.0 < record[key] <= 1.0, (name, key)
        assert math.isfinite(record["log_loss"]) and record["log_loss"] > 0
        assert record["export_parity_max_abs_diff"] <= 1e-6, name
        splits = record["splits"]
        assert sum(splits.values()) == record["subsample_realized"], name
        assert record["train_stage_breakdown"]["rows"] == record["subsample_realized"]


def test_bucket_records_prove_the_resume():
    for name, record in _records("feature_bucket_").items():
        missing = sorted(BUCKET_KEYS - record.keys())
        assert not missing, f"{name} lacks {missing}"
        kr = record["kill_resume"]
        assert record["ok"] and kr["killed_mid_run"], name
        assert 0 < kr["done_before_resume"] < record["images_total"], name
        assert kr["identical_to_uninterrupted"] and kr["featsB_complete"], name
        assert (kr["rewrites_after_resume"], kr["failures_logged"],
                kr["stray_part_files"]) == (0, 0, 0), name
        assert kr["featsB_feature_files"] == record["images_total"], name
        launches = record["kernel_launches"]
        assert set(launches) == {"uninterrupted", "killed", "resume"}, name
        for process, got in launches.items():
            assert got["crop"] == got["images_written"] > 0, (name, process)


def test_bench_records_hold_their_contract():
    """Each bench record (``python -m mermaid_classifier_tpu_torch.bench``
    at its defaults) has every leg's key and no failed leg, passed its gate
    at bf16 ``fused``, launched 1 crop and 11 fused blocks per 128-patch
    chunk per device-loop step, carries both roofline bounds, and ran the
    C2 recipe at its full subsample through the export gate."""
    records = _records("bench_")
    assert records, "no committed bench record of the port"
    for name, record in records.items():
        missing = sorted(BENCH_KEYS - record.keys())
        assert not missing, f"{name} lacks {missing}"
        assert record["failed_legs"] == [], name
        assert record["metric"] == "patch_features_per_sec" and record["value"] > 0
        assert (record["dtype"], record["backbone"]) == ("bfloat16", "fused"), name
        assert record["numerics_gate_cosine"] >= 0.999, name
        loop = record["device_loop"]
        assert (loop["crop_launches_per_step"], loop["fused_launches_per_step"]) == (
            1, 11 * loop["points"] // loop["chunk"]), name
        roofline = record["roofline"]
        assert roofline["bound_by"] in ("bytes", "operations"), name
        assert roofline["schedule"] == record["backbone"], name
        for key in ("modeled_hbm_bound_us_per_patch", "flop_bound_us_per_patch",
                    "achieved_us_per_patch", "roofline_fraction",
                    "schedule_hbm_bound_us_per_patch", "schedule_roofline_fraction"):
            assert roofline[key] > 0, (name, key)
        annotate = record["annotate"]
        assert annotate["cpu_parity_min_cosine"] >= 0.999, name
        assert math.isfinite(annotate["cpu_parity_max_logit_diff"]), name
        recipe = record["full_recipe"]
        assert recipe["subsample_realized"] == 449_099, name
        assert recipe["export_parity_max_abs_diff"] <= 1e-6, name
