"""The port's committed run records (``docs/torch_runs/``) keep their
contract: each parses, names the card it ran on (``device.name`` and
``device.power_limit`` as nvidia-smi gives them), carries the keys its
drive's comparisons rely on, and is indexed in the directory's README.
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
