"""The run's exits and the printed line's keys."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run as bench_run
from benchmark.tests.conftest import tiny_cell

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_means_no_result_and_a_nonzero_exit():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "b2_bulk_200pt",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_the_harness_fails(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from benchmark import run\nfrom benchmark.manifest import Manifest\n"
            "print(run.run(Manifest().cell('b2_bulk_200pt'), 1, 0.1, False, 'cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "mermaid_classifier_tpu_torch" in out.stderr


@pytest.mark.parametrize("name", ["b2_bulk_200pt", "b0_head_train_c2"])
@pytest.mark.parametrize("trace", [False, True])
def test_the_line_carries_exactly_the_contracts_keys(name, trace):
    result = bench_run.run(tiny_cell(name), 2**31 + 17, 0.3, trace, "cpu")
    line = bench_run.result_line(result, "cpu (test)", 1)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert {"platform", "kind", "count"} <= set(line["device"])
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        e2e = {"setup_s", "bulk_patches_per_s" if "bulk" in name else "train_samples_per_s"}
        assert set(line["metrics"]) == e2e
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    json.loads(json.dumps(line, allow_nan=False))
