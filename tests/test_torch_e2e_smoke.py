"""The port's one-command E2E drive (``scripts/e2e_smoke.py``) on the CPU.

- ``--device cpu`` with its default tiny backbone passes from a fresh
  checkout: synthetic images -> manifest -> two extraction workers ->
  classifier_train over configs/example/ -> reload -> bulk predict ->
  report, printing its ``stage-done`` markers, ``stage budget:`` and
  ``PASS``, writing ``report.html`` and registering
  ``mermaid-mlp-example/v1``. The deadline is the JAX E2E test's
  machine-scaled one (tests/common/e2e_harness.py).
- With ``--production-backbone`` its sizes default to 8 images x 64
  points per source, the tiny backbone's to 4 x 16.
- Its synthesis equals the JAX drive's on the same seed: the same image
  and annotation objects byte for byte, and the same ETL parquet rows.
- No fallback: at its default ``--device cuda`` without a card the workers
  fail, and the drive exits non-zero with their log tails.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mermaid_classifier_tpu_torch.common.relational import read_parquet_columns
from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
from mermaid_classifier_tpu_torch.scripts import e2e_smoke
from tests.common.e2e_harness import run_e2e

REPO = Path(__file__).resolve().parents[1]
DRIVE = ["-m", "mermaid_classifier_tpu_torch.scripts.e2e_smoke"]


def test_e2e_on_the_cpu_passes_and_registers(tmp_path):
    proc = run_e2e([sys.executable, *DRIVE, "--workdir", str(tmp_path),
                    "--images-per-source", "3", "--device", "cpu",
                    "--allow-unpinned-torch"], cwd=REPO)
    assert proc.returncode == 0, (
        f"--- stdout ---\n{proc.stdout[-4000:]}\n--- stderr ---\n{proc.stderr[-4000:]}")
    for name in ("synthesize", "manifest", "extract", "train", "reload",
                 "bulk_predict", "report"):
        assert f"[e2e] stage-done {name} in " in proc.stdout
    assert "[e2e] launched 2 extraction workers" in proc.stdout
    assert "stage budget: synthesize=" in proc.stdout
    assert "[e2e] PASS in " in proc.stdout
    assert (tmp_path / "report.html").stat().st_size > 1000
    registry = tmp_path / "tracking" / "_models" / "mermaid-mlp-example"
    assert (registry / "v1" / "model.npz").is_file()
    assert (registry / "v1" / "model.json").is_file()
    assert sorted(p.name for p in (tmp_path / "logs").glob("e2e-smoke-*.log")) == [
        "e2e-smoke-w0-0.log", "e2e-smoke-w1-1.log"]


@pytest.mark.parametrize("argv, sizes", [
    ([], (4, 16)),
    (["--production-backbone"], (8, 64)),
    (["--production-backbone", "--images-per-source", "4", "--points-per-image", "16"],
     (4, 16)),
    (["--images-per-source", "2"], (2, 16)),
], ids=["tiny", "production", "production-explicit", "tiny-explicit"])
def test_default_sizes(argv, sizes):
    # The production backbone's head needs more than the tiny drive's 128
    # points to learn anything and pass the export gate.
    args = e2e_smoke.parse_args(argv)
    assert (args.images_per_source, args.points_per_image) == sizes


@pytest.mark.parametrize("production", [False, True], ids=["tiny", "production"])
def test_synthesis_equals_jax(tmp_path, production):
    spec = importlib.util.spec_from_file_location(
        "jax_e2e_smoke", REPO / "scripts" / "e2e_smoke.py")
    jax_drive = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_drive)
    image_size = (224 if production else 64) * 2
    stores = {}
    for name, drive in (("port", e2e_smoke), ("jax", jax_drive)):
        work = tmp_path / name
        work.mkdir()
        store = LocalFSObjectStore(work / "store")
        drive.synthesize_source_data(store, work, ["1", "2"], 2, 4, image_size, 7)
        stores[name] = (work, store)
    (pw, ps), (jw, js) = stores["port"], stores["jax"]
    keys = sorted(ps.list_keys("images"))
    assert keys == sorted(js.list_keys("images")) and len(keys) == 6
    for key in keys:
        assert ps.get_bytes("images", key) == js.get_bytes("images", key)
    for table in ("etl_annotations.parquet", "etl_images.parquet"):
        assert read_parquet_columns(str(pw / table)) == \
            read_parquet_columns(str(jw / table))
    assert e2e_smoke.TINY_BACKBONE == jax_drive.TINY_BACKBONE
    assert e2e_smoke.CLASS_COLORS == jax_drive.CLASS_COLORS


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
def test_e2e_without_a_card_fails_with_the_worker_logs(tmp_path):
    proc = subprocess.run([sys.executable, *DRIVE, "--workdir", str(tmp_path),
                           "--images-per-source", "1"], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert "[e2e] stage-FAILED extract" in proc.stdout
    assert "--- e2e-smoke-w0-0.log ---" in proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stdout
    assert "extraction workers failed" in proc.stderr
    assert "PASS" not in proc.stdout
