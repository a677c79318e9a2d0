"""The port's same-corpus sklearn baseline against the JAX package's, on the
host at the JAX test's arguments (tests/test_sklearn_reference_baseline.py:
3,000 pool rows, 10 classes, dim 48, 50 points per image, 3 sources, 6
epochs, patience 2, stream chunk 1,500).

- Both scripts run end to end, each synthesizing its corpus with its own
  package's drive: the ``sklearn`` and ``sklearn_uncalibrated`` blocks, the
  early-stop block and the split sizes are equal within 1e-12.
- On the port's corpus, the port's ``same_corpus_dataset`` gives JAX's
  ``TrainingDataset`` rows: the realized subsample and every split's
  (feature file, row, col, label) items, in order.
- The port's script imports no sklearn until it trains (it is walked by
  tests/test_torch_no_jax.py), and its record carries the C2 record's row
  it was given.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from mermaid_classifier_tpu.common import taxonomy as jtax
from mermaid_classifier_tpu.config import settings as jset
from mermaid_classifier_tpu.config.options import DatasetOptions as JOptions
from mermaid_classifier_tpu.config.options import SubsampleOptions as JSub
from mermaid_classifier_tpu.data.dataset import TrainingDataset as JDataset
from mermaid_classifier_tpu.data.store import LocalFSObjectStore as JStore
from mermaid_classifier_tpu_torch.common import taxonomy as ttax
from mermaid_classifier_tpu_torch.config import settings as tset
from mermaid_classifier_tpu_torch.scripts import sklearn_reference_baseline as baseline

REPO = Path(__file__).resolve().parents[1]
POOL_ROWS = 3000
ARGS = ["--pool-rows", str(POOL_ROWS), "--classes", "10", "--dim", "48",
        "--points-per-image", "50", "--sources", "3", "--epochs", "6",
        "--patience", "2", "--stream-chunk", "1500"]
C2_ROW = {"accuracy": 0.81, "balanced_accuracy": 0.79, "log_loss": 0.9,
          "f1_macro": 0.78, "mcc": 0.8}


def _run(cmd, workdir: Path, repo_record: Path) -> dict:
    out = workdir.parent / f"{workdir.name}.json"
    proc = subprocess.run(
        [*cmd, *ARGS, "--workdir", str(workdir), "--repo-record", str(repo_record),
         "--output-json", str(out)],
        cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, (
        f"--- stdout ---\n{proc.stdout[-4000:]}\n--- stderr ---\n{proc.stderr[-4000:]}")
    assert "falling back to" not in proc.stdout + proc.stderr
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def baselines(tmp_path_factory):
    """((JAX workdir, record), (port workdir, record))."""
    base = tmp_path_factory.mktemp("sklearn_baseline")
    record = base / "c2_record.json"
    record.write_text(json.dumps(C2_ROW))
    jax = _run([sys.executable, str(REPO / "scripts" / "sklearn_reference_baseline.py")],
               base / "jax", record)
    port = _run([sys.executable, "-m",
                 "mermaid_classifier_tpu_torch.scripts.sklearn_reference_baseline"],
                base / "port", record)
    return (base / "jax", jax), (base / "port", port)


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            _close(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= 1e-12, (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_sklearn_blocks_equal_jax(baselines):
    (_, jax), (_, port) = baselines
    for block in ("sklearn", "sklearn_uncalibrated"):
        _close(port[block], jax[block], block)
    drop_seconds = [{k: v for k, v in e.items() if k != "seconds"}
                    for e in jax["early_stop"]["epoch_history"]]
    assert [{k: v for k, v in e.items() if k != "seconds"}
            for e in port["early_stop"]["epoch_history"]] == drop_seconds
    for key in ("stop_reason", "final_epoch", "best_val_epoch", "best_val_loss"):
        assert port["early_stop"][key] == jax["early_stop"][key]
    assert {k: v for k, v in port["corpus"].items() if k != "subsample_realized"} == \
        jax["corpus"]
    assert port["corpus"]["subsample_realized"] == 2374
    # Calibration calibrates at this size, as the JAX test requires.
    assert port["sklearn"]["log_loss"] < port["sklearn_uncalibrated"]["log_loss"]


def test_the_record_diffs_the_c2_row(baselines):
    _, (_, port) = baselines
    assert port["repo_c2_record"] == C2_ROW
    assert port["delta_repo_minus_sklearn"] == {
        k: round(C2_ROW[k] - port["sklearn"][k], 4) for k in C2_ROW}


def test_splits_equal_jax_row_for_row(baselines, tmp_path, monkeypatch):
    _, (port_dir, _) = baselines
    manifest = port_dir / "manifest.parquet"
    monkeypatch.setenv(ttax.TAXONOMY_FIXTURE_ENV, str(port_dir / "taxonomy"))
    for mod in (jtax, ttax):
        mod.get_benthic_attribute_library.cache_clear()
        mod.get_growth_form_library.cache_clear()
        mod.get_coralnet_mapping.cache_clear()
    common = dict(object_store_root=str(port_dir / "store"),
                  coralnet_train_data_bucket="features",
                  mermaid_train_data_bucket="features",
                  taxonomy_fixture_dir=str(port_dir / "taxonomy"))
    try:
        with jset.override_settings(feature_cache_dir=str(tmp_path / "jax"), **common), \
                tset.override_settings(feature_cache_dir=str(tmp_path / "port"), **common):
            jds = JDataset(JOptions(
                include_mermaid=False, coralnet_manifest_uri=str(manifest),
                ref_val_ratios=(0.1, 0.1),
                subsample=JSub(strategy="balanced", total_annotations=POOL_ROWS,
                               min_per_class=200)), store=JStore(port_dir / "store"))
            tds = baseline.same_corpus_dataset(manifest, POOL_ROWS)
    finally:
        for mod in (jtax, ttax):
            mod.get_benthic_attribute_library.cache_clear()
            mod.get_growth_form_library.cache_clear()
            mod.get_coralnet_mapping.cache_clear()
    assert tds._subsample_realized_total == jds._subsample_realized_total == 2374
    for split in ("train", "ref", "val"):
        want = [(os.path.relpath(p, tmp_path / "jax"), r, c, label)
                for p, r, c, label in getattr(jds.labels, split).annotation_items()]
        got = [(os.path.relpath(p, tmp_path / "port"), r, c, label)
               for p, r, c, label in getattr(tds.labels, split).annotation_items()]
        assert got == want, split
        assert len(got) == {"train": 1900, "ref": 237, "val": 237}[split]
    jds.cleanup()
    tds.cleanup()
