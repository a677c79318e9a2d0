"""The port's C2 recipe drive (``scripts/full_recipe_drive.py`` of the port)
against the JAX package's, both on the CPU at a tiny size.

Both drives run as their users run them, on the same arguments (3,000 pool
rows, 10 classes, dim 48, 50 points per image, 3 sources, 4 epochs,
patience 2, seed 0): the JAX one with ``--cpu --skip-link-probe``, the
port's with ``--device cpu --allow-unpinned-torch`` (this host's torch is
not the pinned one). Then:

- the two corpora are equal: every feature file's rowcols and features
  exactly, the two ETL parquets as arrow tables (the JAX side's pandas
  schema-metadata block dropped), the taxonomy fixture byte for byte;
- ``subsample_realized`` and the recipe block are equal;
- each side's export parity is <= 1e-6;
- the port's accuracy is within 0.05 of the JAX drive's at this size;
- the record carries the stages, the resident stage budget and ``device``.

And, in process: a non-square ``points_per_image`` (50) writes aligned
rowcols, features and annotation rows (tests/test_full_recipe_projection.py);
at its default ``--device cuda`` without a card the drive fails.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow.parquet as pq
import pytest

from mermaid_classifier_tpu_torch.data.features_io import read_feature_file
from mermaid_classifier_tpu_torch.scripts import full_recipe_drive as drive

REPO = Path(__file__).resolve().parents[1]
TINY_ARGS = ["--pool-rows", "3000", "--classes", "10", "--dim", "48",
             "--points-per-image", "50", "--sources", "3", "--epochs", "4",
             "--patience", "2", "--seed", "0"]


def _run(cmd, workdir: Path) -> dict:
    out = workdir.parent / f"{workdir.name}.json"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([*cmd, *TINY_ARGS, "--workdir", str(workdir),
                           "--output-json", str(out)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, (
        f"--- stdout ---\n{proc.stdout[-4000:]}\n--- stderr ---\n{proc.stderr[-4000:]}")
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    """((JAX workdir, record), (port workdir, record))."""
    base = tmp_path_factory.mktemp("full_recipe")
    jax_dir, port_dir = base / "jax", base / "port"
    jax = _run([sys.executable, str(REPO / "scripts" / "full_recipe_drive.py"),
                "--cpu", "--skip-link-probe"], jax_dir)
    port = _run([sys.executable, "-m", "mermaid_classifier_tpu_torch.scripts.full_recipe_drive",
                 "--device", "cpu", "--allow-unpinned-torch"], port_dir)
    return (jax_dir, jax), (port_dir, port)


def test_the_corpora_are_equal(drives):
    (jax_dir, _), (port_dir, _) = drives
    rel = sorted(p.relative_to(jax_dir) for p in (jax_dir / "store").rglob("*.features.npz"))
    assert len(rel) == 60
    assert rel == sorted(p.relative_to(port_dir)
                         for p in (port_dir / "store").rglob("*.features.npz"))
    for path in rel:
        j_rc, j_f = read_feature_file(jax_dir / path)
        t_rc, t_f = read_feature_file(port_dir / path)
        np.testing.assert_array_equal(t_rc, j_rc)
        np.testing.assert_array_equal(t_f, j_f)
    for name in ("etl_annotations.parquet", "etl_images.parquet"):
        want = pq.read_table(jax_dir / name).replace_schema_metadata(None)
        got = pq.read_table(port_dir / name)
        assert got.schema.metadata is None
        assert got.equals(want), name
    for name in ("benthic_attributes.json", "growth_forms.json", "label_mappings.json"):
        assert (port_dir / "taxonomy" / name).read_bytes() == \
            (jax_dir / "taxonomy" / name).read_bytes()


def test_same_subsample_recipe_and_quality(drives):
    (_, jax), (_, port) = drives
    assert port["subsample_realized"] == jax["subsample_realized"] == 2374
    assert port["recipe"] == jax["recipe"]
    assert port["export_parity_max_abs_diff"] <= 1e-6
    assert jax["export_parity_max_abs_diff"] <= 1e-6
    assert abs(port["accuracy"] - jax["accuracy"]) <= 0.05, (port["accuracy"],
                                                             jax["accuracy"])
    assert port["final_epoch"] <= 4 and port["best_val_epoch"] is not None


def test_the_record_decomposes_the_run(drives):
    _, (_, port) = drives
    assert set(port["stage_seconds"]) == {"synthesize", "manifest", "train", "verify"}
    assert port["device"] == {"type": "cpu", "name": port["device"]["name"],
                              "power_limit": None}
    breakdown = port["train_stage_breakdown"]
    assert breakdown["rows"] == 2374 and breakdown["epochs_run"] <= 4
    assert "Training call" in {s["name"] for s in port["profiled_sections"]}
    for key in ("balanced_accuracy", "log_loss", "f1_macro", "mcc",
                "cover_median_r_squared", "per_source_min_accuracy"):
        assert np.isfinite(port[key]), key
    assert port["registered_version"] == "v1"
    assert port["splits"] == {"train": 1900, "ref": 237, "val": 237}
    assert not {"link_probe", "link_note", "projected_vm_train_minutes"} & set(port)


def test_non_square_points_per_image(tmp_path):
    """A round-sqrt grid would give 7 x 7 = 49 rowcols for 50 features; the
    ceil-sqrt grid truncated to 50 keeps every file aligned."""
    summary = drive.synthesize_corpus(tmp_path, pool_rows=150, n_classes=4, dim=8,
                                      points_per_image=50, n_sources=2, seed=0)
    assert summary["images"] == 3
    assert pq.read_table(tmp_path / "etl_annotations.parquet").num_rows == 150
    files = sorted((tmp_path / "store").rglob("*.features.npz"))
    assert len(files) == 3
    for path in files:
        rowcols, feats = read_feature_file(path)
        assert rowcols.shape == (50, 2) and feats.shape == (50, 8)
        assert len({tuple(rc) for rc in rowcols}) == 50


def test_no_card_no_run(tmp_path):
    """The default device is the card: without one the drive fails before
    it writes a corpus, and falls back to nothing."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "mermaid_classifier_tpu_torch.scripts.full_recipe_drive",
         *TINY_ARGS, "--workdir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert not (tmp_path / "etl_annotations.parquet").exists()
