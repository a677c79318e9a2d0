"""The C2 production recipe, end to end at production scale, through the
port's CLIs (head training on a CUDA card by default).

    python -m mermaid_classifier_tpu_torch.scripts.full_recipe_drive \\
        --resident-dtype int8 --workdir <dir with >= 12 GB free> \\
        [--output-json record.json] [--device cuda]

The drive composes the reference's C2 recipe (balanced subsample at
full-data budget with ``min_per_class`` 200, effective-number weights cap
5000, (500, 300, 100) @ 1e-4, 40 epochs + patience 3; reference:
docs/research/balancing-experiments.md:49-133) through the port's
production CLIs, each a ``python -m`` subprocess:

  1. ``synthesize`` -- a C2-shaped corpus: 620,000 points x 4096-dim
     features over 80 BAGF classes with Zipf imbalance and a rare tail,
     written as the production feature bucket
     (``s{source}/features/i{id}.features.npz``), the two ETL parquets and
     an 80-class taxonomy fixture (about 10.2 GB of f32 files);
  2. ``manifest`` -- ``build_coralnet_manifest``;
  3. ``train`` -- ``classifier_train --device <device>`` on a generated
     config dir carrying the recipe and device-resident epochs: ETL ->
     subsample -> trainer -> calibration -> 1e-6-gated export -> nine
     metric groups -> registry, all inside the timed stage;
  4. ``verify`` -- the registered artifact reloaded in this process with
     ``load_predictor(..., device=<device>)`` and the run's metrics read
     back (this is where this process starts CUDA).

Feature model: 80 unit-norm class centres in a 32-d latent space,
per-point latent noise sigma 0.27 (the classifier lands near 0.81
accuracy at production scale), projected to 4096-d through a fixed random
matrix. The same seed gives the same corpus as the JAX package's drive
(``scripts/full_recipe_drive.py``): the same draws in the same order and
equal parquet tables.

Output: one JSON line with per-stage seconds, ``train_full_recipe_minutes``
(the ``classifier_train`` wall clock), the runner's ``resident/*`` stage
budget, the metric row, and ``device`` (the card's name and power limit
as ``nvidia-smi`` reads them; the host's processor for ``--device cpu``).
``--device cpu`` with ``--allow-unpinned-torch`` runs it on the host at
small sizes.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import platform
import subprocess
import sys
import tempfile
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]

LATENT_DIM = 32
SIGMA = 0.27  # calibrated: ~0.81 val accuracy at production scale
N_ROOTS = 8
GF_IDS = ["gf-0", "gf-1", "gf-2", "gf-3"]
EXPERIMENT = "full-recipe"
MODEL_NAME = "mermaid-mlp-c2"


def log(msg: str) -> None:
    print(f"[full-recipe] {msg}", flush=True)


def device_entry(device: str) -> dict:
    """What a drive ran on: for a CUDA device the card's name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them; for
    the CPU the host's processor, with no power limit. A CUDA device
    without a card raises."""
    from mermaid_classifier_tpu_torch.models.extractor import _resolve_device

    if _resolve_device(device).type != "cuda":
        return {"type": "cpu", "name": platform.processor() or platform.machine(),
                "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name, power_limit = (part.strip() for part in line.rsplit(",", 1))
    return {"type": "cuda", "name": name, "power_limit": power_limit}


def build_taxonomy(n_classes: int, out_dir: Path) -> list[str]:
    """80 leaf BAs under 8 roots + 4 growth forms; class k maps CoralNet
    provider id (2000+k) to leaf k's BAGF combo (every 5th class GF-less,
    so the GF-relevant metric slices are non-trivial)."""
    ba_records = [
        {"id": f"ba-r{i}", "name": f"Root {i}", "parent": None}
        for i in range(N_ROOTS)
    ]
    leaves = []
    per_root = (n_classes + N_ROOTS - 1) // N_ROOTS
    for k in range(n_classes):
        root = k // per_root
        ba_id = f"ba-r{root}-c{k % per_root}"
        leaves.append(ba_id)
        ba_records.append(
            {"id": ba_id, "name": f"Class {k}", "parent": f"ba-r{root}"}
        )
    gf_names = {g: f"form {g[-1]}" for g in GF_IDS}
    mapping_records = []
    for k, ba_id in enumerate(leaves):
        gf_id = None if k % 5 == 0 else GF_IDS[k % len(GF_IDS)]
        mapping_records.append(
            {
                "provider_id": str(2000 + k),
                "provider_label": f"CN class {k}",
                "benthic_attribute_id": ba_id,
                "benthic_attribute_name": f"Class {k}",
                "growth_form_id": gf_id,
                "growth_form_name": gf_names[gf_id] if gf_id else None,
            }
        )
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "benthic_attributes.json").write_text(json.dumps(ba_records))
    (out_dir / "growth_forms.json").write_text(json.dumps(gf_names))
    (out_dir / "label_mappings.json").write_text(json.dumps(mapping_records))
    return [str(2000 + k) for k in range(n_classes)]


def zipf_class_probs(n_classes: int) -> np.ndarray:
    """Zipf body + a genuinely rare tail (last 12 classes x0.05), the shape
    where balanced(min_per_class=200) at full-data budget realizes ~72% of
    the pool -- mirroring the reference's 457,497-of-1.77M C2 subsample."""
    p = 1.0 / np.arange(1, n_classes + 1) ** 0.55
    n_rare = min(12, max(n_classes // 7, 1))
    p[-n_rare:] *= 0.05
    return p / p.sum()


def synthesize_corpus(
    workspace: Path,
    pool_rows: int,
    n_classes: int,
    dim: int,
    points_per_image: int,
    n_sources: int,
    seed: int,
) -> dict:
    """Feature bucket + ETL parquets, streamed image by image (O(image)
    memory however big the pool is)."""
    from mermaid_classifier_tpu_torch.common.relational import write_parquet_table
    from mermaid_classifier_tpu_torch.data.features_io import write_feature_file

    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, LATENT_DIM))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    projection = rng.normal(size=(LATENT_DIM, dim)).astype(np.float32)
    projection /= np.sqrt(LATENT_DIM)

    probs = zipf_class_probs(n_classes)
    labels = rng.choice(n_classes, size=pool_rows, p=probs)

    # ceil-sqrt grid truncated to exactly points_per_image cells: a
    # round-sqrt grid undershoots non-square counts (50 -> 7x7 = 49 rowcols
    # for 50 features) and the feature writer rejects the mismatch.
    grid = max(int(np.ceil(points_per_image**0.5)), 1)
    cell = 100
    rowcols = np.asarray(
        [
            (gr * cell + cell // 2, gc * cell + cell // 2)
            for gr in range(grid)
            for gc in range(grid)
        ],
        dtype=np.int32,
    )[:points_per_image]

    bucket_dir = workspace / "store" / "features"
    n_images = (pool_rows + points_per_image - 1) // points_per_image
    sources = [str(101 + s) for s in range(n_sources)]
    ann_rows: dict[str, list] = {
        "source_id": [], "image_id": [], "row": [], "col": [],
        "coralnet_id": [],
    }
    img_rows: dict[str, list] = {
        "source_id": [], "image_id": [], "header_status": [], "s3_key": [],
    }
    t_write = 0.0
    # Feature files are written by a small pool with bounded in-flight work,
    # while the features themselves (the deterministic rng stream) are drawn
    # strictly in order here.
    in_flight: deque = deque()
    with ThreadPoolExecutor(max_workers=4) as writer_pool:
        for img_idx in range(n_images):
            source = sources[img_idx % n_sources]
            image_id = f"{source}{img_idx:06d}"
            lo = img_idx * points_per_image
            y = labels[lo: lo + points_per_image]
            n_pts = len(y)
            latent = centers[y] + SIGMA * rng.standard_normal((n_pts, LATENT_DIM))
            features = (latent.astype(np.float32) @ projection).astype(np.float32)
            t0 = time.time()
            while len(in_flight) >= 8:
                in_flight.popleft().result()  # raise write errors, bound RAM
            in_flight.append(writer_pool.submit(
                write_feature_file,
                bucket_dir / f"s{source}" / "features" / f"i{image_id}.features.npz",
                rowcols[:n_pts],
                features,
            ))
            t_write += time.time() - t0
            img_rows["source_id"].append(source)
            img_rows["image_id"].append(image_id)
            img_rows["header_status"].append("ok")
            img_rows["s3_key"].append(f"s{source}/images/i{image_id}.jpg")
            ann_rows["source_id"].extend([source] * n_pts)
            ann_rows["image_id"].extend([image_id] * n_pts)
            ann_rows["row"].extend(int(r) for r, _ in rowcols[:n_pts])
            ann_rows["col"].extend(int(c) for _, c in rowcols[:n_pts])
            ann_rows["coralnet_id"].extend(str(2000 + int(k)) for k in y)
            if (img_idx + 1) % 1000 == 0:
                log(f"  synthesized {img_idx + 1}/{n_images} images")
        t0 = time.time()
        while in_flight:
            in_flight.popleft().result()
        t_write += time.time() - t0

    write_parquet_table(ann_rows, str(workspace / "etl_annotations.parquet"))
    write_parquet_table(img_rows, str(workspace / "etl_images.parquet"))
    class_counts = np.bincount(labels, minlength=n_classes)
    return {
        "pool_rows": int(pool_rows),
        "images": int(n_images),
        "sources": n_sources,
        "largest_class": int(class_counts.max()),
        "smallest_class": int(class_counts.min()),
        "feature_write_seconds": round(t_write, 1),
        "bucket_gb": round(pool_rows * dim * 4 / 1e9, 2),
    }


def write_config_dir(
    config_dir: Path, pool_rows: int, epochs: int, patience: int,
    resident_dtype: str = "float32", calibration_method: str = "sigmoid",
) -> None:
    """The C2 recipe verbatim (reference:
    docs/research/balancing-experiments.md:133 'Practical training recipe'):
    balanced subsample at full-data budget with min_per_class=200,
    effective-number weights cap 5000, 40 epochs + patience 3 on val loss,
    plus the device-resident epochs."""
    import yaml

    config_dir.mkdir(parents=True, exist_ok=True)
    config = {
        "dataset": {
            "coralnet_manifest_uri": "manifest.parquet",
            "include_mermaid": False,
            "ref_val_ratios": [0.1, 0.1],
            "subsample": {
                "strategy": "balanced",
                "total_annotations": int(pool_rows),
                "min_per_class": 200,
            },
            "weighting": {"enabled": True, "weight_ratio_cap": 5000},
        },
        "training": {
            "epochs": int(epochs),
            "early_stopping_patience": int(patience),
            "device_resident": True,
            "resident_dtype": resident_dtype,
            "calibration_method": calibration_method,
        },
        "tracking": {
            "experiment_name": EXPERIMENT,
            "model_name": MODEL_NAME,
        },
    }
    (config_dir / "training_config.yaml").write_text(yaml.safe_dump(config))


def drive_env(workspace: Path) -> dict:
    """The subprocesses' environment: the workspace's store, taxonomy,
    tracking and cache, and this checkout on the path (they run with
    ``-m`` from the workspace)."""
    taxonomy_dir = workspace / "taxonomy"
    return {
        **os.environ,
        "PYTHONPATH": os.pathsep.join(
            p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p),
        "OBJECT_STORE_ROOT": str(workspace / "store"),
        "MERMAID_TAXONOMY_FIXTURE_DIR": str(taxonomy_dir),
        "TAXONOMY_FIXTURE_DIR": str(taxonomy_dir),
        "TRACKING_DIR": str(workspace / "tracking"),
        "FEATURE_CACHE_DIR": str(workspace / "feature_cache"),
        "CORALNET_TRAIN_DATA_BUCKET": "features",
        "MERMAID_TRAIN_DATA_BUCKET": "features",
    }


def run_cli(module: str, args: list[str], workspace: Path, env: dict) -> None:
    subprocess.run(
        [sys.executable, "-m", f"mermaid_classifier_tpu_torch.scripts.{module}", *args],
        cwd=workspace, env=env, check=True,
    )


def read_run(workspace: Path, device: str) -> dict:
    """The tracked run's metrics, split sizes and section profile, and a
    25-row forward of the latest registered artifact on ``device``."""
    from mermaid_classifier_tpu_torch.inference.loader import load_predictor
    from mermaid_classifier_tpu_torch.tracking.local_tracker import LocalTracker

    runs = LocalTracker(workspace / "tracking").runs(EXPERIMENT)
    if not runs:
        raise SystemExit(f"no tracked run under experiment {EXPERIMENT!r}")
    run = runs[-1]
    sections = None
    sections_csv = run.run_dir / "artifacts" / "profiled_sections.csv"
    if sections_csv.is_file():
        with open(sections_csv) as f:
            sections = [
                {"name": row["name"], "seconds": round(float(row["seconds"]), 1)}
                for row in csv.DictReader(f)
            ]
    stats_yaml = run.run_dir / "artifacts" / "dataset" / "train_summary_stats.yaml"
    stats = dict(line.split(": ", 1) for line in stats_yaml.read_text().splitlines())
    splits = {split: int(stats[f"annotations_{split}"]) for split in ("train", "ref", "val")}
    model_dir = workspace / "tracking" / "_models" / MODEL_NAME
    # The latest registered version (repeat runs in one --workdir bump vN).
    registry = max(
        (d for d in model_dir.iterdir() if d.name.lstrip("v").isdigit()),
        key=lambda d: int(d.name.lstrip("v")),
    )
    predictor = load_predictor(registry, device=device)
    proba = predictor.predict_proba(
        np.zeros((25, predictor.input_dim), dtype=np.float32)
    )
    if proba.shape != (25, len(predictor.classes)):
        raise SystemExit(f"the registered artifact gave probabilities {proba.shape}")
    return {"metrics": run.latest_metrics(), "sections": sections, "splits": splits,
            "registry": registry.name}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workdir", default=None,
                        help="workspace (default: temp dir, deleted on exit);"
                        " the default corpus needs about 12 GB")
    parser.add_argument("--skip-synthesize", action="store_true",
                        help="reuse the corpus already in --workdir (reruns"
                        " of the train stage without writing the corpus"
                        " again); needs a prior run with the same --workdir"
                        " and shape flags")
    parser.add_argument("--pool-rows", type=int, default=620_000,
                        help="annotation pool size; the C2 default realizes"
                        " a ~449k balanced subsample")
    parser.add_argument("--classes", type=int, default=80)
    parser.add_argument("--dim", type=int, default=4096)
    parser.add_argument("--points-per-image", type=int, default=100)
    parser.add_argument("--sources", type=int, default=20)
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--patience", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output-json", default=None,
                        help="also write the result JSON to this path")
    parser.add_argument("--device", default="cuda",
                        help="torch device of classifier_train and of the"
                        " verify stage (default cuda)")
    parser.add_argument("--allow-unpinned-torch", action="store_true",
                        help="export under a torch other than the parity-proven one")
    parser.add_argument("--resident-dtype", default="float32",
                        choices=("float32", "bfloat16", "int8"),
                        help="storage precision of the device-resident"
                        " feature buffer; bfloat16 halves its bytes, int8"
                        " (per-row scales) quarters them (compute stays f32)")
    parser.add_argument("--calibration", default="sigmoid",
                        choices=("sigmoid", "temperature"),
                        help="calibration family: 'sigmoid' is the"
                        " reference-parity prefit-Platt recipe;"
                        " 'temperature' fits one scalar by NLL on the ref split")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    if args.workdir:
        workspace = Path(args.workdir).resolve()
        workspace.mkdir(parents=True, exist_ok=True)
        cleanup = None
    else:
        cleanup = tempfile.TemporaryDirectory(prefix="full_recipe_")
        workspace = Path(cleanup.name)
    log(f"workspace: {workspace}")
    device = device_entry(args.device)
    log(f"device: {device}")

    stages: dict[str, float] = {}
    t_total = time.time()

    # --- stage: synthesize ---------------------------------------------------
    t0 = time.time()
    if args.skip_synthesize:
        if not (workspace / "etl_annotations.parquet").is_file():
            raise SystemExit(
                f"--skip-synthesize: no corpus in {workspace} (run once"
                " without the flag first)"
            )
        corpus = {"reused": True}
    else:
        build_taxonomy(args.classes, workspace / "taxonomy")
        corpus = synthesize_corpus(
            workspace, args.pool_rows, args.classes, args.dim,
            args.points_per_image, args.sources, args.seed,
        )
    write_config_dir(
        workspace / "config", args.pool_rows, args.epochs, args.patience,
        resident_dtype=args.resident_dtype,
        calibration_method=args.calibration,
    )
    stages["synthesize"] = time.time() - t0
    log(f"synthesize: {stages['synthesize']:.1f}s {corpus}")

    env = drive_env(workspace)

    # --- stage: manifest -----------------------------------------------------
    t0 = time.time()
    run_cli("build_coralnet_manifest", [
        "--annotations-parquet", str(workspace / "etl_annotations.parquet"),
        "--images-parquet", str(workspace / "etl_images.parquet"),
        "--output", str(workspace / "manifest.parquet"),
    ], workspace, env)
    stages["manifest"] = time.time() - t0
    log(f"manifest: {stages['manifest']:.1f}s")

    # --- stage: train (the timed C2 leg) ------------------------------------
    t0 = time.time()
    run_cli("classifier_train", [
        "--config-dir", str(workspace / "config"), "--run-name", "c2-full-recipe",
        "--device", args.device,
        *(["--allow-unpinned-torch"] if args.allow_unpinned_torch else []),
    ], workspace, env)
    stages["train"] = time.time() - t0
    log(f"train: {stages['train']:.1f}s")

    # --- stage: verify (CUDA starts in this process here) -------------------
    t0 = time.time()
    run = read_run(workspace, args.device)
    stages["verify"] = time.time() - t0
    metrics = run["metrics"]

    result = {
        "train_full_recipe_minutes": round(stages["train"] / 60.0, 2),
        "total_minutes": round((time.time() - t_total) / 60.0, 2),
        "stage_seconds": {k: round(v, 1) for k, v in stages.items()},
        "device": device,
        "corpus": corpus,
        "recipe": {
            "pool_rows": args.pool_rows,
            "classes": args.classes,
            "dim": args.dim,
            "subsample": f"balanced(total={args.pool_rows}, min_per_class=200)",
            "weighting": "effective_number(cap=5000)",
            "epochs": args.epochs,
            "patience": args.patience,
            "device_resident": True,
            "resident_dtype": args.resident_dtype,
            "calibration": args.calibration,
        },
        "subsample_realized": metrics.get("subsample/realized_total"),
        "splits": run["splits"],
        # The runner's resident stage budget inside the train stage (disk
        # fill, staging, epochs, calibration, evaluation), so the headline
        # minutes decompose without logs.
        "train_stage_breakdown": {
            key.split("/", 1)[1]: value
            for key, value in sorted(metrics.items())
            if key.startswith("resident/")
        } or None,
        # The runner's section profile (ETL phases + the training call):
        # what no section holds is the subprocess's start and imports.
        "profiled_sections": run["sections"],
        "final_epoch": metrics.get("early_stop/final_epoch"),
        "best_val_epoch": metrics.get("early_stop/best_val_epoch"),
        "accuracy": metrics.get("accuracy"),
        "balanced_accuracy": metrics.get("balanced_accuracy"),
        "log_loss": metrics.get("log_loss"),
        # The rest of the reference's C2 metric row (reference values:
        # f1_macro 0.758, MCC 0.806, cover_R2 0.647 --
        # docs/research/balancing-experiments.md:52-56).
        "f1_macro": metrics.get("f1_macro"),
        "mcc": metrics.get("mcc"),
        "cover_median_r_squared": metrics.get("cover_median_r_squared"),
        "per_source_min_accuracy": metrics.get("per_source/min_accuracy"),
        "export_parity_max_abs_diff": metrics.get("export_parity_max_abs_diff"),
        "n_metrics_logged": len(metrics),
        "registered_version": run["registry"],
        # The upstream reference's own figure, on its CPU instance; not a
        # target for this port.
        "reference_minutes": 35.0,
        "reference_note": (
            "reference C2 confirm on its CPU instance: 457,497-row subsample,"
            " stop at epoch 17, ~35 min"
            " (docs/research/balancing-experiments.md:84,133)"
        ),
    }
    if cleanup is not None:
        cleanup.cleanup()
    line = json.dumps(result)
    if args.output_json:
        Path(args.output_json).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
