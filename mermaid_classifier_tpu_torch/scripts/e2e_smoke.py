"""One-command end-to-end drive of the port's pipeline from a fresh checkout.

    python -m mermaid_classifier_tpu_torch.scripts.e2e_smoke [--device cuda]

Synthesizes reef-like images + annotations into an object store, then runs
the production flow as a deployment would, every stage through the port's
CLIs as ``python -m`` subprocesses:

  1. ETL parquets -> build_coralnet_manifest -> manifest.parquet
  2. the port's run YAML (``jobs/processing_run.yaml``) -> sharded feature
     extraction (``LocalProcessBackend`` workers running the port's
     build_feature_bucket; on a CUDA card they share it)
  3. configs/example/training_config.yaml -> classifier_train (dataset ->
     train -> calibrate -> export artifact -> metrics -> register)
  4. the registered artifact reloaded (``load_predictor``), and the
     extracted features classified by predict_features
  5. generate_report -> self-contained HTML report

``--device`` (default ``cuda``) is passed to every CLI that takes it; on a
card the kernels are built once here before the workers start. A worker
that fails (for example ``--device cuda`` with no card) fails the drive,
which prints the workers' log tails. A shrunken backbone keeps it
minutes-fast; ``--production-backbone`` runs B0 224 / 4096 through the
fused-MBConv kernel, with ``--backbone-weights`` a bundle in place of the
seeded weights, over 8 images x 64 points per source by default: at the
shrunken backbone's 4 x 16 the 4096-d head learns nothing and the export
gate refuses it. ``--allow-unpinned-torch`` lets the export gate run
under a torch other than the parity-proven one.

Exit code 0 = artifact trained, exported, reloaded, and report written; the
output's last lines are ``stage budget: ...`` and ``PASS in ...``.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CONFIG_DIR = REPO / "configs" / "example"
RUN_YAML = REPO / "mermaid_classifier_tpu_torch" / "jobs" / "processing_run.yaml"

# Distinct per-class colors: patches around a point are dominated by the
# class color, so even a seeded-random backbone yields separable features
# and the smoke can assert real learning, not just plumbing.
CLASS_COLORS = {
    "1001": (220, 60, 40),   # Acropora/branching  -> red
    "1002": (40, 200, 70),   # Macroalgae          -> green
    "1003": (60, 80, 220),   # Porites/massive     -> blue
    "1004": (230, 200, 40),  # Acropora tabulate   -> yellow (rolls up to 1001's class)
}

TINY_BACKBONE = {
    "stem_channels": 8,
    "stages": [[1, 8, 1, 3, 1], [6, 16, 1, 3, 2]],
    "head_channels": 32,
    "se_ratio": 0.25,
    "feature_dim": 64,
    "mean_rgb": [0.485, 0.456, 0.406],
    "std_rgb": [0.229, 0.224, 0.225],
    "patch_size": 64,
    "compute_dtype": "float32",
}


def log(msg: str) -> None:
    print(f"[e2e] {msg}", flush=True)


_STAGE_BUDGET: list[tuple[str, float]] = []


class stage:
    """Context manager printing a ``stage-done <name> in Xs`` marker and
    recording the per-stage budget — on a deadline kill, the last marker in
    the captured output names the stage that blew up."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"stage-start {self.name}")
        self.t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        elapsed = time.time() - self.t0
        _STAGE_BUDGET.append((self.name, elapsed))
        if exc_type is None:
            log(f"stage-done {self.name} in {elapsed:.1f}s")
        else:
            log(f"stage-FAILED {self.name} after {elapsed:.1f}s ({exc_type.__name__})")
        return False


def make_store(env: dict):
    """The smoke's store, resolved the way production resolves it: an
    s3:// root goes through the stdlib-HTTP S3 backend (endpoint +
    credentials from env), anything else is a local-FS root."""
    root = env["OBJECT_STORE_ROOT"]
    if root.startswith("s3://"):
        from mermaid_classifier_tpu_torch.data.s3_store import (
            S3Credentials,
            S3ObjectStore,
        )

        creds = None
        if env.get("AWS_ACCESS_KEY_ID") and env.get("AWS_SECRET_ACCESS_KEY"):
            creds = S3Credentials(
                env["AWS_ACCESS_KEY_ID"], env["AWS_SECRET_ACCESS_KEY"]
            )
        return S3ObjectStore(
            env["OBJECT_STORE_ENDPOINT"],
            region=env.get("AWS_REGION", "us-east-1"),
            credentials=creds,
        )
    from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore

    return LocalFSObjectStore(root)


def synthesize_source_data(
    store, workspace: Path, sources: list[str], images_per_source: int,
    points_per_image: int, image_size: int, seed: int,
):
    """Images + per-source annotations.csv into the 'images' bucket, plus
    the ETL parquets the manifest builder joins."""
    import numpy as np
    from PIL import Image

    from mermaid_classifier_tpu_torch.common.relational import write_parquet_table

    rng = np.random.default_rng(seed)
    ann_rows, img_rows = [], []
    labels = sorted(CLASS_COLORS)
    # Points sit at the centers of non-overlapping grid cells, each cell
    # wholly painted its class color — neighboring points can never
    # overwrite each other's patch content.
    grid = max(int(round(points_per_image ** 0.5)), 1)
    cell = image_size // grid
    for source_id in sources:
        per_source = []
        for image_num in range(images_per_source):
            image_id = f"{source_id}{image_num:03d}"
            image = rng.integers(0, 40, size=(image_size, image_size, 3),
                                 dtype=np.uint8) + 100
            points = []
            for gr in range(grid):
                for gc in range(grid):
                    label = labels[int(rng.integers(0, len(labels)))]
                    color = np.asarray(CLASS_COLORS[label], dtype=np.int32)
                    jitter = rng.integers(-20, 20, size=3)
                    block = np.clip(color + jitter, 0, 255).astype(np.uint8)
                    image[gr * cell: (gr + 1) * cell,
                          gc * cell: (gc + 1) * cell] = block
                    points.append(
                        (gr * cell + cell // 2, gc * cell + cell // 2, label)
                    )
            image_key = f"s{source_id}/images/i{image_id}.jpg"
            buf = io.BytesIO()
            Image.fromarray(image).save(buf, format="JPEG", quality=92)
            store.put_bytes("images", image_key, buf.getvalue())
            img_rows.append(
                {"source_id": source_id, "image_id": image_id,
                 "header_status": "ok", "s3_key": image_key}
            )
            for r, c, label in points:
                per_source.append(
                    {"image_id": image_id, "image_key": image_key,
                     "row": r, "col": c}
                )
                ann_rows.append(
                    {"source_id": source_id, "image_id": image_id,
                     "row": r, "col": c, "coralnet_id": label}
                )
        csv_lines = ["image_id,image_key,row,col"] + [
            f"{p['image_id']},{p['image_key']},{p['row']},{p['col']}"
            for p in per_source
        ]
        store.put_bytes(
            "images", f"s{source_id}/annotations.csv",
            ("\n".join(csv_lines) + "\n").encode(),
        )
    write_parquet_table(ann_rows, str(workspace / "etl_annotations.parquet"))
    write_parquet_table(img_rows, str(workspace / "etl_images.parquet"))
    log(f"synthesized {len(img_rows)} images / {len(ann_rows)} points"
        f" across sources {sources}")


def run_cli(module: str, args: list[str], cwd: Path, env: dict) -> None:
    cmd = [sys.executable, "-m", f"mermaid_classifier_tpu_torch.scripts.{module}",
           *args]
    log(f"$ {module} {' '.join(args)}")
    subprocess.run(cmd, cwd=cwd, env=env, check=True)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workdir", default=None,
                        help="workspace dir (default: a temp dir)")
    parser.add_argument("--images-per-source", type=int, default=None,
                        help="default 4, or 8 with --production-backbone")
    parser.add_argument("--points-per-image", type=int, default=None,
                        help="rounded to a square grid of patch-sized cells;"
                        " default 16, or 64 with --production-backbone")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--production-backbone", action="store_true",
        help="real B0/224/4096 geometry instead of the minutes-fast"
        " shrunken backbone; its sizes default to 8 images x 64 points per"
        " source, since at 4 x 16 (128 points) the 4096-d head learns"
        " nothing and the export gate refuses it",
    )
    parser.add_argument(
        "--backbone-weights", default=None,
        help="a weight bundle (models.convert.save_backbone_npz) for the"
        " extraction workers; default the seeded backbone, whose B0 gives"
        " every patch nearly the same feature",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device of every stage (default cuda)")
    parser.add_argument("--allow-unpinned-torch", action="store_true",
                        help="export under a torch other than the parity-proven one")
    parser.add_argument(
        "--object-store-root", default=None,
        help="override the store root; 's3://' + --object-store-endpoint"
        " drives the whole pipeline over the S3 HTTP dialect",
    )
    parser.add_argument("--object-store-endpoint", default=None)
    args = parser.parse_args(argv)
    if args.images_per_source is None:
        args.images_per_source = 8 if args.production_backbone else 4
    if args.points_per_image is None:
        args.points_per_image = 64 if args.production_backbone else 16
    return args


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    t0 = time.time()
    if args.workdir:
        workspace = Path(args.workdir)
        workspace.mkdir(parents=True, exist_ok=True)
    else:
        workspace = Path(tempfile.mkdtemp(prefix="mermaid_e2e_"))
    log(f"workspace: {workspace}")

    # Offline; every subprocess inherits this environment and runs the
    # port's CLIs with ``-m`` from the workspace.
    env = {
        **os.environ,
        "PYTHONPATH": os.pathsep.join(
            p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p),
        "OBJECT_STORE_ROOT": args.object_store_root or str(workspace / "store"),
        "MERMAID_TAXONOMY_FIXTURE_DIR": str(CONFIG_DIR / "taxonomy"),
        "TAXONOMY_FIXTURE_DIR": str(CONFIG_DIR / "taxonomy"),
        "TRACKING_DIR": str(workspace / "tracking"),
        "FEATURE_CACHE_DIR": str(workspace / "feature_cache"),
        "CORALNET_TRAIN_DATA_BUCKET": "features",
        "MERMAID_TRAIN_DATA_BUCKET": "features",
        "BATCH_SIZE": "512",
    }
    if args.object_store_endpoint:
        env["OBJECT_STORE_ENDPOINT"] = args.object_store_endpoint
    device_args = ["--device", args.device]

    from mermaid_classifier_tpu_torch.jobs.launch import load_items

    sources = load_items(CONFIG_DIR / "sources.csv")

    # Cell size = patch size, so a patch never sees a neighboring class.
    grid = max(int(round(args.points_per_image ** 0.5)), 1)
    image_size = (224 if args.production_backbone else 64) * grid
    store = make_store(env)
    with stage("synthesize"):
        synthesize_source_data(
            store, workspace, sources, args.images_per_source,
            args.points_per_image, image_size, args.seed,
        )

    # Stage 1: ETL parquets -> training manifest (the manifest-builder CLI).
    with stage("manifest"):
        run_cli(
            "build_coralnet_manifest",
            ["--annotations-parquet", str(workspace / "etl_annotations.parquet"),
             "--images-parquet", str(workspace / "etl_images.parquet"),
             "--output", str(workspace / "manifest.parquet")],
            workspace, env,
        )

    # Stage 2: sharded extraction via the port's run YAML — N local worker
    # processes, the store as the coordination plane.
    backbone_args: list[str] = []
    if not args.production_backbone:
        config_json = workspace / "tiny_backbone.json"
        config_json.write_text(json.dumps(TINY_BACKBONE))
        backbone_args = ["--backbone-config-json", str(config_json)]
    if args.backbone_weights:
        backbone_args += ["--backbone-weights", str(Path(args.backbone_weights).resolve())]

    import torch

    from mermaid_classifier_tpu_torch.jobs.backend import LocalProcessBackend
    from mermaid_classifier_tpu_torch.jobs.launch import (
        build_processing_requests,
        wait_for_completion,
    )
    from mermaid_classifier_tpu_torch.jobs.launcher_config import parse_run_config

    with stage("extract"):
        if torch.device(args.device).type == "cuda" and torch.cuda.is_available():
            # One build here, not one per worker on a cold build directory.
            from mermaid_classifier_tpu_torch import _build

            log(f"kernel library {_build.build().name}")
        run_config = parse_run_config(RUN_YAML)
        requests = build_processing_requests(run_config, "e2e-smoke")
        backend = LocalProcessBackend(log_dir=workspace / "logs")
        job_ids = []
        try:
            for request in requests:
                # The YAML's entrypoint is repo-relative; workers may run
                # from any cwd, so anchor it to this checkout.
                if not os.path.isabs(request.command[1]):
                    request.command[1] = str(REPO / request.command[1])
                request.command.extend([*backbone_args, *device_args])
                request.env.update(env)
                job_ids.append(backend.submit(request))
            log(f"launched {len(job_ids)} extraction workers")
            statuses = wait_for_completion(backend, job_ids, poll_seconds=1.0,
                                           timeout_seconds=1800)
        finally:
            backend.terminate_all()
        bad = {j: s.value for j, s in statuses.items() if s.value != "Completed"}
        if bad:
            for log_file in sorted((workspace / "logs").glob("*.log")):
                log(f"--- {log_file.name} ---")
                print(log_file.read_text()[-2000:], flush=True)
            raise SystemExit(f"extraction workers failed: {bad}")

        n_features = sum(1 for _ in store.list_keys("features"))
        log(f"feature bucket holds {n_features} objects")

    # Stage 3: train from the committed training config (single source of
    # truth). cwd = workspace so manifest.parquet resolves.
    with stage("train"):
        run_cli(
            "classifier_train",
            ["--config-dir", str(CONFIG_DIR), "--run-name", "e2e-smoke",
             *device_args,
             *(["--allow-unpinned-torch"] if args.allow_unpinned_torch else [])],
            workspace, env,
        )

    # Locate the run + registered artifact, reload the artifact, predict.
    import numpy as np

    from mermaid_classifier_tpu_torch.inference.loader import load_predictor
    from mermaid_classifier_tpu_torch.tracking.local_tracker import LocalTracker

    with stage("reload"):
        tracker = LocalTracker(workspace / "tracking")
        runs = tracker.runs("example")
        if not runs:
            raise SystemExit("no tracked run found under experiment 'example'")
        run = runs[-1]
        metrics = run.latest_metrics()
        log(f"run {run.run_id}: {len(metrics)} metrics,"
            f" {len(run.list_artifacts())} artifacts")

        registry_root = workspace / "tracking" / "_models"
        artifact_dirs = (
            sorted(
                (d for d in registry_root.glob("*/v*") if d.is_dir()),
                key=lambda d: (d.parent.name, int(d.name[1:])),
            )
            if registry_root.is_dir()
            else []
        )
        if not artifact_dirs:
            raise SystemExit(f"no registered model under {registry_root}")
        predictor = load_predictor(artifact_dirs[-1], device=args.device)
        proba = predictor.predict_proba(
            np.zeros((25, predictor.input_dim), dtype=np.float32)
        )
        assert proba.shape == (25, len(predictor.classes))
        log(f"registered artifact reloads: {artifact_dirs[-1].name},"
            f" classes={predictor.classes}")

    # Stage 3b: bulk classification of the extracted features through the
    # serving CLI (the predict_features path a production user runs over a
    # finished feature bucket).
    with stage("bulk_predict"):
        feat_keys = [
            k for k in store.list_keys("features") if k.endswith(".features.npz")
        ][:4]
        if not feat_keys:
            raise SystemExit("no feature files found for bulk prediction")
        bulk_dir = workspace / "bulk_features"
        bulk_dir.mkdir(exist_ok=True)
        local_feats = []
        for k in feat_keys:
            local = bulk_dir / k.replace("/", "_")
            store.download("features", k, local)
            local_feats.append(str(local))
        preds_csv = workspace / "bulk_predictions.csv"
        run_cli(
            "predict_features",
            ["--classifier", str(artifact_dirs[-1]),
             "--output", str(preds_csv), "--top-n", "2", *device_args,
             *local_feats],
            workspace, env,
        )
        pred_lines = preds_csv.read_text().splitlines()
        if len(pred_lines) < 2 or not pred_lines[0].startswith("file,row,col"):
            raise SystemExit("bulk predictions CSV missing or malformed")
        log(f"bulk predict: {len(pred_lines) - 1} points across"
            f" {len(local_feats)} feature files")

    # Stage 4: HTML report.
    with stage("report"):
        report_path = workspace / "report.html"
        run_cli(
            "generate_report",
            ["--run-id", run.run_id,
             "--tracking-root", str(workspace / "tracking"),
             "--output", str(report_path)],
            workspace, env,
        )
        if not report_path.is_file() or report_path.stat().st_size < 1000:
            raise SystemExit("report.html missing or implausibly small")

    budget = " ".join(f"{n}={s:.1f}s" for n, s in _STAGE_BUDGET)
    log(f"stage budget: {budget}")
    log(f"PASS in {time.time() - t0:.0f}s")
    log(f"  accuracy metrics: { {k: round(v, 3) for k, v in metrics.items() if 'acc' in k} }")
    log(f"  artifact: {artifact_dirs[-1]}")
    log(f"  report:   {report_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
