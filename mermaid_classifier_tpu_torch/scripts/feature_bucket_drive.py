"""Extraction at scale with the bucket as the only progress state: a clean
build, a build killed with SIGKILL mid-run and resumed, and the proof that
the resume changed nothing, through the port's ``build_feature_bucket``
(the crop and fused-MBConv kernels on a CUDA card by default).

    python -m mermaid_classifier_tpu_torch.scripts.feature_bucket_drive \\
        --workdir <dir> [--output-json record.json] [--device cuda]

A crashed or preempted worker resumes by running again with skip-existing;
done images are never rewritten, and the output is identical to an
uninterrupted build (reference: scripts/build_feature_bucket.py:15-22,
337-349,740-757 and docs/feature_extraction_at_scale.md:109-161). Stages:

  1. ``synthesize`` -- a production-shaped corpus (default 520 JPEGs at
     1536x2048, 1440x1920 and 1152x1536, 200 points each, over 8 sources);
  2. ``kernel_build`` -- on a card, the kernel library is built here once,
     so that every build process below loads it and none compiles;
  3. ``uninterrupted`` -- a clean build into bucket featsA (the baseline);
  4. ``interrupted`` -- the same build into featsB, SIGKILLed the moment
     the target bucket shows ``--kill-frac`` of the images done;
  5. ``resume`` -- the same command again (skip-existing is the default),
     completing featsB;
  6. ``verify`` -- featsB is complete with no failure, every feature file
     finished before the kill has the same bytes and ``mtime_ns`` after the
     resume, featsB is byte-identical to featsA, and no ``.part`` file is
     left.

Each build process runs ``python -m
mermaid_classifier_tpu_torch.scripts.build_feature_bucket``: on a card in
``--compute-dtype`` (default bfloat16, behind its numerics gate) on the
default fused trunk, with ``--device cpu`` a tiny backbone over small
images. The record carries per-stage seconds, the progress log's start and
steady rates, each build process's kernel launches as its log gives them
(the last ``kernel launches so far`` line: a killed process never reaches
its closing line), and ``device`` (the card's name and power limit).
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from mermaid_classifier_tpu_torch.scripts.full_recipe_drive import device_entry

REPO = Path(__file__).resolve().parents[2]

#: Benthic-survey camera resolutions (h, w): the reference's at-scale corpus
#: is multi-megapixel JPEGs of varying shape
#: (reference: docs/feature_extraction_at_scale.md:109-135).
PRODUCTION_SIZES = ((1536, 2048), (1440, 1920), (1152, 1536))
SMOKE_SIZES = ((96, 128), (64, 64))

TINY_CONFIG = {
    "stem_channels": 8,
    "stages": [[1, 8, 1, 1, 3]],
    "head_channels": 16,
    "feature_dim": 16,
    "patch_size": 32,
}

_IMAGE_LAUNCHES_RE = re.compile(
    r"image \S+ written \(\d+ points\); kernel launches so far:"
    r" crop (\d+), fused_mbconv (\d+)")
_PROCESS_LAUNCHES_RE = re.compile(
    r"kernel launches in this process: crop (\d+), fused_mbconv (\d+)")


def log(msg: str) -> None:
    print(f"[feature_bucket_drive] {msg}", flush=True)


# -- corpus -------------------------------------------------------------------


def smooth_field(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """One (h, w, 3) uint8 image: a (h // 32, w // 32) random field upsampled
    bilinearly, plus a per-pixel dither in [-12, 12] shared by the channels."""
    from PIL import Image

    base = rng.integers(0, 256, size=(h // 32, w // 32, 3), dtype=np.uint8)
    arr = np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR),
                     dtype=np.int16)
    dither = rng.integers(-12, 13, size=(h, w, 1), dtype=np.int16)
    return np.clip(arr + dither, 0, 255).astype(np.uint8)


def synthesize_corpus(
    store_root: Path,
    n_images: int,
    points: int,
    n_sources: int,
    sizes: tuple[tuple[int, int], ...],
    seed: int,
    jpeg_quality: int = 90,
) -> dict:
    """JPEGs + canonical annotations.csv per source under ``imgs``.

    Images are low-frequency random fields (small noise upsampled) with a
    mild high-frequency dither: like a photograph of a smooth scene rather
    than pure noise, cheap to synthesize and to decode. Deterministic in
    ``seed``: the JAX package's drive draws the same bytes.
    """
    from PIL import Image

    from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore

    store = LocalFSObjectStore(store_root)
    rng = np.random.default_rng(seed)
    per_source = [n_images // n_sources] * n_sources
    for i in range(n_images % n_sources):
        per_source[i] += 1

    total_points = 0
    total_bytes = 0
    idx = 0
    for s in range(n_sources):
        source_id = str(s + 1)
        lines = ["image_id,image_key,row,col"]
        for _ in range(per_source[s]):
            h, w = sizes[idx % len(sizes)]
            arr = smooth_field(rng, h, w)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG", quality=jpeg_quality)
            key = f"s{source_id}/images/i{idx:05d}.jpg"
            store.put_bytes("imgs", key, buf.getvalue())
            total_bytes += buf.getbuffer().nbytes
            rows = rng.integers(0, h, size=points)
            cols = rng.integers(0, w, size=points)
            lines.extend(
                f"{idx:05d},{key},{r},{c}" for r, c in zip(rows, cols)
            )
            total_points += points
            idx += 1
        store.put_bytes(
            "imgs", f"s{source_id}/annotations.csv",
            ("\n".join(lines) + "\n").encode(),
        )
    return {
        "images": idx,
        "points": total_points,
        "jpeg_megabytes": round(total_bytes / 1e6, 1),
        "sizes": [list(s) for s in sizes],
    }


# -- build runs ---------------------------------------------------------------


def on_card(args) -> bool:
    return args.device.startswith("cuda")


def build_command(args, target_bucket: str, workspace: Path) -> list[str]:
    source_ids = ",".join(str(s + 1) for s in range(args.sources))
    cmd = [
        sys.executable, "-m", "mermaid_classifier_tpu_torch.scripts.build_feature_bucket",
        "--source-ids", source_ids,
        "--source-bucket", "imgs",
        "--target-bucket", target_bucket,
        "--progress-log", str(workspace / f"{target_bucket}_progress.jsonl"),
        "--error-log", str(workspace / f"{target_bucket}_errors.csv"),
        "--decode-workers", str(args.decode_workers),
        "--backbone-batch", str(args.backbone_batch),
        "--device", args.device,
    ]
    if on_card(args):
        # The production path: B0 on the default fused trunk, a reduced
        # precision behind its mandatory device-numerics gate.
        cmd += ["--compute-dtype", args.compute_dtype]
    else:
        config_path = workspace / "tiny_backbone.json"
        if not config_path.is_file():
            config_path.write_text(json.dumps(TINY_CONFIG))
        cmd += ["--backbone-config-json", str(config_path)]
    return cmd


def drive_env(workspace: Path) -> dict:
    return {
        **os.environ,
        "PYTHONPATH": os.pathsep.join(
            p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p),
        "OBJECT_STORE_ROOT": str(workspace / "store"),
    }


def features_dir(workspace: Path, bucket: str) -> Path:
    return workspace / "store" / bucket


def count_feature_files(workspace: Path, bucket: str) -> int:
    root = features_dir(workspace, bucket)
    if not root.is_dir():
        return 0
    return sum(1 for _ in root.glob("s*/features/*.features.npz"))


def run_uninterrupted(cmd, env, logfile: Path) -> float:
    t0 = time.time()
    with logfile.open("w") as f:
        subprocess.run(cmd, env=env, check=True, stdout=f, stderr=subprocess.STDOUT)
    return time.time() - t0


def run_until_killed(
    cmd, env, logfile: Path, workspace: Path, bucket: str,
    kill_after_images: int, total_images: int,
) -> tuple[bool, int, float]:
    """Start the build, SIGKILL it once ``kill_after_images`` feature files
    exist in the target bucket. Returns (killed, files_at_kill, seconds)."""
    t0 = time.time()
    with logfile.open("w") as f:
        proc = subprocess.Popen(
            cmd, env=env, stdout=f, stderr=subprocess.STDOUT
        )
        try:
            while proc.poll() is None:
                done = count_feature_files(workspace, bucket)
                if done >= kill_after_images:
                    # kill -9: no atexit, no finally blocks -- the hardest
                    # crash the resume discipline must survive.
                    os.kill(proc.pid, signal.SIGKILL)
                    proc.wait()
                    elapsed = time.time() - t0
                    log(
                        f"SIGKILL'd {bucket} build at {done}/{total_images}"
                        f" images after {elapsed:.1f}s"
                    )
                    return True, done, elapsed
                time.sleep(0.05)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return False, count_feature_files(workspace, bucket), time.time() - t0


def process_launches(logfile: Path) -> dict:
    """One build process's kernel launches from its log: the images it
    wrote (one ``kernel launches so far`` line each) and its crop and
    fused-MBConv launches, from its closing line where it reached it, else
    from the last image it wrote. On the CPU both counts are 0."""
    text = logfile.read_text()
    per_image = _IMAGE_LAUNCHES_RE.findall(text)
    closing = _PROCESS_LAUNCHES_RE.findall(text)
    counts = closing[-1] if closing else (per_image[-1] if per_image else None)
    return {
        "images_written": len(per_image),
        "crop": int(counts[0]) if counts else None,
        "fused_mbconv": int(counts[1]) if counts else None,
        "closing_line": bool(closing),
    }


# -- verification -------------------------------------------------------------


def snapshot_tree(root: Path) -> dict[str, tuple[int, int, str]]:
    """{relpath: (size, mtime_ns, sha256)} over every file under root."""
    out: dict[str, tuple[int, int, str]] = {}
    for path in sorted(root.rglob("*")):
        if not path.is_file():
            continue
        digest = hashlib.sha256(path.read_bytes()).hexdigest()
        st = path.stat()
        out[str(path.relative_to(root))] = (st.st_size, st.st_mtime_ns, digest)
    return out


def verify_buckets(
    workspace: Path,
    pre_resume: dict[str, tuple[int, int, str]],
    expected_images: int,
) -> dict:
    a_root = features_dir(workspace, "featsA")
    b_root = features_dir(workspace, "featsB")
    a = snapshot_tree(a_root)
    b = snapshot_tree(b_root)

    stray_parts = [k for k in b if k.endswith(".part")]
    a_files = {k: v for k, v in a.items() if not k.endswith(".part")}
    b_files = {k: v for k, v in b.items() if not k.endswith(".part")}

    missing = sorted(set(a_files) - set(b_files))
    extra = sorted(set(b_files) - set(a_files))
    mismatched = sorted(
        k for k in a_files
        if k in b_files and (a_files[k][0], a_files[k][2]) != (b_files[k][0], b_files[k][2])
    )
    rewritten = sorted(
        k for k, (size, mtime_ns, digest) in pre_resume.items()
        if not k.endswith(".part")
        and (k not in b or b[k] != (size, mtime_ns, digest))
    )
    n_features_b = sum(1 for k in b_files if k.endswith(".features.npz"))
    return {
        "featsB_feature_files": n_features_b,
        "featsB_complete": n_features_b == expected_images,
        "identical_to_uninterrupted": not (missing or extra or mismatched),
        "missing_vs_uninterrupted": missing[:10],
        "extra_vs_uninterrupted": extra[:10],
        "mismatched_vs_uninterrupted": mismatched[:10],
        "rewrites_after_resume": len(rewritten),
        "rewritten_files": rewritten[:10],
        "stray_part_files": len(stray_parts),
    }


def progress_stats(progress_log: Path, proc_start: float) -> dict:
    """Steady throughput from the builder's append-only progress log: the
    time to the first image (process start, imports, weights, the numerics
    gate, the first pipeline fill) apart from the steady per-image rate."""
    if not progress_log.is_file():
        return {}
    records = [
        json.loads(line)
        for line in progress_log.read_text().splitlines() if line.strip()
    ]
    # The log is appended across the kill and the resume: keep only this
    # process's records.
    records = [r for r in records if r["time"] >= proc_start]
    if not records:
        return {}
    t_first = records[0]["time"]
    t_last = records[-1]["time"]
    points_after_first = sum(r.get("points", 0) for r in records[1:])
    out = {
        "images_logged": len(records),
        "first_image_seconds": round(t_first - proc_start, 2),
    }
    if len(records) > 1 and t_last > t_first:
        out["steady_points_per_sec"] = round(
            points_after_first / (t_last - t_first), 1
        )
        out["steady_ms_per_image"] = round(
            (t_last - t_first) * 1000 / (len(records) - 1), 1
        )
    return out


# -- main ---------------------------------------------------------------------


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--images", type=int, default=520)
    parser.add_argument("--points", type=int, default=200)
    parser.add_argument("--sources", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kill-frac", type=float, default=0.4,
                        help="fraction of images done when the interrupted"
                        " build takes SIGKILL")
    parser.add_argument("--decode-workers", type=int, default=8)
    parser.add_argument("--backbone-batch", type=int, default=128)
    parser.add_argument("--compute-dtype", default="bfloat16",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--device", default="cuda",
                        help="torch device of the build processes (default"
                        " cuda: B0 over production-sized images; cpu: a tiny"
                        " backbone over small images)")
    parser.add_argument("--skip-synthesize", action="store_true",
                        help="reuse the corpus already in --workdir")
    parser.add_argument("--output-json", default=None)
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    if args.workdir:
        workspace = Path(args.workdir).resolve()
        workspace.mkdir(parents=True, exist_ok=True)
        cleanup = None
    else:
        cleanup = tempfile.TemporaryDirectory(prefix="feature_bucket_drive_")
        workspace = Path(cleanup.name)
    log(f"workspace: {workspace}")
    device = device_entry(args.device)
    log(f"device: {device}")

    sizes = PRODUCTION_SIZES if on_card(args) else SMOKE_SIZES
    env = drive_env(workspace)
    stages: dict[str, float] = {}
    t_total = time.time()

    # --- synthesize ----------------------------------------------------------
    t0 = time.time()
    marker = workspace / "corpus.json"
    # The feature buckets are cleared whatever --skip-synthesize says: left
    # populated, the uninterrupted build would skip every image, the kill
    # would fire on a done bucket, and the proof would prove nothing.
    for bucket in ("featsA", "featsB"):
        shutil.rmtree(features_dir(workspace, bucket), ignore_errors=True)
        (workspace / f"{bucket}_progress.jsonl").unlink(missing_ok=True)
        (workspace / f"{bucket}_errors.csv").unlink(missing_ok=True)
    if args.skip_synthesize and marker.is_file():
        corpus = json.loads(marker.read_text())
        log(f"corpus reused: {corpus}")
    else:
        corpus = synthesize_corpus(
            workspace / "store", args.images, args.points, args.sources,
            sizes, args.seed,
        )
        marker.write_text(json.dumps(corpus))
    stages["synthesize"] = round(time.time() - t0, 1)
    log(f"synthesize: {stages['synthesize']}s {corpus}")

    # --- the kernels, built once before any timed build -----------------------
    library = None
    if on_card(args):
        from mermaid_classifier_tpu_torch import _build

        t0 = time.time()
        library = _build.build()
        stages["kernel_build"] = round(time.time() - t0, 1)
        library_mtime = library.stat().st_mtime_ns
        log(f"kernel library {library.name} ({stages['kernel_build']}s)")

    # --- uninterrupted baseline build (featsA) -------------------------------
    t0 = time.time()
    cmd_a = build_command(args, "featsA", workspace)
    stages["uninterrupted"] = round(
        run_uninterrupted(cmd_a, env, workspace / "featsA.log"), 1
    )
    done_a = count_feature_files(workspace, "featsA")
    stats_a = progress_stats(workspace / "featsA_progress.jsonl", t0)
    log(f"uninterrupted: {stages['uninterrupted']}s, {done_a} images {stats_a}")
    if done_a != args.images:
        log(f"FATAL: uninterrupted build wrote {done_a}/{args.images}")
        return 1

    # --- interrupted build (featsB), SIGKILL mid-run --------------------------
    kill_after = max(1, int(args.images * args.kill_frac))
    cmd_b = build_command(args, "featsB", workspace)
    killed = False
    for attempt in range(3):
        killed, files_at_kill, seconds = run_until_killed(
            cmd_b, env, workspace / "featsB_kill.log", workspace, "featsB",
            kill_after, args.images,
        )
        if killed:
            break
        # The build outran the poller (only plausible at smoke scale):
        # start over with the earliest possible kill point.
        log(f"attempt {attempt}: build finished before the kill landed; retrying")
        shutil.rmtree(features_dir(workspace, "featsB"), ignore_errors=True)
        (workspace / "featsB_progress.jsonl").unlink(missing_ok=True)
        kill_after = 1
    stages["interrupted_until_kill"] = round(seconds, 1)
    if not killed:
        log("FATAL: could not land the mid-run SIGKILL")
        return 1

    # --- resume (same command; skip-existing is the default) -----------------
    pre_resume = snapshot_tree(features_dir(workspace, "featsB"))
    done_before_resume = sum(
        1 for k in pre_resume if k.endswith(".features.npz")
    )
    parts_before_resume = sum(1 for k in pre_resume if k.endswith(".part"))
    t0 = time.time()
    with (workspace / "featsB_resume.log").open("w") as f:
        resume_proc = subprocess.run(
            cmd_b, env=env, stdout=f, stderr=subprocess.STDOUT
        )
    stages["resume"] = round(time.time() - t0, 1)
    stats_resume = progress_stats(workspace / "featsB_progress.jsonl", t0)
    log(
        f"resume: rc={resume_proc.returncode} {stages['resume']}s"
        f" (resumed past {done_before_resume} done images)"
    )
    if resume_proc.returncode != 0:
        log("FATAL: resume exited nonzero")
        return 1

    # --- verify ----------------------------------------------------------------
    t0 = time.time()
    verdicts = verify_buckets(workspace, pre_resume, args.images)
    stages["verify"] = round(time.time() - t0, 1)
    errors_csv = workspace / "featsB_errors.csv"
    failures_logged = (
        max(0, len(errors_csv.read_text().splitlines()) - 1)
        if errors_csv.is_file() else 0
    )
    launches = {
        name: process_launches(workspace / f"{log_name}.log")
        for name, log_name in (("uninterrupted", "featsA"), ("killed", "featsB_kill"),
                               ("resume", "featsB_resume"))
    }
    kernel_library = None
    if library is not None:
        # Every build process loaded the library built above: none rebuilt it.
        kernel_library = {
            "name": library.name,
            "unchanged_by_the_builds": library.is_file()
            and library.stat().st_mtime_ns == library_mtime,
        }

    points_total = corpus["points"]
    record = {
        "images_total": args.images,
        "points_total": points_total,
        "sources": args.sources,
        "image_sizes": corpus["sizes"],
        "corpus_jpeg_megabytes": corpus["jpeg_megabytes"],
        "backbone": (f"b0-fused-{args.compute_dtype} (numerics-gated)" if on_card(args)
                     else "tiny-cpu"),
        "device": device,
        "stage_seconds": stages,
        "total_minutes": round((time.time() - t_total) / 60, 2),
        "uninterrupted_points_per_sec": round(points_total / stages["uninterrupted"], 1),
        "uninterrupted_stats": stats_a,
        "resume_stats": stats_resume,
        "kernel_launches": launches,
        "kernel_library": kernel_library,
        "kill_resume": {
            "killed_mid_run": killed,
            "kill_signal": "SIGKILL",
            "kill_threshold_images": kill_after,
            "files_at_kill": files_at_kill,
            "done_before_resume": done_before_resume,
            "part_files_before_resume": parts_before_resume,
            "resumed_images": args.images - done_before_resume,
            "failures_logged": failures_logged,
            **verdicts,
        },
        "reference_note": (
            "reference analog: scripts/build_feature_bucket.py"
            " bucket-as-progress-truth resume (:15-22,:337-349,:740-757);"
            " synthetic low-frequency JPEG corpus (decode cost is below a"
            " real photo's; upload bytes and device compute are the"
            " production shape)"
        ),
    }
    ok = (
        verdicts["featsB_complete"]
        and verdicts["identical_to_uninterrupted"]
        and verdicts["rewrites_after_resume"] == 0
        and failures_logged == 0
    )
    record["ok"] = ok
    print(json.dumps(record))
    if args.output_json:
        Path(args.output_json).write_text(json.dumps(record, indent=1) + "\n")
    if cleanup is not None:
        cleanup.cleanup()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
