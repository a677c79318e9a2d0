"""The port's multi-worker fan-out on the CPU: the port's launcher submits
real subprocess workers running the port's bucket CLI as a file
(``--device cpu``, a tiny backbone with one fused-MBConv block) against a
shared local store, as tests/jobs/test_fanout_integration.py does for the
JAX package.

- Two workers' feature files equal a single-process run's bit for bit, at
  the same dtype; the worker whose shard holds a truncated object ends
  FAILED and its log and the error log name the image; every other image
  lands.
- Relaunching the run (through the ``launch_processing`` CLI) skips every
  done image: no file's bytes or ``mtime_ns`` change, and the CLI exits 1
  for the failed worker again.
- The shards are the JAX launcher's for the same run YAML.
- No fallback: workers launched with ``--device cuda`` where there is no
  card end FAILED, and the CLI exits 1.
"""

import io
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.jobs import launch as jlaunch
from mermaid_classifier_tpu.jobs import launcher_config as jcfg
from mermaid_classifier_tpu_torch.data.feature_bucket import annotations_key, feature_key
from mermaid_classifier_tpu_torch.data.features_io import read_feature_file
from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
from mermaid_classifier_tpu_torch.jobs import (
    JobStatus,
    LocalProcessBackend,
    build_processing_requests,
    launch_processing,
    parse_run_config,
    wait_for_completion,
)
from mermaid_classifier_tpu_torch.scripts import build_feature_bucket
from tests.torch_store_env import store_root_env  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
ENTRY = REPO / "mermaid_classifier_tpu_torch" / "scripts" / "build_feature_bucket.py"
# The second stage's second block is stride 1 with an expansion: fusable.
TINY = {
    "stem_channels": 8, "stages": [[1, 8, 1, 1, 3], [6, 16, 2, 2, 3]],
    "head_channels": 16, "se_ratio": 0.25, "feature_dim": 16,
    "mean_rgb": [0.485, 0.456, 0.406], "std_rgb": [0.229, 0.224, 0.225],
    "patch_size": 32,
}
SOURCES = ["1", "2", "3", "4"]
CORRUPT = ("3", "b")  # source 3 goes to worker 0 with source 1
SRC = "imgs"


def png_bytes(rng) -> bytes:
    from PIL import Image

    arr = rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture
def fanout(tmp_path, store_root_env):
    """A store of four sources of two images (one object truncated), the
    tiny backbone's JSON and a run YAML of two workers over sources.csv;
    returns a function writing that YAML for a device and target bucket."""
    root = tmp_path / "store"
    store = LocalFSObjectStore(root)
    rng = np.random.default_rng(0)
    for source in SOURCES:
        rows = ["image_id,image_key,row,col"]
        for image_id in ("a", "b"):
            key = f"s{source}/images/{image_id}.png"
            data = png_bytes(rng)
            if (source, image_id) == CORRUPT:
                data = data[: len(data) // 3]
            store.put_bytes(SRC, key, data)
            rows += [f"{image_id},{key},{r},{c}" for r, c in ((0, 0), (20, 30), (47, 63))]
        store.put_bytes(SRC, annotations_key(source), ("\n".join(rows) + "\n").encode())
    (tmp_path / "tiny.json").write_text(json.dumps(TINY))
    (tmp_path / "sources.csv").write_text("source_id\n" + "\n".join(SOURCES) + "\n")
    store_root_env(root)

    def run_yaml(device: str, target: str, entry=ENTRY) -> Path:
        path = tmp_path / f"run-{target}.yaml"
        path.write_text(textwrap.dedent(f"""\
            job:
              entrypoint: {entry}
              env: {{OBJECT_STORE_ROOT: "{root}"}}
            processing:
              container_args: [--source-bucket, {SRC}, --target-bucket, {target},
                               --backbone-config-json, "{tmp_path / 'tiny.json'}",
                               --error-log, "{tmp_path / target}-errors.csv",
                               --device, {device}]
              shard: {{items_csv: sources.csv, workers: 2}}
            """))
        return path

    return tmp_path, store, run_yaml


def launch(run_yaml: Path, run_id: str, log_dir: Path) -> subprocess.CompletedProcess:
    """``launch_processing`` as a user runs it, under a deadline of its own."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    return subprocess.run(
        [sys.executable, "-m", "mermaid_classifier_tpu_torch.scripts.launch_processing",
         "--run-config", str(run_yaml), "--run-id", run_id, "--log-dir", str(log_dir)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def features(store, bucket):
    out = {}
    for key in sorted(k for k in store.list_keys(bucket) if k.endswith(".features.npz")):
        rowcols, feats = read_feature_file(io.BytesIO(store.get_bytes(bucket, key)))
        out[key] = (rowcols.dtype.str, rowcols.tobytes(), feats.dtype.str, feats.tobytes())
    return out


def test_two_workers_equal_one_process_and_relaunch_writes_nothing(fanout):
    tmp, store, run_yaml = fanout
    path = run_yaml("cpu", "fanout")
    config = parse_run_config(path)
    # The shards are the JAX launcher's for the same YAML.
    want = [(r.name, r.command[2:]) for r in jlaunch.build_processing_requests(
        jcfg.parse_run_config(path), "itest")]
    assert [(r.name, r.command[2:]) for r in build_processing_requests(
        config, "itest")] == want
    assert [c[-1] for _, c in want] == ["1,3", "2,4"]

    backend = LocalProcessBackend(log_dir=tmp / "logs")
    job_ids = launch_processing(config, backend, "itest")
    try:
        statuses = wait_for_completion(backend, job_ids, poll_seconds=0.2,
                                       timeout_seconds=300)
    finally:
        backend.terminate_all()
    logs = {j: (tmp / "logs" / f"{j}.log").read_text() for j in job_ids}
    assert statuses == {"itest-w0-0": JobStatus.FAILED,
                        "itest-w1-1": JobStatus.COMPLETED}, logs
    assert "source 3 image b failed" in logs["itest-w0-0"]
    errors = (tmp / "fanout-errors.csv").read_text().splitlines()
    assert [line.split(",")[1:3] for line in errors[1:]] == [list(CORRUPT)]

    # The same sources in this process, one builder.
    rc = build_feature_bucket.main([
        "--source-ids", ",".join(SOURCES), "--source-bucket", SRC,
        "--target-bucket", "single", "--backbone-config-json",
        str(tmp / "tiny.json"), "--device", "cpu"])
    assert rc == 1
    single = features(store, "single")
    fanned = features(store, "fanout")
    n_images = len(SOURCES) * 2 - 1
    assert len(single) == n_images
    assert fanned == single
    for source in SOURCES:
        assert store.exists("fanout", feature_key(source, "a"))
    assert all(dtype == "<f4" for _, _, dtype, _ in fanned.values())

    # Relaunch through the CLI: every done image skipped, nothing rewritten.
    paths = {k: store._path("fanout", k) for k in fanned}
    mtimes = {k: p.stat().st_mtime_ns for k, p in paths.items()}
    assert launch(path, "itest", tmp / "logs2").returncode == 1
    assert {k: p.stat().st_mtime_ns for k, p in paths.items()} == mtimes
    assert features(store, "fanout") == fanned
    relaunched = [(tmp / "logs2" / f"itest-w{i}-{i}.log").read_text() for i in (0, 1)]
    for log, skipped, failed in zip(relaunched, (3, 4), (1, 0)):
        assert (f"0 images extracted (0 points), {skipped} skipped (already done),"
                f" {failed} failed") in log, log[-2000:]


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
def test_cuda_workers_without_a_card_fail_and_the_cli_exits_1(fanout):
    tmp, store, run_yaml = fanout
    assert launch(run_yaml("cuda", "nocard"), "nocard", tmp / "logs").returncode == 1
    for i in (0, 1):
        log = (tmp / "logs" / f"nocard-w{i}-{i}.log").read_text()
        assert "torch.cuda.is_available() is False" in log, log[-2000:]
    assert list(store.list_keys("nocard")) == []


def test_worker_entrypoint_runs_as_a_file_without_pythonpath(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(ENTRY), "--help"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--source-ids" in proc.stdout
