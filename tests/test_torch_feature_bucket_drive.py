"""The port's kill-and-resume bulk drive (``scripts/feature_bucket_drive.py``
of the port) on the CPU at the JAX drive test's smoke size.

- The port's synthesizer writes the JAX package's corpus: the same JPEG
  bytes and ``annotations.csv`` objects, key for key, on the same seed.
- The drive (``--device cpu``: the tiny backbone over small images, 36
  images x 16 points over 3 sources, SIGKILL at 35%) proves its contract:
  ``ok``, the kill landed mid-run, featsB complete and identical to
  featsA, no rewrite, no failure, no ``.part`` file, and each build
  process's launch lines; run again on the same workdir with
  ``--skip-synthesize`` it reuses the corpus and clears both buckets
  (tests/test_feature_bucket_drive.py).
- ``verify_buckets`` flags a planted mismatch, a planted rewrite, a
  missing file and a stray ``.part`` file.
- ``process_launches`` reads a killed process's last per-image line.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from mermaid_classifier_tpu_torch.scripts import feature_bucket_drive as drive

REPO = Path(__file__).resolve().parents[1]
SMOKE_ARGS = ["--device", "cpu", "--images", "36", "--points", "16", "--sources", "3",
              "--kill-frac", "0.35"]


def _load_jax_drive():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_feature_bucket_drive", REPO / "scripts" / "feature_bucket_drive.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_the_corpus_is_the_jax_drives(tmp_path):
    jax_drive = _load_jax_drive()
    args = (36, 16, 3, drive.SMOKE_SIZES, 0)
    want = jax_drive.synthesize_corpus(tmp_path / "jax", *args)
    got = drive.synthesize_corpus(tmp_path / "port", *args)
    assert got == want
    jax_tree, port_tree = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert len(port_tree) == 36 + 3
    assert port_tree.keys() == jax_tree.keys()
    for key in port_tree:
        assert port_tree[key] == jax_tree[key], key
    assert drive.PRODUCTION_SIZES == jax_drive.PRODUCTION_SIZES
    assert drive.TINY_CONFIG == jax_drive.TINY_CONFIG


def _drive(workdir: Path, out: Path, *extra) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "mermaid_classifier_tpu_torch.scripts.feature_bucket_drive",
         *SMOKE_ARGS, "--workdir", str(workdir), "--output-json", str(out), *extra],
        cwd=REPO, env=dict(os.environ), capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, (
        f"--- stdout ---\n{proc.stdout[-4000:]}\n--- stderr ---\n{proc.stderr[-4000:]}")
    return json.loads(out.read_text())


def _assert_proof(record):
    assert record["ok"], record
    kr = record["kill_resume"]
    assert kr["killed_mid_run"] and kr["kill_signal"] == "SIGKILL"
    assert 1 <= kr["done_before_resume"] < record["images_total"]
    assert kr["featsB_complete"] and kr["identical_to_uninterrupted"]
    assert kr["rewrites_after_resume"] == 0
    assert kr["failures_logged"] == 0
    assert kr["stray_part_files"] == 0
    assert kr["resumed_images"] == 36 - kr["done_before_resume"]
    assert record["points_total"] == 36 * 16
    launches = record["kernel_launches"]
    # One launch line per image each process wrote; the kernels' plain
    # versions ran here, so the counts are 0.
    assert launches["uninterrupted"] == {"images_written": 36, "crop": 0,
                                         "fused_mbconv": 0, "closing_line": True}
    assert launches["resume"] == {"images_written": kr["resumed_images"], "crop": 0,
                                  "fused_mbconv": 0, "closing_line": True}
    killed = launches["killed"]
    assert killed["closing_line"] is False
    assert killed["images_written"] in (kr["done_before_resume"] - 1,
                                        kr["done_before_resume"])
    assert record["backbone"] == "tiny-cpu" and record["kernel_library"] is None
    assert record["device"]["type"] == "cpu"
    assert record["uninterrupted_stats"]["images_logged"] == 36
    assert record["resume_stats"]["images_logged"] == kr["resumed_images"]


def test_kill_resume_idempotence_smoke(tmp_path):
    workdir = tmp_path / "work"
    _assert_proof(_drive(workdir, tmp_path / "record.json"))
    # The same workdir again, the corpus reused: the buckets are cleared,
    # or the proof would be vacuous.
    rerun = _drive(workdir, tmp_path / "rerun.json", "--skip-synthesize")
    _assert_proof(rerun)
    assert rerun["stage_seconds"]["synthesize"] <= 5.0


def _write(path: Path, data: bytes) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)


@pytest.fixture
def buckets(tmp_path):
    """featsA and featsB of three equal feature files each."""
    for bucket in ("featsA", "featsB"):
        for i in range(3):
            _write(drive.features_dir(tmp_path, bucket) / "s1" / "features"
                   / f"i{i}.features.npz", f"features {i}".encode())
    return tmp_path


def test_verify_buckets_passes_equal_buckets(buckets):
    pre = drive.snapshot_tree(drive.features_dir(buckets, "featsB"))
    verdicts = drive.verify_buckets(buckets, pre, 3)
    assert verdicts["featsB_complete"] and verdicts["identical_to_uninterrupted"]
    assert (verdicts["rewrites_after_resume"], verdicts["stray_part_files"]) == (0, 0)


def test_verify_buckets_flags_mismatch_rewrite_missing_and_parts(buckets):
    b = drive.features_dir(buckets, "featsB") / "s1" / "features"
    pre = drive.snapshot_tree(drive.features_dir(buckets, "featsB"))
    (b / "i0.features.npz").write_bytes(b"other bytes")  # mismatch + rewrite
    st = (b / "i1.features.npz").stat()
    (b / "i1.features.npz").write_bytes(b"features 1")  # same bytes, rewritten
    os.utime(b / "i1.features.npz", ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    (b / "i2.features.npz").unlink()
    (b / "tmpabc.part").write_bytes(b"half")
    verdicts = drive.verify_buckets(buckets, pre, 3)
    assert not verdicts["featsB_complete"]
    assert not verdicts["identical_to_uninterrupted"]
    assert verdicts["mismatched_vs_uninterrupted"] == ["s1/features/i0.features.npz"]
    assert verdicts["missing_vs_uninterrupted"] == ["s1/features/i2.features.npz"]
    assert verdicts["rewritten_files"] == [
        "s1/features/i0.features.npz", "s1/features/i1.features.npz",
        "s1/features/i2.features.npz"]
    assert verdicts["rewrites_after_resume"] == 3
    assert verdicts["stray_part_files"] == 1


def test_process_launches_reads_the_last_written_image(tmp_path):
    log = tmp_path / "killed.log"
    log.write_text(
        "INFO device numerics check passed: min cosine 0.999900\n"
        "INFO image 00000 written (200 points); kernel launches so far: crop 1,"
        " fused_mbconv 33\n"
        "INFO image 00001 written (200 points); kernel launches so far: crop 2,"
        " fused_mbconv 55\n")
    assert drive.process_launches(log) == {
        "images_written": 2, "crop": 2, "fused_mbconv": 55, "closing_line": False}
    with log.open("a") as f:
        f.write("INFO kernel launches in this process: crop 2, fused_mbconv 55\n")
    assert drive.process_launches(log)["closing_line"] is True
