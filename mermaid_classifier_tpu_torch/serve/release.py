"""Immutable artifact releases: validate, lay out, publish ``vN``.

The port's own copy of ``mermaid_classifier_tpu/serve/release.py``:

- version names are strictly ``v<digits>``;
- a release is IMMUTABLE: publishing over an existing version is refused
  before any byte is written;
- the artifact is re-validated at release time (loaded through the port's
  ``load_predictor`` on ``device``, "cuda" unless the caller passes
  another, then the manifest's task, classes and provenance checked): a
  release never trusts that training-time validation still holds;
- backbone weights ship only with a fidelity record that names their
  sha256 (``validate_fidelity_record``);
- the store layout is assembled with best-effort rollback on failure.

Layout: ``<bucket>/classifier/<version>/model.npz|model.json`` plus any
extra files (e.g. backbone weights) passed alongside. The artifact format
and its task name are the JAX package's, so either package releases and
serves the other's artifacts.
"""

from __future__ import annotations

import json
import re
from logging import getLogger
from pathlib import Path

from mermaid_classifier_tpu_torch.data.store import ObjectStore
from mermaid_classifier_tpu_torch.inference import (
    SCHEMA_VERSION,
    TASK_NAME,
    ManifestError,
    load_predictor,
)

logger = getLogger(__name__)

_VERSION_RE = re.compile(r"^v\d+$")
RELEASE_PREFIX = "classifier"


class ReleaseError(RuntimeError):
    pass


def validate_version(version: str) -> None:
    if not _VERSION_RE.fullmatch(version):
        raise ReleaseError(
            f"release version must match ^v<digits>$, got {version!r}."
        )


def validate_artifact(
    artifact_dir: str | Path, *, task: str = TASK_NAME, device="cuda"
) -> dict:
    """Load + inspect an artifact directory; returns the manifest.

    Checks: loadable through the one public loader on ``device``; schema
    version; task name; non-empty classes; provenance block present.
    """
    artifact_dir = Path(artifact_dir)
    try:
        load_predictor(artifact_dir, device=device)
    except ManifestError as exc:
        raise ReleaseError(f"artifact failed load validation: {exc}") from exc
    manifest = json.loads((artifact_dir / "model.json").read_text())
    if manifest.get("schema_version") != SCHEMA_VERSION:
        raise ReleaseError(
            f"manifest schema_version {manifest.get('schema_version')!r} !="
            f" {SCHEMA_VERSION}."
        )
    if manifest.get("task") != task:
        raise ReleaseError(
            f"manifest task {manifest.get('task')!r} != expected {task!r}."
        )
    if not manifest.get("classes"):
        raise ReleaseError("manifest has no classes.")
    if not manifest.get("trained_with"):
        raise ReleaseError(
            "manifest has no trained_with provenance block; refusing to"
            " release an artifact of unknown origin."
        )
    return manifest


def _sha256(path: Path) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def validate_fidelity_record(
    record_path: str | Path, backbone_files: list[Path]
) -> dict:
    """A fidelity record is the committed proof that the SHIPPED backbone
    weights reproduce the reference extractor (written by ``python -m
    mermaid_classifier_tpu_torch.scripts.diff_backbone --record``; the
    runbook is in README.md). Checks: the record parses, declares
    ``all_green``, carries a feature MAE within its own gate, and its
    weights hash matches every backbone npz being released: a record for
    DIFFERENT weights is not a proof of these."""
    record_path = Path(record_path)
    try:
        record = json.loads(record_path.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        raise ReleaseError(
            f"fidelity record {record_path} is unreadable: {exc}"
        ) from exc
    for field in ("all_green", "feature_mae", "feature_tol", "weights_sha256"):
        if field not in record:
            raise ReleaseError(
                f"fidelity record {record_path} is missing {field!r};"
                " regenerate it with python -m"
                " mermaid_classifier_tpu_torch.scripts.diff_backbone --record."
            )
    if not record["all_green"]:
        raise ReleaseError(
            f"fidelity record {record_path} records a FAILED diff"
            " (all_green=false); the backbone does not reproduce the"
            " reference features."
        )
    if record["feature_mae"] > record["feature_tol"]:
        raise ReleaseError(
            f"fidelity record {record_path} has feature_mae"
            f" {record['feature_mae']} above its own tolerance"
            f" {record['feature_tol']}."
        )
    for f in backbone_files:
        if _sha256(f) != record["weights_sha256"]:
            raise ReleaseError(
                f"fidelity record {record_path} was produced for different"
                f" weights (sha256 mismatch vs {f.name}); re-run the"
                " fidelity runbook against the file being released."
            )
    return record


def _backbone_weight_files(extra_files: list[Path]) -> list[Path]:
    """The backbone npz bundles among the extra release files (the
    .config.json sidecar and other payloads don't need a fidelity proof
    of their own)."""
    return [f for f in extra_files if f.suffix == ".npz"]


def release_artifact(
    store: ObjectStore,
    bucket: str,
    version: str,
    artifact_dir: str | Path,
    *,
    extra_files: list[str | Path] | None = None,
    task: str = TASK_NAME,
    fidelity_record: str | Path | None = None,
    allow_unverified_backbone: bool = False,
    device="cuda",
) -> list[str]:
    """Publish ``artifact_dir`` as the immutable ``version`` release.

    Returns the list of written keys. On any write failure, best-effort
    deletes everything already written. The artifact is validated by
    loading it on ``device``.

    When the release ships backbone weights (an ``.npz`` among
    ``extra_files``), a ``fidelity_record`` is REQUIRED: the JSON written by
    ``python -m mermaid_classifier_tpu_torch.scripts.diff_backbone
    --save-npz <npz> --record <json>`` (the fidelity runbook, README.md),
    proving those exact weights reproduce the reference extractor. ``allow_unverified_backbone=True`` downgrades
    the refusal to a loud warning, for emergencies only.
    """
    validate_version(version)
    artifact_dir = Path(artifact_dir)
    manifest = validate_artifact(artifact_dir, task=task, device=device)

    files: list[Path] = [artifact_dir / "model.npz", artifact_dir / "model.json"]
    for f in extra_files or []:
        f = Path(f)
        if not f.is_file():
            raise ReleaseError(f"extra release file {f} does not exist.")
        files.append(f)

    backbone_files = _backbone_weight_files(
        [Path(f) for f in extra_files or []]
    )
    if backbone_files:
        if fidelity_record is not None:
            record = validate_fidelity_record(fidelity_record, backbone_files)
            logger.info(
                "backbone fidelity record verified: feature_mae=%s"
                " (tol %s), padding=%s",
                record["feature_mae"], record["feature_tol"],
                record.get("padding"),
            )
        elif allow_unverified_backbone:
            logger.warning(
                "RELEASING UNVERIFIED BACKBONE WEIGHTS %s: no fidelity"
                " record was provided. The <1e-4 feature-MAE contract is"
                " UNPROVEN for this release — run the fidelity runbook"
                " (mermaid_classifier_tpu_torch.scripts.diff_backbone"
                " --record) as soon as possible.",
                [f.name for f in backbone_files],
            )
        else:
            raise ReleaseError(
                f"release ships backbone weights"
                f" {[f.name for f in backbone_files]} but no fidelity"
                " record. Run the runbook (python -m"
                " mermaid_classifier_tpu_torch.scripts.diff_backbone"
                " --padding auto --save-npz <npz> --record fidelity.json, then"
                " the live extractor gate) and pass fidelity_record=, or"
                " explicitly set allow_unverified_backbone=True."
            )

    # Trailing slash: "classifier/v1" must not prefix-match "classifier/v12".
    prefix = f"{RELEASE_PREFIX}/{version}/"
    existing = list(store.list_keys(bucket, prefix=prefix))
    if existing:
        raise ReleaseError(
            f"release {version} already exists in {bucket} ({len(existing)}"
            f" objects under {prefix}) — releases are immutable."
        )

    written: list[str] = []
    try:
        for f in files:
            key = f"{prefix}{f.name}"
            store.put_bytes(bucket, key, f.read_bytes())
            written.append(key)
    except BaseException:
        logger.exception(
            "release %s failed mid-write; rolling back %d objects",
            version,
            len(written),
        )
        for key in written:
            try:
                store.delete(bucket, key)
            except Exception:  # noqa: BLE001 - rollback is best-effort
                logger.warning("rollback failed for %s/%s", bucket, key)
        raise

    logger.info(
        "released %s: %d files, %d classes, task=%s",
        version,
        len(written),
        len(manifest["classes"]),
        manifest["task"],
    )
    return written
