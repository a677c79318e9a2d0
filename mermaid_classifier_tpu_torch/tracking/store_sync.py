"""Remote tracking over the object store: the tracking-server analog.

The port's own copy of ``mermaid_classifier_tpu/tracking/store_sync.py``,
with the same key layout, so either package pulls the other's runs. The
shared plane for everything at scale is the object store, so remote
tracking mirrors the local tracker's file tree into a bucket after a run,
and materializes it back on any other machine. No server process and no
new transport: it works against the local-FS store, the stdlib-HTTP S3
backend, or anything behind the ObjectStore interface.

Key layout in the bucket (mirrors the local tree 1:1):

    tracking/<experiment>/<run_id>/meta.json | params.json | metrics/... | artifacts/...
    tracking/_models/<name>/v<N>/...

Sync is idempotent at (bucket, key): re-running uploads the same bytes to
the same keys; `skip_existing` skips keys already present (runs are
append-only once FINISHED). Pull never overwrites a local run dir that
already exists unless told to.
"""

from __future__ import annotations

from logging import getLogger
from pathlib import Path

from mermaid_classifier_tpu_torch.data.store import ObjectStore

logger = getLogger(__name__)

TRACKING_PREFIX = "tracking"


def _iter_files(root: Path):
    for path in sorted(p for p in root.rglob("*") if p.is_file()):
        yield path, str(path.relative_to(root)).replace("\\", "/")


def sync_run_to_store(
    run,
    store: ObjectStore,
    bucket: str,
    *,
    prefix: str = TRACKING_PREFIX,
    skip_existing: bool = True,
) -> list[str]:
    """Mirror one run directory into the store; returns written keys."""
    base = f"{prefix}/{run.run_dir.parent.name}/{run.run_dir.name}"
    written = []
    for path, rel in _iter_files(run.run_dir):
        key = f"{base}/{rel}"
        if skip_existing and store.exists(bucket, key):
            continue
        store.put_bytes(bucket, key, path.read_bytes())
        written.append(key)
    logger.info("synced run %s: %d objects -> %s/%s", run.run_dir.name,
                len(written), bucket, base)
    return written


def sync_tracker_to_store(
    tracker,
    store: ObjectStore,
    bucket: str,
    *,
    prefix: str = TRACKING_PREFIX,
    skip_existing: bool = True,
) -> list[str]:
    """Mirror the whole tracking root (all experiments, runs, and the model
    registry) into the store."""
    root = Path(tracker.root)
    written = []
    for path, rel in _iter_files(root):
        key = f"{prefix}/{rel}"
        if skip_existing and store.exists(bucket, key):
            continue
        store.put_bytes(bucket, key, path.read_bytes())
        written.append(key)
    logger.info("synced tracking root: %d objects -> %s/%s", len(written),
                bucket, prefix)
    return written


def sync_registry_to_store(
    tracker,
    store: ObjectStore,
    bucket: str,
    *,
    prefix: str = TRACKING_PREFIX,
    skip_existing: bool = True,
) -> list[str]:
    """Mirror only the model registry (``_models/``) — what a finished run
    adds beyond its own run dir. Registered versions are immutable, so
    skip_existing makes this O(new version), not O(history)."""
    registry = Path(tracker.root) / "_models"
    if not registry.is_dir():
        return []
    written = []
    for path, rel in _iter_files(registry):
        key = f"{prefix}/_models/{rel}"
        if skip_existing and store.exists(bucket, key):
            continue
        store.put_bytes(bucket, key, path.read_bytes())
        written.append(key)
    return written


def pull_run_from_store(
    store: ObjectStore,
    bucket: str,
    experiment: str,
    run_id: str,
    dest_root: str | Path,
    *,
    prefix: str = TRACKING_PREFIX,
    overwrite: bool = False,
):
    """Materialize a remote run locally; returns a Run over the pulled dir
    (usable by the report generator and metrics readers)."""
    from mermaid_classifier_tpu_torch.tracking.local_tracker import LocalTracker

    dest_root = Path(dest_root)
    run_dir = dest_root / experiment / run_id
    if run_dir.exists() and not overwrite:
        raise FileExistsError(
            f"{run_dir} already exists; pass overwrite=True to refresh it."
        )
    remote_prefix = f"{prefix}/{experiment}/{run_id}/"
    keys = list(store.list_keys(bucket, prefix=remote_prefix))
    if not keys:
        raise FileNotFoundError(
            f"no run objects under {bucket}/{remote_prefix}"
        )
    for key in keys:
        rel = key[len(remote_prefix):]
        target = run_dir / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_bytes(store.get_bytes(bucket, key))
    logger.info("pulled %d objects -> %s", len(keys), run_dir)
    return LocalTracker(dest_root).get_run(run_id)


def list_remote_runs(
    store: ObjectStore, bucket: str, *, prefix: str = TRACKING_PREFIX
) -> dict[str, list[str]]:
    """{experiment: [run_id, ...]} discovered from the bucket listing."""
    out: dict[str, set] = {}
    marker = "/meta.json"
    for key in store.list_keys(bucket, prefix=f"{prefix}/"):
        if not key.endswith(marker):
            continue
        parts = key[len(prefix) + 1: -len(marker)].split("/")
        if len(parts) != 2 or parts[0] == "_models":
            continue
        out.setdefault(parts[0], set()).add(parts[1])
    return {exp: sorted(runs) for exp, runs in sorted(out.items())}
