"""Shard fan-out and job lifecycle (reference analog:
scripts/launch_processing.py:59-250, launch_training.py:131-198).

The port's own copy of ``mermaid_classifier_tpu/jobs/launch.py``, without
pandas. Semantics preserved from the reference:

- items are round-robin chunked over workers (reference: :59-78) so early
  and late items spread evenly;
- each worker gets the shared container args plus
  ``<per_worker_arg> id1,id2,...`` (reference: :81-124);
- launch returns immediately; ``wait_for_completion`` polls every worker's
  status until all are terminal and reports failures (reference: :144-165);
- dry-run builds every request without submitting (reference: :214-224).

A worker is ``python <entrypoint> <args>`` (``backend.python_command``).
The port's job entrypoints (``scripts/build_feature_bucket.py``,
``scripts/train_job_entrypoint.py``) run as files as well as with ``-m``:
run as a file, each puts the repository root on ``sys.path`` itself, so a
worker needs no ``PYTHONPATH``.
"""

from __future__ import annotations

import time
from logging import getLogger
from pathlib import Path
from typing import Sequence

from mermaid_classifier_tpu_torch.jobs.backend import (
    JobBackend,
    JobRequest,
    JobStatus,
    python_command,
)
from mermaid_classifier_tpu_torch.jobs.launcher_config import RunConfig

logger = getLogger(__name__)


def chunk_items(items: Sequence[str], workers: int) -> list[list[str]]:
    """Round-robin chunking; empty chunks are dropped
    (reference: launch_processing.py:59-78)."""
    chunks: list[list[str]] = [[] for _ in range(workers)]
    for i, item in enumerate(items):
        chunks[i % workers].append(str(item))
    return [c for c in chunks if c]


def load_items(items_csv) -> list[str]:
    """Read the shard item list (auto-detect the id column) as the JAX
    package does, ``str`` of each value ``pd.read_csv`` gives: an int column
    "007" reads "7", a column with an empty field reads as floats ("7.0",
    "nan")."""
    from mermaid_classifier_tpu_torch.common.html_table import read_csv

    frame = read_csv(items_csv)

    def column(name: str) -> list[str]:
        values = frame.data[frame.columns.index(name)]
        return ["nan" if v is None else str(v) for v in values]

    for col in ("source_id", "source", "id", "item"):
        if col in frame.columns:
            return column(col)
    if len(frame.columns) == 1:
        return column(frame.columns[0])
    raise ValueError(
        f"cannot find an item column in {items_csv}; has {list(frame.columns)}"
    )


def build_processing_requests(
    config: RunConfig, run_id: str
) -> list[JobRequest]:
    """Build one JobRequest per shard worker."""
    if config.processing is None:
        raise ValueError("run config has no processing: block.")
    shard = config.processing.shard
    items = load_items(config.resolve_sibling(shard.items_csv))
    chunks = chunk_items(items, shard.workers)
    requests = []
    for worker_idx, chunk in enumerate(chunks):
        args = [
            *config.processing.container_args,
            shard.per_worker_arg,
            ",".join(chunk),
        ]
        requests.append(
            JobRequest(
                name=f"{run_id}-w{worker_idx}",
                command=python_command(config.job.entrypoint, args),
                env=dict(config.job.env),
                tags={**config.job.tags, "run_id": run_id,
                      "worker": str(worker_idx)},
            )
        )
    return requests


def build_training_request(config: RunConfig, run_id: str) -> JobRequest:
    if config.training is None:
        raise ValueError("run config has no training: block.")
    config_dir = config.resolve_sibling(config.training.config_dir)
    args = [
        "--config-dir", str(config_dir),
        "--config-name", config.training.config_name,
        *config.training.container_args,
    ]
    return JobRequest(
        name=f"{run_id}-train",
        command=python_command(config.job.entrypoint, args),
        env=dict(config.job.env),
        tags={**config.job.tags, "run_id": run_id},
    )


def stage_config_dir(
    store, bucket: str, run_id: str, config_dir
) -> list[str]:
    """Copy the run's config dir into the store under
    ``runs/<run_id>/config/`` so remote workers fetch the exact bytes the
    launcher validated (reference: launch_processing.py:168-175). Returns
    the written keys."""
    config_dir = Path(config_dir)
    if not config_dir.is_dir():
        raise FileNotFoundError(f"config dir {config_dir} does not exist.")
    written = []
    for path in sorted(p for p in config_dir.rglob("*") if p.is_file()):
        key = f"runs/{run_id}/config/{path.relative_to(config_dir)}"
        store.put_bytes(bucket, key, path.read_bytes())
        written.append(key)
    if not written:
        raise ValueError(f"config dir {config_dir} is empty.")
    return written


def launch_processing(
    config: RunConfig,
    backend: JobBackend,
    run_id: str,
    *,
    dry_run: bool = False,
) -> list[str]:
    """Submit the shard fan-out; returns job ids (empty for dry-run)."""
    requests = build_processing_requests(config, run_id)
    if dry_run:
        for r in requests:
            logger.info("[dry-run] %s: %s", r.name, " ".join(r.command))
        return []
    return [backend.submit(r) for r in requests]


def launch_training(
    config: RunConfig,
    backend: JobBackend,
    run_id: str,
    *,
    dry_run: bool = False,
) -> list[str]:
    request = build_training_request(config, run_id)
    if dry_run:
        logger.info("[dry-run] %s: %s", request.name, " ".join(request.command))
        return []
    return [backend.submit(request)]


def wait_for_completion(
    backend: JobBackend,
    job_ids: list[str],
    *,
    poll_seconds: float = 2.0,
    timeout_seconds: float = 24 * 3600,
) -> dict[str, JobStatus]:
    """Poll every job to a terminal status
    (reference: launch_processing.py:144-165). Returns {job_id: status};
    raises TimeoutError past the deadline."""
    deadline = time.monotonic() + timeout_seconds
    statuses: dict[str, JobStatus] = {}
    pending = set(job_ids)
    while pending:
        for job_id in sorted(pending):
            status = backend.describe(job_id)
            if status.terminal:
                statuses[job_id] = status
                logger.info("job %s -> %s", job_id, status.value)
        pending -= set(statuses)
        if not pending:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"jobs still running past {timeout_seconds}s: {sorted(pending)}"
            )
        time.sleep(poll_seconds)
    failed = [j for j, s in statuses.items() if s is JobStatus.FAILED]
    if failed:
        logger.error("%d/%d jobs failed: %s", len(failed), len(job_ids), failed)
    return statuses
