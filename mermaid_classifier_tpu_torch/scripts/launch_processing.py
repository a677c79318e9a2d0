"""Launch the sharded extraction fan-out from a run YAML
(reference analog: scripts/launch_processing.py:178-254).

Usage:
    python -m mermaid_classifier_tpu_torch.scripts.launch_processing \\
        --run-config mermaid_classifier_tpu_torch/jobs/processing_run.yaml \\
        [--run-id my-run] [--dry-run] [--log-dir logs/] \\
        [--backend {local,k8s}] [--no-wait] [--staging-bucket BUCKET]

Each worker is ``python <job.entrypoint> <container_args> <per_worker_arg>
id1,id2,...``; with the local backend every worker is a subprocess on this
host, and several of them share its CUDA card. Exit code 1 when any worker
failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time

logger = logging.getLogger("launch_processing")


def add_launch_args(parser: argparse.ArgumentParser, what: str) -> None:
    """The flags both launchers share."""
    parser.add_argument("--run-config", required=True)
    parser.add_argument("--run-id", default=None)
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--log-dir", default=None)
    parser.add_argument(
        "--backend", choices=("local", "k8s"), default="local",
        help="local = subprocess workers on this host; k8s = one"
        " Kubernetes Job per worker via kubectl (requires a"
        " job.cluster: block in the run YAML)",
    )
    parser.add_argument(
        "--staging-bucket", default=None,
        help=f"stage the {what} dir into the store under"
        " runs/<run-id>/config/ before submitting",
    )


def make_backend(args, config):
    """The backend ``--backend`` names: local subprocesses (tee'd to
    ``--log-dir``) or Kubernetes Jobs from the YAML's ``job.cluster``."""
    from mermaid_classifier_tpu_torch.jobs import LocalProcessBackend

    if args.backend != "k8s":
        return LocalProcessBackend(log_dir=args.log_dir)
    from mermaid_classifier_tpu_torch.jobs.kubernetes import (
        ClusterSpec,
        KubernetesJobBackend,
    )

    if config.job.cluster is None:
        raise SystemExit("--backend k8s needs a job.cluster: block in the run YAML")
    return KubernetesJobBackend(ClusterSpec(**dataclasses.asdict(config.job.cluster)))


def stage(args, run_id: str, config_dir) -> None:
    """Copy ``config_dir`` into ``--staging-bucket`` of the default store."""
    from mermaid_classifier_tpu_torch.data.store import get_default_store
    from mermaid_classifier_tpu_torch.jobs.launch import stage_config_dir

    written = stage_config_dir(get_default_store(), args.staging_bucket, run_id,
                               config_dir)
    logger.info("staged %d config files to %s", len(written), args.staging_bucket)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_launch_args(parser, "run config")
    parser.add_argument("--no-wait", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    from mermaid_classifier_tpu_torch.jobs import (
        JobStatus,
        launch_processing,
        parse_run_config,
        wait_for_completion,
    )

    config = parse_run_config(args.run_config, strict=True)
    run_id = args.run_id or f"extract-{int(time.time())}"
    if args.staging_bucket:
        stage(args, run_id, config.config_dir)
    backend = make_backend(args, config)
    job_ids = launch_processing(config, backend, run_id, dry_run=args.dry_run)
    if args.dry_run:
        return 0
    logger.info("submitted %d workers", len(job_ids))
    if args.no_wait:
        return 0
    statuses = wait_for_completion(backend, job_ids)
    return 0 if all(s is JobStatus.COMPLETED for s in statuses.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
