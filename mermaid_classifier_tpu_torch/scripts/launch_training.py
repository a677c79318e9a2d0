"""Launch a training job from a run YAML
(reference analog: scripts/launch_training.py:131-203).

Usage:
    python -m mermaid_classifier_tpu_torch.scripts.launch_training \\
        --run-config runs/train.yaml \\
        [--run-id my-run] [--dry-run] [--log-dir logs/] \\
        [--backend {local,k8s}] [--staging-bucket BUCKET]

The job is ``python <job.entrypoint> --config-dir <training.config_dir>
--config-name <training.config_name> <container_args>``. Exit code 1 when
the job failed.
"""

from __future__ import annotations

import argparse
import logging
import time

from mermaid_classifier_tpu_torch.scripts.launch_processing import (
    add_launch_args,
    make_backend,
    stage,
)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_launch_args(parser, "training config")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    from mermaid_classifier_tpu_torch.jobs import (
        JobStatus,
        launch_training,
        parse_run_config,
        wait_for_completion,
    )

    config = parse_run_config(args.run_config, strict=True)
    run_id = args.run_id or f"train-{int(time.time())}"
    if args.staging_bucket:
        stage(args, run_id, config.resolve_sibling(
            config.training.config_dir if config.training else "."))
    backend = make_backend(args, config)
    job_ids = launch_training(config, backend, run_id, dry_run=args.dry_run)
    if args.dry_run:
        return 0
    statuses = wait_for_completion(backend, job_ids)
    return 0 if all(s is JobStatus.COMPLETED for s in statuses.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
