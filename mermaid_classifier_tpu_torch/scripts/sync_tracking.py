"""Remote tracking over the object store, through the port: push runs,
list them, pull one.

    python -m mermaid_classifier_tpu_torch.scripts.sync_tracking push --bucket reef-tracking
    python -m mermaid_classifier_tpu_torch.scripts.sync_tracking list --bucket reef-tracking
    python -m mermaid_classifier_tpu_torch.scripts.sync_tracking pull --bucket reef-tracking \\
        --experiment prod --run-id abc123 --dest ./tracking

Any machine with store access can browse and report on any run. Set
OBJECT_STORE_ROOT (a directory, or ``s3://`` with OBJECT_STORE_ENDPOINT,
AWS_REGION and the AWS_* credentials) to pick the store;
TRACKING_SYNC_BUCKET makes training runs push automatically at the end of
each run.
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger("sync_tracking")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    push = sub.add_parser("push", help="mirror the local tracking root up")
    push.add_argument("--bucket", required=True)
    push.add_argument("--tracking-root", default=None)
    push.add_argument("--no-skip-existing", action="store_true")

    lst = sub.add_parser("list", help="list remote experiments/runs")
    lst.add_argument("--bucket", required=True)

    pull = sub.add_parser("pull", help="materialize one remote run locally")
    pull.add_argument("--bucket", required=True)
    pull.add_argument("--experiment", required=True)
    pull.add_argument("--run-id", required=True)
    pull.add_argument("--dest", required=True)
    pull.add_argument("--overwrite", action="store_true")

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    from mermaid_classifier_tpu_torch.data.store import get_default_store
    from mermaid_classifier_tpu_torch.tracking import store_sync

    store = get_default_store()

    if args.command == "push":
        from mermaid_classifier_tpu_torch.tracking.local_tracker import (
            LocalTracker,
            get_default_tracker,
        )

        tracker = (
            LocalTracker(args.tracking_root)
            if args.tracking_root
            else get_default_tracker()
        )
        written = store_sync.sync_tracker_to_store(
            tracker, store, args.bucket,
            skip_existing=not args.no_skip_existing,
        )
        logger.info("pushed %d objects", len(written))
        return 0

    if args.command == "list":
        runs = store_sync.list_remote_runs(store, args.bucket)
        if not runs:
            logger.info("no remote runs under %s/tracking/", args.bucket)
        for experiment, run_ids in runs.items():
            print(f"{experiment}:")
            for run_id in run_ids:
                print(f"  {run_id}")
        return 0

    run = store_sync.pull_run_from_store(
        store, args.bucket, args.experiment, args.run_id, args.dest,
        overwrite=args.overwrite,
    )
    logger.info("pulled run %s (%d metrics)", run.run_id,
                len(run.latest_metrics()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
