"""Generate a self-contained HTML report for a tracked run, through the
port (no pandas, no matplotlib). Exit 1 when the run is not found.

Usage:
    python -m mermaid_classifier_tpu_torch.scripts.generate_report \\
        --run-id RUN_ID [--tracking-root runs/] [--output report.html]
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger("generate_report")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--run-id", required=True)
    parser.add_argument("--tracking-root", default=None)
    parser.add_argument("--output", default=None)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    from mermaid_classifier_tpu_torch.tracking.local_tracker import (
        LocalTracker,
        get_default_tracker,
    )
    from mermaid_classifier_tpu_torch.tracking.report import generate_report

    tracker = (
        LocalTracker(args.tracking_root) if args.tracking_root
        else get_default_tracker()
    )
    try:
        run = tracker.get_run(args.run_id)
    except KeyError as exc:
        logger.error("%s", exc)
        return 1
    output = args.output or f"report_{args.run_id}.html"
    path = generate_report(run, output)
    logger.info("wrote %s", path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
