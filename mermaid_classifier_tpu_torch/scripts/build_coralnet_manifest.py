"""Build the per-point CoralNet training manifest through the port.

Joins the ETL annotation parquet against the ETL image parquet and writes
the manifest the training dataset reads: logs the build summary, runs the
audit warning pass, and refuses to write an empty manifest. Exit 1 on
audit warnings (unless ``--allow-warnings``) or an empty manifest.

Usage:
    python -m mermaid_classifier_tpu_torch.scripts.build_coralnet_manifest \\
        --annotations-parquet etl/annotations.parquet \\
        --images-parquet etl/images.parquet \\
        --output manifests/manifest.parquet
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger(__name__)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--annotations-parquet", required=True)
    parser.add_argument("--images-parquet", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument(
        "--allow-warnings",
        action="store_true",
        help="write the manifest even when the audit pass finds issues",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    from mermaid_classifier_tpu_torch.coralnet.manifest import (
        audit_manifest,
        build_manifest,
        write_manifest,
    )

    manifest, summary = build_manifest(
        args.annotations_parquet, args.images_parquet
    )
    logger.info("Build summary: %s", summary.describe())

    warnings = audit_manifest(manifest)
    for w in warnings:
        logger.warning("audit: %s", w)
    if warnings and not args.allow_warnings:
        logger.error(
            "Refusing to write manifest with %d audit warnings"
            " (pass --allow-warnings to override).",
            len(warnings),
        )
        return 1

    try:
        write_manifest(manifest, args.output)
    except ValueError as exc:
        logger.error("%s", exc)
        return 1
    logger.info("Wrote %s rows to %s", f"{len(manifest):,}", args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
