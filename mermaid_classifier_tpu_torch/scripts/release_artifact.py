"""Publish an immutable classifier release through the port. Exit 1 when
the release is refused (bad version, an existing version, an artifact that
fails validation, backbone weights without a fidelity record) or the
artifact is not found.

Usage:
    python -m mermaid_classifier_tpu_torch.scripts.release_artifact --version v3 \\
        --artifact models:/mermaid-mlp-prod \\
        --bucket mermaid-config [--extra-file efficientnet_weights.npz] \\
        [--device cuda]

The artifact is validated by loading it on ``--device`` (default cuda).
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger("release_artifact")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--version", required=True, help="vN, immutable")
    parser.add_argument(
        "--artifact",
        required=True,
        help="artifact dir, models:/<name>[/vN], or store://bucket/prefix",
    )
    parser.add_argument("--bucket", required=True)
    parser.add_argument("--extra-file", action="append", default=[])
    parser.add_argument("--tracker-root", default=None)
    parser.add_argument(
        "--fidelity-record", default=None,
        help="fidelity record JSON from python -m"
        " mermaid_classifier_tpu_torch.scripts.diff_backbone --record;"
        " REQUIRED when --extra-file ships backbone weights (.npz)",
    )
    parser.add_argument(
        "--allow-unverified-backbone", action="store_true",
        help="downgrade the missing-fidelity-record refusal to a loud"
        " warning (emergencies only)",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device the artifact is validated on"
                        " (default cuda)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    from mermaid_classifier_tpu_torch.data.store import get_default_store
    from mermaid_classifier_tpu_torch.serve.annotation import (
        resolve_classifier_artifact,
    )
    from mermaid_classifier_tpu_torch.serve.release import (
        ReleaseError,
        release_artifact,
    )

    try:
        artifact_dir = resolve_classifier_artifact(
            args.artifact, tracker_root=args.tracker_root
        )
        written = release_artifact(
            get_default_store(),
            args.bucket,
            args.version,
            artifact_dir,
            extra_files=args.extra_file,
            fidelity_record=args.fidelity_record,
            allow_unverified_backbone=args.allow_unverified_backbone,
            device=args.device,
        )
    except (ReleaseError, FileNotFoundError) as exc:
        logger.error("%s", exc)
        return 1
    logger.info("release complete: %s", ", ".join(written))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
