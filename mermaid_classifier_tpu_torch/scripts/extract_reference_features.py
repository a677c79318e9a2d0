"""Stack per-image feature files into one (N, D) float32 ``.npy`` fixture,
for the live parity gate of the fidelity runbook.

Reads the port's ``.features.npz`` files or the legacy JSON
``.featurevector`` layout, in the order given, and refuses an empty output.

Usage:
    python -m mermaid_classifier_tpu_torch.scripts.extract_reference_features \\
        --output fixtures/reference_features.npy file1.features.npz file2...
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

logger = logging.getLogger("extract_reference_features")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--output", required=True)
    parser.add_argument("feature_files", nargs="+")
    parser.add_argument("--max-rows", type=int, default=None)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    import numpy as np

    from mermaid_classifier_tpu_torch.data.features_io import (
        read_feature_file,
        read_legacy_featurevector_json,
    )

    blocks = []
    for path in args.feature_files:
        path = Path(path)
        if not path.is_file():
            logger.error("missing feature file: %s", path)
            return 1
        if path.suffix == ".npz" or path.name.endswith(".features.npz"):
            _, features = read_feature_file(path)
        else:
            _, features = read_legacy_featurevector_json(path)
        blocks.append(np.asarray(features, dtype=np.float32))

    stacked = np.vstack(blocks)
    if args.max_rows:
        stacked = stacked[: args.max_rows]
    if stacked.size == 0:
        logger.error("refusing to write an empty fixture")
        return 1
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.save(out, stacked)
    logger.info("wrote %s: shape %s", out, stacked.shape)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
