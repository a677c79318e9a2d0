"""Classify extracted feature files in bulk and write a predictions CSV
through the port's predictor (its head on a CUDA card by default).

Usage:
    python -m mermaid_classifier_tpu_torch.scripts.predict_features \\
        --classifier artifact_dir/ \\
        --output predictions.csv [--top-n 3] [--device cuda] \\
        features/i001.features.npz features/i002.features.npz ...

``--classifier`` is a local artifact directory or ``store://bucket/prefix``
(from the store named by ``OBJECT_STORE_ROOT``).

``--mesh-devices N`` shards the head's batches over N devices, one process
per device, every process given the same files; rank 0 writes the CSV:

    torchrun --nproc-per-node N -m mermaid_classifier_tpu_torch.scripts.predict_features \
        --mesh-devices N --classifier ... --output ... features/*.npz
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger("predict_features")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--classifier", required=True,
                        help="artifact dir or store://bucket/prefix")
    parser.add_argument("--output", required=True, help="predictions CSV path")
    parser.add_argument("--top-n", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=4096)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the head (default cuda)")
    parser.add_argument("--mesh-devices", type=int, default=None,
                        help="shard the head batch over an N-device mesh, one"
                        " process per device under torchrun (default: single"
                        " device)")
    parser.add_argument("feature_files", nargs="+",
                        help="*.features.npz (rowcols+features) or bare"
                        " (P, D) *.npy matrices")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    from mermaid_classifier_tpu_torch.inference.loader import load_predictor
    from mermaid_classifier_tpu_torch.parallel.mesh import cli_mesh
    from mermaid_classifier_tpu_torch.parallel.sharded_serve import (
        load_sharded_predictor,
    )
    from mermaid_classifier_tpu_torch.serve.annotation import (
        resolve_classifier_artifact,
    )
    from mermaid_classifier_tpu_torch.serve.batch_predict import (
        predict_feature_files,
        write_predictions_csv,
    )

    with cli_mesh(args.mesh_devices, device=args.device,
                  command="mermaid_classifier_tpu_torch.scripts.predict_features"
                  ) as mesh:
        artifact = resolve_classifier_artifact(args.classifier)
        if mesh is not None:
            predictor = load_sharded_predictor(artifact, mesh)
            logger.info("serving over a %d-device mesh", mesh.size)
        else:
            predictor = load_predictor(artifact, device=args.device)
        logger.info(
            "classifier %s: %d classes, input_dim %d",
            artifact, len(predictor.classes), predictor.input_dim,
        )
        rows = predict_feature_files(
            predictor, args.feature_files,
            top_n=args.top_n, batch_size=args.batch_size,
        )
    if mesh is None or mesh.rank == 0:
        write_predictions_csv(rows, args.output, top_n=args.top_n)
        logger.info(
            "%d points from %d files -> %s",
            len(rows), len(args.feature_files), args.output,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
