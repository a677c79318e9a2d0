"""Classify one image's annotated points and write the predictions through
the port (extractor and head on a CUDA card by default).

Usage:
    python -m mermaid_classifier_tpu_torch.scripts.annotate_image \\
        --image reef.jpg --points points.csv --classifier artifact_dir/ \\
        [--output-dir out/] [--top-n 3] [--backbone-weights weights.npz] \\
        [--device cuda]

``--image`` is a local path, ``store://bucket/key`` or a numeric CoralNet
image ID. Without ``--output-dir`` the predictions are written back into
the points CSV; with it, ``predictions.csv``, ``summary.json`` and the
marker overlay ``overlay.png`` go there. Where matplotlib does not import,
the overlay is not written, a warning on stderr says so, and the exit code
is still 0: the predictions are the result, the overlay a view of them.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

logger = logging.getLogger("annotate_image")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--image", required=True,
                        help="local path, store://bucket/key, or a numeric"
                        " CoralNet image ID")
    parser.add_argument("--coralnet-cache-dir", default=None,
                        help="cache dir for CoralNet-ID image downloads")
    parser.add_argument("--points", required=True)
    parser.add_argument("--classifier", required=True,
                        help="artifact dir or store://bucket/prefix")
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--top-n", type=int, default=3)
    parser.add_argument("--backbone-weights", default=None)
    parser.add_argument(
        "--backbone-padding", default=None, choices=("symmetric", "tf_same"),
        help="conv padding semantics; pyspacer-lineage weights need tf_same",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device of the extractor and head"
                        " (default cuda)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    from mermaid_classifier_tpu_torch.models.efficientnet import EfficientNetConfig
    from mermaid_classifier_tpu_torch.models.extractor import build_extractor
    from mermaid_classifier_tpu_torch.serve.annotation import (
        AnnotationRun,
        write_run_report,
    )
    from mermaid_classifier_tpu_torch.serve.image_sources import ImageFetcher

    weights = None
    config = None
    if args.backbone_weights:
        from mermaid_classifier_tpu_torch.models.convert import load_backbone_bundle

        # The sidecar carries the padding/bn_eps decided at conversion
        # time; --backbone-padding stays as an override.
        weights, config = load_backbone_bundle(args.backbone_weights)
        if config is not None:
            logger.info("backbone sidecar config: padding=%s bn_eps=%g",
                        config.padding, config.bn_eps)
    if args.backbone_padding is not None:
        config = dataclasses.replace(
            config or EfficientNetConfig(), padding=args.backbone_padding
        )
    extractor = build_extractor(weights, config=config, device=args.device)

    run = AnnotationRun(
        args.image,
        args.points,
        args.classifier,
        extractor=extractor,
        top_n=args.top_n,
        fetcher=ImageFetcher(cache_dir=args.coralnet_cache_dir),
    )
    if args.output_dir:
        out = write_run_report(run, args.output_dir)
        logger.info("wrote %s", out)
    else:
        run.write_predictions()
        logger.info("wrote predictions back to %s", args.points)
    summary = run.summary()
    logger.info("%d points: %s", summary["n_points"], summary["label_counts"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
