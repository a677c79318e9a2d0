"""Build a feature bucket: at-scale, resumable point-feature extraction on
the port's extractor (the crop and fused-MBConv kernels on a CUDA card).

Usage:
    python -m mermaid_classifier_tpu_torch.scripts.build_feature_bucket \\
        --source-ids 1,2,3            # or --source-ids-csv sources.csv \\
        --source-bucket reef-images --target-bucket reef-features \\
        [--no-skip-existing] [--verify-numerics] \\
        [--progress-log progress.jsonl] [--error-log errors.csv] \\
        [--backbone-weights weights.npz] [--device cuda]

The store is the local-filesystem root named by ``OBJECT_STORE_ROOT``.
``--device`` defaults to ``cuda`` (it raises without a card; ``--device
cpu`` runs the kernels' plain versions). The script also runs as a file
(``python mermaid_classifier_tpu_torch/scripts/build_feature_bucket.py``),
which is how a job launcher starts its workers. A trunk in any dtype but float32
always runs the device-numerics gate first. Exit code 1 when any image
failed or no requested source is available.

``--mesh-devices N`` shards the trunk's batch over N devices, one process
per device (``torchrun --nproc-per-node N -m
mermaid_classifier_tpu_torch.scripts.build_feature_bucket --mesh-devices N
...``), every process reading the same images; rank 0 writes the features,
the annotations copy and the logs. Without ``--backbone-impl`` the mesh
runs ``folded`` (``fused`` is single-device and raises with a mesh).
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import logging
import re
import sys
from pathlib import Path

if not __package__:
    # Run as a file (a job's entrypoint, ``python <path> ...``): the
    # repository root onto the path, as ``-m`` from the root would have it.
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

logger = logging.getLogger("build_feature_bucket")

# Only the float64-column artifact of a spreadsheet export: digits + ".0".
_FLOAT_ARTIFACT_RE = re.compile(r"^(\d+)\.0$")


def parse_source_ids(args) -> list[str]:
    """Source IDs from --source-ids or a CSV with a source-id column
    (auto-detected, or named by --source-id-column). Both routes normalize
    the same way: whitespace stripped, blanks dropped, "123.0" read as
    "123", duplicates dropped in order. Every cell is read as a string, so
    "NA", "007", "5e2" and "123.5" are IDs as written."""
    if args.source_ids:
        return _normalize_source_ids(
            s.strip() for s in args.source_ids.split(",")
        )
    with open(args.source_ids_csv, newline="", encoding="utf-8-sig") as fh:
        reader = csv.DictReader(fh)
        rows = list(reader)
        cols = list(reader.fieldnames or [])
    override = getattr(args, "source_id_column", None)
    if override:
        if override not in cols:
            raise ValueError(
                f"--source-id-column={override!r} not found in"
                f" {args.source_ids_csv}; has {cols}"
            )
        col = override
    else:
        for candidate in ("source_id", "source id", "source", "id"):
            if candidate in cols:
                col = candidate
                break
        else:
            if len(cols) == 1:
                col = cols[0]
            else:
                raise ValueError(
                    f"cannot find a source-id column in"
                    f" {args.source_ids_csv}; tried source_id/'source id'/"
                    f"source/id, has {cols}. Pass --source-id-column."
                )
    return _normalize_source_ids((r[col] or "").strip() for r in rows)


def _normalize_source_ids(values) -> list[str]:
    seen: set[str] = set()
    out: list[str] = []
    for v in values:
        if not v:
            continue
        m = _FLOAT_ARTIFACT_RE.match(v)
        if m:
            v = m.group(1)
        if v not in seen:
            seen.add(v)
            out.append(v)
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--source-ids", default=None)
    group.add_argument("--source-ids-csv", default=None)
    parser.add_argument("--source-id-column", default=None,
                        help="explicit source-ID column in --source-ids-csv"
                        " (default: auto-detect source_id/'source id'/"
                        "source/id, or the only column)")
    parser.add_argument("--source-bucket", required=True)
    parser.add_argument("--target-bucket", required=True)
    parser.add_argument("--no-skip-existing", action="store_true")
    parser.add_argument("--verify-numerics", action="store_true")
    parser.add_argument("--progress-log", default=None)
    parser.add_argument("--error-log", default=None)
    parser.add_argument("--backbone-weights", default=None)
    parser.add_argument("--backbone-batch", type=int, default=128)
    parser.add_argument("--decode-workers", type=int, default=8,
                        help="host decode threads feeding the device pipeline")
    parser.add_argument(
        "--compute-dtype", choices=("float32", "bfloat16"), default=None,
        help="backbone trunk dtype; bfloat16 runs behind the cosine"
        " numerics gate, which is then always on",
    )
    parser.add_argument(
        "--backbone-config-json", default=None,
        help="EfficientNetConfig.to_dict() JSON path overriding the"
        " production B0",
    )
    parser.add_argument(
        "--backbone-variant", default=None,
        choices=("b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7"),
        help="compound-scaled EfficientNet preset (default: production"
        " b0); mutually exclusive with --backbone-config-json",
    )
    parser.add_argument(
        "--backbone-padding", default=None, choices=("symmetric", "tf_same"),
        help="conv padding semantics; pyspacer-lineage weights need tf_same",
    )
    parser.add_argument(
        "--backbone-impl", default=None, choices=("module", "folded", "fused"),
        help="trunk: fused (default: the fused-MBConv kernel; folded with"
        " --mesh-devices), folded (plain PyTorch blocks) or module (the"
        " nn.Module forward)",
    )
    parser.add_argument(
        "--mesh-devices", type=int, default=None,
        help="shard the backbone batch over an N-device mesh, one process"
        " per device under torchrun (default: single device)",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device of the extractor (default cuda)")
    return parser


def resolve_backbone(args):
    """Weights + effective EfficientNetConfig from the CLI flags.

    Explicit --backbone-config-json / --backbone-variant win outright;
    otherwise the weight bundle's .config.json sidecar is the default;
    --compute-dtype and --backbone-padding override single fields of
    whichever base won. Returns ``(weights | None, config | None)``;
    (None, None) means the seeded default backbone.
    """
    from mermaid_classifier_tpu_torch.models.efficientnet import (
        EfficientNetConfig,
        variant_config,
    )

    weights = None
    sidecar_config = None
    if args.backbone_weights:
        from mermaid_classifier_tpu_torch.models.convert import load_backbone_bundle

        weights, sidecar_config = load_backbone_bundle(args.backbone_weights)
        if sidecar_config is not None:
            logger.info(
                "backbone sidecar config: padding=%s bn_eps=%g",
                sidecar_config.padding, sidecar_config.bn_eps,
            )

    config = None
    if args.backbone_config_json:
        if args.backbone_variant:
            raise SystemExit(
                "--backbone-variant and --backbone-config-json are mutually"
                " exclusive"
            )
        with open(args.backbone_config_json) as f:
            config_dict = json.load(f)
        # An explicit flag wins; otherwise the config file's dtype stands.
        if args.compute_dtype is not None:
            config_dict["compute_dtype"] = args.compute_dtype
        config = EfficientNetConfig.from_dict(config_dict)
    elif args.backbone_variant:
        config = variant_config(
            args.backbone_variant,
            compute_dtype=args.compute_dtype or "float32",
        )
    elif sidecar_config is not None:
        config = sidecar_config
        if args.compute_dtype is not None:
            config = dataclasses.replace(config, compute_dtype=args.compute_dtype)
    elif args.compute_dtype is not None and args.compute_dtype != "float32":
        config = EfficientNetConfig(compute_dtype=args.compute_dtype)

    if args.backbone_padding is not None:
        config = dataclasses.replace(
            config or EfficientNetConfig(), padding=args.backbone_padding
        )
    return weights, config


def backbone_impl_for(args) -> str:
    """``--backbone-impl``, else ``fused`` on one device and ``folded`` with
    ``--mesh-devices`` (the sharded trunk's default, as in the JAX CLI)."""
    return args.backbone_impl or ("folded" if args.mesh_devices else "fused")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    source_ids = parse_source_ids(args)
    logger.info("sources to process: %s", source_ids)

    weights, config = resolve_backbone(args)
    from mermaid_classifier_tpu_torch.parallel.mesh import cli_mesh

    with cli_mesh(args.mesh_devices, device=args.device,
                  command="mermaid_classifier_tpu_torch.scripts.build_feature_bucket"
                  ) as mesh:
        return _run(args, source_ids, weights, config, mesh)


def _run(args, source_ids, weights, config, mesh) -> int:
    from mermaid_classifier_tpu_torch.data.feature_bucket import (
        FeatureBucketBuilder,
    )
    from mermaid_classifier_tpu_torch.data.store import get_default_store
    from mermaid_classifier_tpu_torch.models.extractor import build_extractor

    extractor = build_extractor(
        weights, config=config,
        device=args.device if mesh is None else mesh.device,
        backbone_batch=args.backbone_batch,
        backbone_impl=backbone_impl_for(args), mesh=mesh,
    )
    builder = FeatureBucketBuilder(
        get_default_store(),
        args.source_bucket,
        args.target_bucket,
        extractor,
        skip_existing=not args.no_skip_existing,
        progress_log=args.progress_log,
        error_log=args.error_log,
        decode_workers=args.decode_workers,
        write_outputs=mesh is None or mesh.rank == 0,
    )
    available, _missing = builder.filter_to_available_sources(source_ids)
    if not available:
        logger.error("none of the requested sources are available; aborting")
        return 1
    # Reduced-precision trunks never run ungated: the cosine check against
    # the float32 reference is mandatory for them.
    effective_dtype = extractor.config.compute_dtype
    verify = args.verify_numerics or effective_dtype != "float32"
    if verify and not args.verify_numerics:
        logger.info(
            "compute_dtype=%s: device-numerics gate enforced automatically",
            effective_dtype,
        )
    result = builder.run(available, verify_numerics=verify)
    logger.info(result.describe())
    from mermaid_classifier_tpu_torch.ops import fused_mbconv, patch_crop
    from mermaid_classifier_tpu_torch.utils import profiling

    # What this process launched on the card (0 on the CPU, where the
    # wrappers run their plain versions): a launcher reads it per worker.
    logger.info("kernel launches in this process: crop %d, fused_mbconv %d"
                " (sliced %d)", patch_crop.launches, fused_mbconv.launches,
                fused_mbconv.sliced_launches)
    # Where the host's time went, by the program's spans (bucket.*,
    # extract.*): one line per span name.
    for name, spent in profiling.summary().items():
        logger.info("span %s: %d in %.3f s, %.3f ms each", name, spent["count"],
                    spent["total_s"], spent["mean_ms"])
    return result.exit_code


if __name__ == "__main__":
    raise SystemExit(main())
