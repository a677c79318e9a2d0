"""Generate a committed training-config dir from the taxonomy and the
per-class annotation counts, through the port.

Usage:
    python -m mermaid_classifier_tpu_torch.scripts.generate_training_config \\
        --counts-csv counts.csv            # columns ba_id, gf_id, count \\
        --output-dir config/ \\
        [--top-n 100] [--exclude "Unknown" --exclude "Trash"] \\
        [--sources-csv sources.csv] \\
        [--taxonomy-fixture-dir fixtures/]  # offline; default hits the API

The counts CSV is read as ``pd.read_csv(keep_default_na=False)`` reads it
(a blank ``gf_id`` stays "", numeric-looking ids are ints); the sources
CSV's first column as ``pd.read_csv`` reads it, each value then ``str``.
"""

from __future__ import annotations

import argparse
import logging
import math

logger = logging.getLogger("generate_training_config")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--counts-csv", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--top-n", type=int, default=100)
    parser.add_argument("--exclude", action="append", default=[])
    parser.add_argument("--sources-csv", default=None)
    parser.add_argument("--taxonomy-fixture-dir", default=None)
    parser.add_argument("--total-annotations", type=int, default=500_000)
    parser.add_argument("--min-per-class", type=int, default=200)
    parser.add_argument("--epochs", type=int, default=40)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    from mermaid_classifier_tpu_torch.common import taxonomy
    from mermaid_classifier_tpu_torch.common.html_table import read_csv
    from mermaid_classifier_tpu_torch.config.generate import (
        select_labels,
        write_config_dir,
    )

    if args.taxonomy_fixture_dir:
        import os

        os.environ[taxonomy.TAXONOMY_FIXTURE_ENV] = args.taxonomy_fixture_dir
        taxonomy.get_benthic_attribute_library.cache_clear()
        taxonomy.get_growth_form_library.cache_clear()

    ba_library = taxonomy.get_benthic_attribute_library()
    gf_library = taxonomy.get_growth_form_library()
    counts = read_csv(args.counts_csv, keep_default_na=False).to_table()

    generated = select_labels(
        ba_library,
        counts,
        top_n=args.top_n,
        excluded_names=set(args.exclude),
        gf_library=gf_library,
    )
    sources = None
    if args.sources_csv:
        first = read_csv(args.sources_csv).data[0]
        sources = [
            "nan" if v is None or (isinstance(v, float) and math.isnan(v))
            else str(v)
            for v in first
        ]
    out = write_config_dir(
        args.output_dir,
        generated,
        ba_library,
        sources=sources,
        total_annotations=args.total_annotations,
        min_per_class=args.min_per_class,
        epochs=args.epochs,
    )
    logger.info(
        "wrote %s: %d labels, %d rollups, %d excluded",
        out,
        generated.n_labels,
        len(generated.rollups),
        len(generated.excluded),
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
