"""TrainingDataset: the ETL pipeline from raw annotation tables to
train/ref/val point labels backed by downloaded feature files.

The port's own copy of ``mermaid_classifier_tpu/data/dataset.py``, without
pandas: the tables are the port's ``Table`` rows, the two parquet inputs are
read by ``common.relational.read_parquet_columns``, and each id column is
converted as the JAX package's ``Series.astype(str)`` converts it under
pandas 3 (``common.relational.pandas_str``: an int id gives "1001", a
string id stays as it is, a null stays missing (None), an integer column
holding a null gives "1001.0"). Stages, in order:

  1. read the CoralNet manifest parquet (when configured) into the
     ``annotations`` table, map CoralNet label IDs to MERMAID BA/GF via the
     label mapping, record + drop unmapped labels;
  2. read the MERMAID annotations parquet (when configured), normalizing
     the 'None' growth-form string to '';
  3. optional drop-growthforms, then rollups, then include/exclude label
     filter — all as distinct-value relational ops;
  4. optional deterministic per-class subsample: allocator targets joined
     against ROW_NUMBER() partitioned by class and ordered by the
     (site, project_id, image_id, row, col) annotation primary key, with a
     per-class audit table for after-the-fact determinism proof
     (reference: dataset.py:222-347);
  5. missing-feature detection against the object store's listing, with a
     percent tolerance and loud abort beyond it
     (reference: dataset.py:531-613);
  6. group annotations per image, download feature files in parallel, build
     ImageLabels, and split points-stratified into train/ref/val;
  7. tag the annotations table rows with their split
     (reference: dataset.py:780-843) and compute summary stats/artifacts.

Schema of ``annotations``: image_id, row, col, [label_id],
benthic_attribute_id, growth_form_id, site, bucket, project_id,
feature_vector [, training_set].

Feature-file layout (this framework's npz format, features_io.py):
  CoralNet: ``s{source_id}/features/i{image_id}.features.npz``
  MERMAID:  ``mermaid/{image_id}.features.npz``
"""

from __future__ import annotations

import os
import re
import tempfile
from contextlib import contextmanager
from io import StringIO
from logging import getLogger

from mermaid_classifier_tpu_torch.common import relational
from mermaid_classifier_tpu_torch.common.relational import Database, pandas_str
from mermaid_classifier_tpu_torch.common.table import Table
from mermaid_classifier_tpu_torch.common.taxonomy import (
    combine_ba_gf,
    get_benthic_attribute_library,
    get_coralnet_mapping,
    get_growth_form_library,
)
from mermaid_classifier_tpu_torch.config.options import DatasetOptions, Sites
from mermaid_classifier_tpu_torch.config.settings import settings
from mermaid_classifier_tpu_torch.data.label_specs import LabelFilter, LabelRollupSpec
from mermaid_classifier_tpu_torch.data.labels import (
    ImageLabels,
    SplitMode,
    TrainingTaskLabels,
    preprocess_labels,
)
from mermaid_classifier_tpu_torch.data.store import (
    ObjectStore,
    download_parallel,
    get_default_store,
)
from mermaid_classifier_tpu_torch.data.subsample import (
    SubsampleOptions,
    compute_per_class_targets,
)
from mermaid_classifier_tpu_torch.utils.profiling import section_profiling

logger = getLogger(__name__)

FEATURE_SUFFIX = ".features.npz"


class Artifacts:
    """Namespace for artifacts the runner logs."""

    ba_counts: Table
    bagf_counts: Table
    coralnet_label_mapping: list[dict]
    coralnet_project_stats: Table
    mermaid_project_stats: Table
    profiled_sections: list[dict]
    train_summary_stats: dict
    unmapped_labels: Table


class TrainingDataset:
    def __init__(
        self,
        options: DatasetOptions,
        store: ObjectStore | None = None,
    ):
        self.options = options
        self.artifacts = Artifacts()
        self.profiled_sections: list[dict] = []
        self._subsample_audit_df: Table | None = None
        self._subsample_realized_total: int | None = None

        if settings.feature_cache_dir:
            os.makedirs(settings.feature_cache_dir, exist_ok=True)
            self._feature_dir = settings.feature_cache_dir
            self._feature_temp_dir = None
        else:
            self._feature_temp_dir = tempfile.TemporaryDirectory(
                prefix="mermaid_features_"
            )
            self._feature_dir = self._feature_temp_dir.name

        # Local feature path -> original (bucket, feature_vector) location;
        # add_training_set_names maps splits back to table rows with it.
        self._feature_path_to_location: dict[str, tuple[str, str]] = {}
        self.feature_path_to_source: dict[str, tuple[str, str]] = {}
        self.coralnet_source_ids: list[str] = []

        if options.label_rollup_spec_csv:
            with open(options.label_rollup_spec_csv) as csv_f:
                self.rollup_spec = LabelRollupSpec(csv_f)
        else:
            self.rollup_spec = LabelRollupSpec(StringIO(""))

        if options.included_labels_csv and options.excluded_labels_csv:
            raise ValueError(
                "Specify one of included labels or excluded labels, but not both."
            )
        if options.included_labels_csv:
            with open(options.included_labels_csv) as csv_f:
                self.label_filter = LabelFilter(csv_f, inclusion=True)
        elif options.excluded_labels_csv:
            with open(options.excluded_labels_csv) as csv_f:
                self.label_filter = LabelFilter(csv_f, inclusion=False)
        else:
            # No spec = empty exclusion set = accept everything.
            self.label_filter = LabelFilter(StringIO(""), inclusion=False)

        self.store = store if store is not None else get_default_store()
        self.db = Database()

        if options.coralnet_manifest_uri:
            with self.section_profiling("Reading CoralNet annotations"):
                self.read_coralnet_manifest()
        else:
            self.artifacts.coralnet_project_stats = Table([])

        if options.include_mermaid:
            with self.section_profiling("Reading MERMAID annotations"):
                self.read_mermaid_data()
        else:
            self.artifacts.mermaid_project_stats = Table([])

        if not self.db.table_exists("annotations"):
            raise ValueError(
                "No annotations from CoralNet or MERMAID, even before label"
                " filtering."
            )

        with self.section_profiling("Rollups and filtering"):
            ann_before = self.db.row_count("annotations")
            if options.drop_growthforms:
                self.db.transform_column("annotations", "growth_form_id", lambda _: "")
            self.rollup_spec.roll_up_in_db(self.db, "annotations")
            self.label_filter.filter_in_db(self.db, "annotations")
            ann_after = self.db.row_count("annotations")
            logger.info(
                "Rollups+filter retained %.1f%% of annotations (%s -> %s)",
                100.0 * ann_after / max(ann_before, 1),
                f"{ann_before:,}",
                f"{ann_after:,}",
            )

        if options.subsample is not None:
            with self.section_profiling("Per-class subsampling"):
                self._apply_subsample(options.subsample)

        with self.section_profiling("Detecting missing feature vectors"):
            present: set[str] = set()
            if options.include_mermaid:
                bucket = settings.mermaid_train_data_bucket
                present |= {
                    f"{bucket}/{key}"
                    for key in self.store.list_keys(bucket, prefix="mermaid/")
                }
            if options.coralnet_manifest_uri:
                bucket = settings.coralnet_train_data_bucket
                present |= {
                    f"{bucket}/{key}" for key in self.store.list_keys(bucket)
                }
            self.handle_missing_feature_vectors(present)

        self.labels: TrainingTaskLabels = self.prep_labels()

        with self.section_profiling("Tag rows with training set"):
            self.add_training_set_names()

        self.set_train_summary_stats()

    # -- ingestion ----------------------------------------------------------

    def read_coralnet_manifest(self) -> None:
        """Manifest parquet -> annotations rows + CN->MERMAID label mapping.
        CoralNet must load before MERMAID — the mapping columns are added
        before MERMAID rows arrive."""
        if self.db.table_exists("annotations"):
            raise RuntimeError(
                "CoralNet data must be read in before MERMAID data."
            )
        manifest_uri = self.options.coralnet_manifest_uri
        try:
            manifest = relational.read_parquet_columns(manifest_uri)
            required = {"source_id", "image_id", "row", "col", "coralnet_id"}
            missing = required - set(manifest)
            if missing:
                raise ValueError(f"manifest is missing columns {sorted(missing)}")
        except Exception as exc:
            raise RuntimeError(
                f"Failed to read CoralNet manifest parquet at"
                f" '{manifest_uri}'. It must be readable and contain columns:"
                f" source_id, image_id, row, col, coralnet_id."
                f" Underlying error: {exc}"
            ) from exc

        # Rows with an image id (not missing, not "").
        image_str = pandas_str(manifest["image_id"])
        keep = [i for i, v in enumerate(image_str) if v is not None and v != ""]
        bucket = settings.coralnet_train_data_bucket
        source_all = pandas_str(manifest["source_id"])
        source_str = [source_all[i] for i in keep]
        image_str = [image_str[i] for i in keep]
        label_str = pandas_str(manifest["coralnet_id"])
        n = len(keep)
        annotations = {
            "image_id": image_str,
            "row": [int(manifest["row"][i]) for i in keep],
            "col": [int(manifest["col"][i]) for i in keep],
            "label_id": [label_str[i] for i in keep],
            "site": [Sites.CORALNET.value] * n,
            "bucket": [bucket] * n,
            "project_id": source_str,
            "feature_vector": [
                None if s is None or m is None
                else f"s{s}/features/i{m}{FEATURE_SUFFIX}"
                for s, m in zip(source_str, image_str)
            ],
        }
        self.db.create_table("annotations", annotations)

        self.coralnet_source_ids = [
            str(r["project_id"])
            for r in self.db.iter_rows(
                "SELECT DISTINCT project_id FROM annotations"
                " ORDER BY CAST(project_id AS INTEGER)"
            )
        ]
        self.artifacts.coralnet_project_stats = self.compute_project_stats(
            site=Sites.CORALNET.value
        )

        label_mapping = get_coralnet_mapping()
        self.artifacts.coralnet_label_mapping = label_mapping.get_dataframe()

        def label_to_ba(label):
            if label is None or label not in label_mapping:
                return None
            return label_mapping[label].benthic_attribute_id

        def label_to_gf(label):
            if label is None or label not in label_mapping:
                return None
            return label_mapping[label].growth_form_id

        self.db.add_column_from(
            "annotations", "benthic_attribute_id", ["label_id"], label_to_ba
        )
        self.db.add_column_from(
            "annotations", "growth_form_id", ["label_id"], label_to_gf
        )

        # Unmapped labels: record stats, then drop the rows.
        self.artifacts.unmapped_labels = self.db.query(
            "SELECT label_id, count(*) AS num_annotations,"
            " count(DISTINCT project_id) AS num_projects"
            " FROM annotations WHERE benthic_attribute_id IS NULL"
            " GROUP BY label_id ORDER BY num_annotations DESC"
        )
        self.db.execute(
            "DELETE FROM annotations WHERE benthic_attribute_id IS NULL"
        )

    def read_mermaid_data(self) -> None:
        """MERMAID parquet -> annotations rows."""
        parquet_path = settings.mermaid_annotations_parquet_pattern.format(
            mermaid_train_data_bucket=settings.mermaid_train_data_bucket,
        )
        mermaid = relational.read_parquet_columns(parquet_path)
        bucket = settings.mermaid_train_data_bucket
        image_str = pandas_str(mermaid["image_id"])
        n = len(image_str)
        rows = {
            "image_id": image_str,
            "row": [int(v) for v in mermaid["row"]],
            "col": [int(v) for v in mermaid["col"]],
            "label_id": [None] * n,
            "site": [Sites.MERMAID.value] * n,
            "bucket": [bucket] * n,
            "project_id": ["all"] * n,
            "feature_vector": [
                None if m is None else f"mermaid/{m}{FEATURE_SUFFIX}"
                for m in image_str
            ],
            "benthic_attribute_id": pandas_str(mermaid["benthic_attribute_id"]),
            "growth_form_id": pandas_str(mermaid["growth_form_id"]),
        }
        if self.db.table_exists("annotations"):
            self.db.insert("annotations", rows)
        else:
            self.db.create_table("annotations", rows)

        self.artifacts.mermaid_project_stats = self.compute_project_stats(
            site=Sites.MERMAID.value
        )

        # MERMAID parquet uses the string 'None' for missing growth forms;
        # normalize to '' like the CN mapping does.
        self.db.transform_column(
            "annotations",
            "growth_form_id",
            lambda gf: "" if gf in ("None", None) else gf,
        )

    # -- subsample ----------------------------------------------------------

    def _apply_subsample(self, opts: SubsampleOptions) -> None:
        """Deterministic per-class subsample with audit table."""
        counts = self.db.query(
            "SELECT benthic_attribute_id AS ba, growth_form_id AS gf,"
            " COUNT(*) AS n FROM annotations GROUP BY ba, gf ORDER BY ba, gf"
        )
        class_counts = {(ba, gf): int(n) for ba, gf, n in counts.rows}
        if not class_counts:
            logger.warning("Subsampling skipped: annotations table is empty.")
            return

        targets = compute_per_class_targets(opts, class_counts)

        with self.db.temp_table("subsample_targets") as targets_table:
            self.db.create_table(
                targets_table,
                [
                    {
                        "benthic_attribute_id": ba,
                        "growth_form_id": gf,
                        "target_n": int(n),
                    }
                    for (ba, gf), n in targets.items()
                ],
            )
            # ROW_NUMBER over the annotation primary-key ordering makes the
            # subsample identical across processes and engine thread counts
            # — the determinism contract.
            self.db.execute(
                f"""
                CREATE TABLE annotations_subsampled AS
                WITH numbered AS (
                    SELECT *, ROW_NUMBER() OVER (
                        PARTITION BY benthic_attribute_id, growth_form_id
                        ORDER BY site, project_id, image_id, row, col
                    ) AS _rn
                    FROM annotations
                )
                SELECT n.* FROM numbered n
                JOIN "{targets_table}" t
                  ON n.benthic_attribute_id IS t.benthic_attribute_id
                 AND n.growth_form_id IS t.growth_form_id
                WHERE n._rn <= t.target_n
                """
            )
        self.db.execute("ALTER TABLE annotations_subsampled DROP COLUMN _rn")
        self.db.execute("DROP TABLE annotations")
        self.db.execute("ALTER TABLE annotations_subsampled RENAME TO annotations")

        realized_rows = self.db.query(
            "SELECT benthic_attribute_id AS ba, growth_form_id AS gf,"
            " COUNT(*) AS n FROM annotations GROUP BY ba, gf"
        )
        realized = {(ba, gf): int(n) for ba, gf, n in realized_rows.rows}
        self._subsample_audit_df = Table.from_records(
            [
                {
                    "benthic_attribute_id": ba,
                    "growth_form_id": gf,
                    "pre_count": class_counts[(ba, gf)],
                    "target_n": targets.get((ba, gf), 0),
                    "realized_n": realized.get((ba, gf), 0),
                }
                for (ba, gf) in sorted(class_counts)
            ]
        )
        self._subsample_realized_total = int(
            sum(self._subsample_audit_df.column("realized_n"))
        )
        logger.info(
            "Subsample applied: strategy=%r, classes=%d, target_total=%s,"
            " realized_total=%s",
            opts.strategy,
            len(class_counts),
            opts.total_annotations,
            self._subsample_realized_total,
        )

    # -- missing features ---------------------------------------------------

    def handle_missing_feature_vectors(self, present_feature_paths: set[str]) -> None:
        """Drop annotations whose feature file is absent from the store; abort
        loudly past the configured tolerance."""
        distinct = self.db.query(
            "SELECT DISTINCT bucket || '/' || feature_vector AS feature_full"
            " FROM annotations"
        )
        in_annotations = set(distinct.column("feature_full"))
        missing = sorted(in_annotations - present_feature_paths)
        missing_examples = "\n".join(missing[:3])

        threshold = (
            len(in_annotations)
            * settings.training_inputs_percent_missing_allowed
            / 100
        )
        if len(missing) > threshold:
            raise RuntimeError(
                f"Too many feature vectors are missing ({len(missing)}),"
                f" such as:\n{missing_examples}\nYou can configure the"
                f" tolerance for missing feature vectors with the"
                f" TRAINING_INPUTS_PERCENT_MISSING_ALLOWED setting."
            )
        if missing:
            with self.db.temp_table("missing_features") as missing_table:
                self.db.create_table(missing_table, {"feature_full": missing})
                self.db.execute(
                    f"DELETE FROM annotations WHERE"
                    f" bucket || '/' || feature_vector IN"
                    f' (SELECT feature_full FROM "{missing_table}")'
                )
            logger.warning(
                "Skipping %d feature vector(s) absent from the store."
                " Example(s):\n%s",
                len(missing),
                missing_examples,
            )

    # -- label prep & split ---------------------------------------------------

    def prep_labels(self) -> TrainingTaskLabels:
        """Group annotations per image, download features in parallel, build
        ImageLabels, split points-stratified."""
        with self.section_profiling("Collecting feature paths"):
            jobs: dict[tuple[str, str], str] = {}
            image_data: list[tuple[str, str, str, str, list]] = []
            for rows in self.db.grouped_rows(
                "annotations", ["bucket", "feature_vector"]
            ):
                first = rows[0]
                bucket = str(first["bucket"])
                feature_vector = str(first["feature_vector"])
                annotations = [
                    (
                        int(r["row"]),
                        int(r["col"]),
                        combine_ba_gf(
                            str(r["benthic_attribute_id"]),
                            str(r["growth_form_id"]),
                        ),
                    )
                    for r in rows
                ]
                local_path = os.path.join(self._feature_dir, bucket, feature_vector)
                if (bucket, feature_vector) not in jobs:
                    jobs[(bucket, feature_vector)] = local_path
                    self._feature_path_to_location[local_path] = (
                        bucket,
                        feature_vector,
                    )
                image_data.append(
                    (
                        bucket,
                        feature_vector,
                        str(first["site"]),
                        str(first["project_id"]),
                        annotations,
                    )
                )

        with self.section_profiling("Downloading feature vectors"):
            failed = download_parallel(
                self.store, jobs, max_workers=settings.download_max_workers
            )
        if failed:
            logger.warning("%d feature vector download(s) failed.", len(failed))

        with self.section_profiling("Building point labels"):
            labels = ImageLabels()
            for bucket, feature_vector, site, project_id, annotations in image_data:
                if (bucket, feature_vector) in failed:
                    continue
                local_path = jobs[(bucket, feature_vector)]
                labels.add_image(local_path, annotations)
                self.feature_path_to_source[local_path] = (site, project_id)

            return preprocess_labels(
                labels,
                split_ratios=self.options.ref_val_ratios,
                split_mode=SplitMode.POINTS_STRATIFIED,
            )

    def add_training_set_names(self) -> None:
        """Add a training_set column mapping each annotation row to its split
        (LEFT JOIN semantics: rows in no split get NULL)."""
        records: list[tuple[str, str, int, int, str]] = []
        for set_name, split_labels in (
            ("train", self.labels.train),
            ("ref", self.labels.ref),
            ("val", self.labels.val),
        ):
            for path, row, col, _label in split_labels.annotation_items():
                bucket, feature_vector = self._feature_path_to_location[path]
                records.append((bucket, feature_vector, row, col, set_name))

        with self.db.temp_table("training_sets") as sets_table:
            self.db.execute(
                f'CREATE TABLE "{sets_table}"'
                f" (bucket TEXT, feature_vector TEXT, row INT, col INT,"
                f"  training_set TEXT)"
            )
            self.db.executemany(
                f'INSERT INTO "{sets_table}" VALUES (?, ?, ?, ?, ?)', records
            )
            self.db.execute(
                f"CREATE TABLE annotations_tagged AS"
                f" SELECT a.*, t.training_set"
                f' FROM annotations a LEFT OUTER JOIN "{sets_table}" t'
                f" ON a.bucket = t.bucket"
                f" AND a.feature_vector = t.feature_vector"
                f" AND a.row = t.row AND a.col = t.col"
            )
        self.db.execute("DROP TABLE annotations")
        self.db.execute("ALTER TABLE annotations_tagged RENAME TO annotations")

    # -- stats ------------------------------------------------------------------

    def compute_project_stats(
        self, site: str | None = None, has_training_sets: bool = False
    ) -> Table:
        where = "" if site is None else f"WHERE site = '{site}'"
        counts_sql = (
            " count(DISTINCT image_id) AS num_images, count(*) AS num_annotations"
        )
        if has_training_sets:
            counts_sql += (
                ", SUM(training_set = 'train') AS train"
                ", SUM(training_set = 'ref') AS ref"
                ", SUM(training_set = 'val') AS val"
                ", SUM(training_set IS NULL) AS dropped"
            )
        return self.db.query(
            f"SELECT site, project_id, {counts_sql} FROM annotations {where}"
            f" GROUP BY site, project_id ORDER BY site DESC, project_id"
        )

    def set_train_summary_stats(self) -> None:
        """Per-BA and per-BAGF split-count artifacts + the overall summary
        dict."""
        ba_library = get_benthic_attribute_library()
        gf_library = get_growth_form_library()

        def ba_name(ba_id):
            return ba_library.id_to_name(ba_id) if ba_id is not None else None

        def gf_name(gf_id):
            return gf_library.id_to_name(gf_id) if gf_id is not None else None

        split_counts = (
            ", count(*) AS num_annotations"
            ", count(DISTINCT project_id) AS num_projects"
            ", SUM(training_set = 'train') AS train"
            ", SUM(training_set = 'ref') AS ref"
            ", SUM(training_set = 'val') AS val"
            ", SUM(training_set IS NULL) AS dropped"
        )
        ba_counts = self.db.query(
            f"SELECT benthic_attribute_id {split_counts} FROM annotations"
            f" GROUP BY benthic_attribute_id ORDER BY num_annotations DESC"
        )
        ba_counts = ba_counts.with_column(
            0,
            "benthic_attribute_name",
            [ba_name(v) for v in ba_counts.column("benthic_attribute_id")],
        )
        self.artifacts.ba_counts = ba_counts

        bagf_counts = self.db.query(
            f"SELECT benthic_attribute_id, growth_form_id {split_counts}"
            f" FROM annotations GROUP BY benthic_attribute_id, growth_form_id"
            f" ORDER BY num_annotations DESC"
        )
        bagf_counts = bagf_counts.with_column(
            0,
            "growth_form_name",
            [gf_name(v) for v in bagf_counts.column("growth_form_id")],
        )
        bagf_counts = bagf_counts.with_column(
            0,
            "benthic_attribute_name",
            [ba_name(v) for v in bagf_counts.column("benthic_attribute_id")],
        )
        self.artifacts.bagf_counts = bagf_counts

        total_annotations = self.db.row_count("annotations")
        num_images = int(
            self.db.scalar("SELECT count(DISTINCT image_id) FROM annotations")
        )
        non_dropped = self.db.query(
            "SELECT count(*) AS anns,"
            " count(DISTINCT benthic_attribute_id) AS bas,"
            " count(DISTINCT benthic_attribute_id || '::' || growth_form_id)"
            "  AS bagfs"
            " FROM annotations WHERE training_set IS NOT NULL"
        ).records()[0]

        self.artifacts.profiled_sections = self.profiled_sections
        self.artifacts.train_summary_stats = {
            "annotations": total_annotations,
            "annotations_train": self.labels.train.label_count,
            "annotations_ref": self.labels.ref.label_count,
            "annotations_val": self.labels.val.label_count,
            "annotations_dropped": total_annotations - int(non_dropped["anns"]),
            "images": num_images,
            "bas": len(ba_counts),
            "bas_dropped": len(ba_counts) - int(non_dropped["bas"]),
            "bagfs": len(bagf_counts),
            "bagfs_dropped": len(bagf_counts) - int(non_dropped["bagfs"]),
        }

    def describe_train_summary_stats(self) -> str:
        return (
            "{annotations} annotations"
            " ({annotations_train} train, {annotations_ref} ref,"
            " {annotations_val} val, {annotations_dropped} dropped during"
            " stratification) from {images} images."
            " Representation: {bas} BAs and {bagfs} BA-GF combos"
            " (dropped: {bas_dropped} BAs, {bagfs_dropped} BA-GFs).".format(
                **self.artifacts.train_summary_stats
            )
        )

    def get_annotations(self, log_spec: str) -> Table:
        """Annotation table extracts for artifact logging: 'all', 's<id>'
        (CoralNet source), or 'i<id>' (CoralNet image)."""
        if log_spec == "all":
            return self.db.query("SELECT * FROM annotations")
        if match := re.fullmatch(r"s(\d+)", log_spec):
            return self.db.query(
                "SELECT * FROM annotations WHERE site = ? AND project_id = ?",
                (Sites.CORALNET.value, match.group(1)),
            )
        if match := re.fullmatch(r"i(\d+)", log_spec):
            return self.db.query(
                "SELECT * FROM annotations WHERE site = ? AND image_id = ?",
                (Sites.CORALNET.value, match.group(1)),
            )
        raise ValueError(f"Unsupported annotations log spec: {log_spec}")

    # -- lifecycle ---------------------------------------------------------------

    @contextmanager
    def section_profiling(self, name: str):
        with section_profiling(self.profiled_sections, name):
            yield

    def cleanup(self) -> None:
        if self._feature_temp_dir is not None:
            self._feature_temp_dir.cleanup()
