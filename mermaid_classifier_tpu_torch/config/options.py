"""Option dataclasses: the programmatic API between configs and the runner.

The port's own copy of ``mermaid_classifier_tpu/config/options.py``."""

from __future__ import annotations

import dataclasses
import enum

from mermaid_classifier_tpu_torch.data.subsample import SubsampleOptions
from mermaid_classifier_tpu_torch.train.class_weights import SampleWeightingOptions


class Sites(enum.Enum):
    CORALNET = "coralnet"
    MERMAID = "mermaid"


@dataclasses.dataclass
class DatasetOptions:
    """Dataset/ETL knobs.

    - ``include_mermaid``: include MERMAID annotations (False isolates
      CoralNet-only troubleshooting).
    - ``coralnet_manifest_uri``: manifest parquet URI/path; None disables
      CoralNet data.
    - ``drop_growthforms``: discard all GFs BEFORE rollups (simplifies
      coarse rollup specs).
    - ``label_rollup_spec_csv``: CSV with from_ba_id/from_gf_id ->
      to_ba_id/to_gf_id combo rollups; None rolls up nothing.
    - ``included_labels_csv`` / ``excluded_labels_csv``: CSV of ba_id/gf_id
      combos to accept or drop (mutually exclusive; applied AFTER rollups).
    - ``ref_val_ratios``: (ref, val) point fractions; train gets the rest.
    - ``subsample``: per-class subsampling applied after rollup+filter,
      before the split; None uses everything.
    - ``weighting``: effective-number class weighting for the CE loss;
      None means unweighted.
    """

    include_mermaid: bool = True
    coralnet_manifest_uri: str | None = None
    drop_growthforms: bool = False
    label_rollup_spec_csv: str | None = None
    included_labels_csv: str | None = None
    excluded_labels_csv: str | None = None
    ref_val_ratios: tuple[float, float] = (0.1, 0.1)
    subsample: SubsampleOptions | None = None
    weighting: SampleWeightingOptions | None = None


@dataclasses.dataclass
class TrainingOptions:
    """``epochs`` is the upper bound; ``early_stopping_patience`` (when set)
    stops earlier and restores the best-val_loss snapshot. The head
    architecture/learning rate are the fixed production values baked into
    MermaidTrainer (reference: options.py:143-171)."""

    epochs: int = 10
    early_stopping_patience: int | None = None
    # Per-epoch trainer checkpointing + resume (None disables). A
    # preempted run relaunched with the same dir continues bit-identically
    # (capability the reference lacks; SURVEY.md §5.3).
    checkpoint_dir: str | None = None
    # Pin the train features on device once and gather per-epoch batches by
    # index on device — bit-identical to streaming, with per-epoch H2D cut
    # to O(rows) indices. Composes with a train mesh: the resident buffer
    # is row-sharded across every chip's HBM and mini-batches re-shard for
    # data-parallel compute (train/mlp_classifier.set_resident_features).
    device_resident: bool = False
    # Storage precision of the resident buffer
    # ("float32" | "bfloat16" | "int8"). bfloat16 halves upload bytes +
    # HBM footprint; int8 (symmetric per-row quantization with f32 scales)
    # quarters them. Compute stays f32 (rows upcast/dequantized after the
    # on-device gather) behind the 0.999-cosine differential gate
    # (MLPClassifier.RESIDENT_DTYPES).
    resident_dtype: str = "float32"
    # Platt-fit backend ("scipy" | "device"). "device" batches all K
    # one-vs-rest fits into one jitted Newton solve — wins with a warm
    # compile cache, loses on cold remote compiles
    # (CalibratedClassifier.BACKENDS; trainer.calibration_backend).
    calibration_backend: str = "scipy"
    # Calibration family ("sigmoid" | "temperature"). "sigmoid" is the
    # reference-parity prefit-Platt recipe; "temperature" fits one scalar
    # by NLL on the ref split — argmax-preserving, and it lowers calibrated
    # log_loss where the sigmoid recipe raised it
    # (trainer.calibration_method; train/calibration.py).
    calibration_method: str = "sigmoid"


@dataclasses.dataclass
class TrackingOptions:
    """Experiment-tracking knobs (reference analog: MLflowOptions,
    options.py:174-207; the tracker here is the local run-directory store).

    - ``experiment_name``: falls back to settings.default_experiment_name.
    - ``model_name``: registered-model name; auto-derived (and truncated to
      50 chars) when None.
    - ``extra_annotations_to_log``: 'all' | 's<source_id>' | 'i<image_id>'
      | None — extra annotation table artifact beyond the always-logged
      val split.
    """

    experiment_name: str | None = None
    model_name: str | None = None
    extra_annotations_to_log: str | None = None
