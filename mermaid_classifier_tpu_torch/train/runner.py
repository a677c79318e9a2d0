"""Training runners: orchestration from options to a registered artifact.

The port of ``mermaid_classifier_tpu/train/runner.py``:

- ``TrainingRunner``: tracker-free base — dataset build, auto batch size,
  class weights, the port's ``MermaidTrainer`` on ``device`` ("cuda" unless
  the caller passes another);
- ``TrackingTrainingRunner``: the full experiment lifecycle — params,
  system metrics sampling, per-epoch step metrics, dataset artifacts, and
  the eval-the-artifact ordering: export the deployable npz artifact
  parity-gated (1e-6) on the first val batch, reload it with the public
  loader, compute the metrics against the SHIPPED predictor (through the
  resident gather when the val rows are on the device), register it, and,
  when ``settings.tracking_sync_bucket`` is set, mirror the run and the
  registry into that bucket of the default store (best-effort, as in JAX).

A run that is not device-resident packs its features into a packed
feature cache in a temporary directory when
``settings.use_packed_feature_cache`` is on (the default), and removes the
directory when the run ends; a device-resident run reads the disk once and
never packs.

Not ported, raising where it is asked for: the data-parallel mesh
(``settings.train_mesh_devices``).
"""

from __future__ import annotations

import os
import platform
import shutil
import tempfile
import typing
from contextlib import contextmanager
from datetime import datetime
from logging import getLogger
from pathlib import Path

import numpy as np

from mermaid_classifier_tpu_torch.common.table import Table
from mermaid_classifier_tpu_torch.common.taxonomy import (
    get_benthic_attribute_library,
    get_growth_form_library,
)
from mermaid_classifier_tpu_torch.config.options import (
    DatasetOptions,
    TrackingOptions,
    TrainingOptions,
)
from mermaid_classifier_tpu_torch.config.settings import (
    apply_settings_to_env,
    meminfo_bytes,
    settings,
    training_batch_size,
)
from mermaid_classifier_tpu_torch.data.dataset import TrainingDataset
from mermaid_classifier_tpu_torch.inference import export_artifact, load_predictor
from mermaid_classifier_tpu_torch.metrics import MetricsContext, MetricsCoordinator
from mermaid_classifier_tpu_torch.tracking.local_tracker import LocalTracker, Run
from mermaid_classifier_tpu_torch.train.class_weights import compute_class_weights
from mermaid_classifier_tpu_torch.train.trainer import MermaidTrainer
from mermaid_classifier_tpu_torch.utils.profiling import section_profiling
from mermaid_classifier_tpu_torch.utils.system_metrics import SystemMetricsSampler

logger = getLogger(__name__)


class TrainingRunner:
    """Tracker-free base runner."""

    dataset: TrainingDataset | None = None

    def __init__(
        self,
        dataset_options: DatasetOptions | None = None,
        training_options: TrainingOptions | None = None,
        store: typing.Any = None,
        device="cuda",
    ):
        # Explicit env normalization at the programmatic entry point — never
        # an import side effect.
        apply_settings_to_env()
        self.dataset_options = dataset_options or DatasetOptions()
        self.training_options = training_options or TrainingOptions()
        self.store = store
        self.device = device
        self.profiled_sections: list[dict] = []
        self._weighting_log: dict = {"enabled": False}

    def run(self, run_name: str | None = None, cleanup_dataset: bool = True):
        if run_name is None:
            run_name = self.current_time_str()
        logger.info("Run: %s", run_name)
        try:
            self.dataset = TrainingDataset(self.dataset_options, store=self.store)
            self.profiled_sections = self.dataset.profiled_sections.copy()

            with self.section_profiling("Logging dataset artifacts"):
                self.log_dataset_artifacts()

            logger.info("Proceeding to train with:")
            logger.info(self.dataset.describe_train_summary_stats())

            num_classes = len(self.dataset.labels.ref.classes_set)
            if settings.batch_size is not None:
                batch_size = settings.batch_size
                logger.info("Batch size: %d (from BATCH_SIZE)", batch_size)
            else:
                batch_size, available_gb = training_batch_size(num_classes=num_classes)
                logger.info(
                    "Batch size: %d (auto, %.1f GB available, %d classes)",
                    batch_size,
                    available_gb,
                    num_classes,
                )

            class_weight, self._weighting_log = self._compute_class_weights(
                self.dataset.labels
            )

            trainer = self._make_trainer(batch_size, class_weight)
            with self.section_profiling("Training call"):
                clf_calibrated, val_results, return_msg = trainer(
                    self.dataset.labels, self.training_options.epochs, []
                )
            self._early_stop_info = trainer._early_stop_info
            self._resident_timings = getattr(trainer, "resident_timings", None)
            # Kept for the eval-the-artifact fast path: the trainer knows
            # the resident split offsets, so metrics can gather the val
            # span on the device instead of re-reading it from disk.
            self._trainer = trainer
            self._clf_calibrated = clf_calibrated

            logger.info("Train time: %.1f s", return_msg.runtime)
            logger.info("New model's accuracy: %s", self.format_metric(return_msg.acc))
            return return_msg, clf_calibrated, val_results
        finally:
            if cleanup_dataset and self.dataset is not None:
                self.dataset.cleanup()
            packed = getattr(self, "_packed_cache_dir", None)
            if packed is not None and os.path.isdir(packed):
                shutil.rmtree(packed, ignore_errors=True)

    def _make_trainer(self, batch_size: int, class_weight) -> MermaidTrainer:
        """Hook so tests can shrink the head architecture."""
        if settings.train_mesh_devices is not None:
            raise NotImplementedError(
                f"train_mesh_devices={settings.train_mesh_devices}: data-parallel"
                " head training over a device mesh is not ported"
            )
        opts = self.training_options
        packed_dir = None
        # The packed cache speeds up epochs streamed from disk. A
        # device-resident run reads the disk once, for the upload, so
        # packing would only write the whole corpus again.
        if settings.use_packed_feature_cache and not opts.device_resident:
            self._packed_cache_dir = tempfile.mkdtemp(prefix="packed_cache_")
            packed_dir = self._packed_cache_dir
        return MermaidTrainer(
            batch_size=batch_size,
            on_epoch_end=self._on_epoch_end,
            class_weight=class_weight,
            early_stopping_patience=opts.early_stopping_patience,
            packed_cache_dir=packed_dir,
            checkpoint_dir=opts.checkpoint_dir,
            device_resident=opts.device_resident,
            resident_dtype=opts.resident_dtype,
            calibration_backend=opts.calibration_backend,
            calibration_method=opts.calibration_method,
            device=self.device,
        )

    def _on_epoch_end(self, metrics: dict) -> None:
        """Override for logging."""

    def _compute_class_weights(
        self, labels
    ) -> tuple[dict[str, float] | None, dict]:
        """Effective-number weights from training-set class counts + the log
        table the tracking runner persists."""
        opts = self.dataset_options.weighting
        if opts is None or not opts.enabled:
            return None, {"enabled": False}

        class_counts = labels.train.label_count_per_class
        weights = compute_class_weights(class_counts=class_counts, options=opts)

        per_class = Table.from_records(
            [
                {
                    "bagf_id": cls,
                    "count": int(count),
                    "weight": float(weights.get(cls, 0.0)),
                }
                for cls, count in class_counts.items()
            ],
            ["bagf_id", "count", "weight"],
        )
        w = np.asarray(per_class.column("weight"), dtype=np.float64)
        if len(w) > 0 and w.max() > 0:
            summary = {
                "weight_mean": float(w.mean()),
                "weight_median": float(np.median(w)),
                "weight_p5": float(np.percentile(w, 5)),
                "weight_p95": float(np.percentile(w, 95)),
                "weight_max_min_ratio": float(w.max() / max(w.min(), 1e-12)),
                "n_classes": int(len(per_class)),
            }
        else:
            summary = {
                "weight_mean": 0.0,
                "weight_median": 0.0,
                "weight_p5": 0.0,
                "weight_p95": 0.0,
                "weight_max_min_ratio": 0.0,
                "n_classes": int(len(per_class)),
            }
        return weights, {
            "enabled": True,
            "options": opts,
            "per_class_df": per_class,
            "summary": summary,
        }

    def log_dataset_artifacts(self) -> None:
        """Base runner has nowhere to log; subclasses override."""

    @contextmanager
    def section_profiling(self, name: str):
        with section_profiling(self.profiled_sections, name):
            yield

    @staticmethod
    def current_time_str() -> str:
        return datetime.now().strftime("%Y%m%dT%H%M%S")

    @staticmethod
    def format_metric(metric: float) -> float:
        return round(float(metric), 4)


class TrackingTrainingRunner(TrainingRunner):
    """Runner with the full tracking lifecycle + eval-the-exported-artifact.

    ``enforce_torch_pin`` is handed to ``export_artifact``: the export
    refuses a torch other than ``PARITY_PROVEN_TORCH`` unless it is False.
    """

    def __init__(
        self,
        *args,
        tracking_options: TrackingOptions | None = None,
        tracker: LocalTracker | None = None,
        enforce_torch_pin: bool = True,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.tracking_options = tracking_options or TrackingOptions()
        if tracker is None:
            from mermaid_classifier_tpu_torch.tracking.local_tracker import (
                get_default_tracker,
            )

            tracker = get_default_tracker()
        self.tracker = tracker
        self.enforce_torch_pin = enforce_torch_pin
        self._run: Run | None = None

    # -- naming ---------------------------------------------------------------

    def _get_model_name(self) -> str:
        """Configured name, or an auto name from the run parameters,
        truncated to 50 chars."""
        if self.tracking_options.model_name:
            return self.tracking_options.model_name[:50]
        parts = ["mermaid-mlp"]
        if self.dataset_options.coralnet_manifest_uri:
            parts.append("cn")
        if self.dataset_options.include_mermaid:
            parts.append("mermaid")
        if self.dataset_options.subsample is not None:
            parts.append(self.dataset_options.subsample.strategy)
        if self.dataset_options.weighting is not None and (
            self.dataset_options.weighting.enabled
        ):
            parts.append("weighted")
        parts.append(f"ep{self.training_options.epochs}")
        return "-".join(parts)[:50]

    # -- run ---------------------------------------------------------------------

    def run(self, run_name: str | None = None) -> tuple[typing.Any, Path | None]:
        model_name = self._get_model_name()
        if run_name is None:
            run_name = f"{model_name}-{self.current_time_str()}"
        experiment = (
            self.tracking_options.experiment_name
            or settings.default_experiment_name
            or "mermaid-classifier"
        )
        logger.info("Experiment: %s", experiment)

        return_msg = None
        registered_version: Path | None = None

        with self.tracker.start_run(experiment, run_name) as run:
            self._run = run
            run.log_params(
                {
                    "epochs": self.training_options.epochs,
                    "early_stopping_patience": (
                        self.training_options.early_stopping_patience
                        if self.training_options.early_stopping_patience is not None
                        else ""
                    ),
                    "include_mermaid": self.dataset_options.include_mermaid,
                    "coralnet_manifest_uri": self.dataset_options.coralnet_manifest_uri
                    or "",
                    "drop_growthforms": self.dataset_options.drop_growthforms,
                    "label_rollup_spec_csv": os.path.basename(
                        self.dataset_options.label_rollup_spec_csv or ""
                    ),
                    "included_labels_csv": os.path.basename(
                        self.dataset_options.included_labels_csv or ""
                    ),
                    "excluded_labels_csv": os.path.basename(
                        self.dataset_options.excluded_labels_csv or ""
                    ),
                    "ref_val_ratios": str(self.dataset_options.ref_val_ratios),
                }
            )
            if self.dataset_options.subsample is not None:
                run.log_params(self.dataset_options.subsample.to_log_dict())
            else:
                run.log_params({"subsample/enabled": False})
            if self.dataset_options.weighting is not None:
                run.log_params(self.dataset_options.weighting.to_log_dict())
            else:
                run.log_params({"weighting/enabled": False})
            self._log_system_specs(run)

            with SystemMetricsSampler(run, interval=10.0):
                try:
                    return_msg, clf_calibrated, val_results = super().run(
                        run_name=run_name, cleanup_dataset=False
                    )
                    assert self.dataset is not None

                    self._log_weighting_artifacts(run)
                    self._log_subsample_audit(run)
                    self._log_early_stop_info(run)
                    self._log_resident_timings(run)
                    run.log_dict(val_results.to_dict(), "valresult.json")
                    self._log_extra_annotations(run)
                    registered_version = self._eval_and_register(
                        run, model_name, return_msg, clf_calibrated, val_results
                    )
                finally:
                    # Logged LAST (so the export-gate / artifact-eval /
                    # metrics sections are included) and in the finally
                    # (so a FAILED run still shows where its time went).
                    # Never mask the original exception.
                    try:
                        run.log_dataframe(
                            Table.from_records(self.profiled_sections),
                            "profiled_sections.csv",
                        )
                    except Exception:
                        logger.warning(
                            "failed to log profiled_sections.csv",
                            exc_info=True,
                        )
                    if getattr(self, "dataset", None) is not None:
                        self.dataset.cleanup()

        logger.info("Registered model at: %s", registered_version)

        # Remote tracking: mirror the finished run (and the registry entry)
        # into the object store when a sync bucket is configured. Never
        # fatal: the local run is complete either way.
        if settings.tracking_sync_bucket:
            try:
                from mermaid_classifier_tpu_torch.data.store import get_default_store
                from mermaid_classifier_tpu_torch.tracking.store_sync import (
                    sync_registry_to_store,
                    sync_run_to_store,
                )

                store = get_default_store()
                # Just this run + the registry: a whole-tracker sync would
                # re-probe every historical object on every run.
                sync_run_to_store(run, store, settings.tracking_sync_bucket)
                sync_registry_to_store(
                    self.tracker, store, settings.tracking_sync_bucket
                )
            except Exception:  # noqa: BLE001 - sync is best-effort
                logger.warning(
                    "tracking sync to bucket %r failed",
                    settings.tracking_sync_bucket,
                    exc_info=True,
                )
        return return_msg, registered_version

    def _eval_and_register(
        self, run: Run, model_name: str, return_msg, clf_calibrated, val_results
    ) -> Path:
        """Eval-the-artifact: metrics run against the SHIPPED predictor,
        never the in-memory model; then the artifact is registered."""
        assert self.dataset is not None
        ref_batch = next(
            iter(self.dataset.labels.val.load_data_in_batches(batch_size=5000)),
            None,
        )
        if ref_batch is None:
            raise RuntimeError(
                "Val split yielded no feature batch; refusing to"
                " export an unverified artifact."
            )
        ref_features, _ = ref_batch

        with tempfile.TemporaryDirectory() as artifact_dir:
            artifact_path = Path(artifact_dir)
            with self.section_profiling("Export and parity gate"):
                model_npz, manifest, max_diff = export_artifact(
                    clf_calibrated,
                    artifact_path,
                    reference_features=ref_features,
                    config={"patch_size": 224},
                    enforce_torch_pin=self.enforce_torch_pin,
                )
            run.log_metric("export_parity_max_abs_diff", max_diff)
            model_json = artifact_path / "model.json"
            device = clf_calibrated.estimator.device
            predictor = load_predictor(model_npz, model_json, device=device)

            ctx = MetricsContext(
                val_results=val_results,
                ba_library=get_benthic_attribute_library(),
                gf_library=get_growth_form_library(),
                format_func=self.format_metric,
                dataset=self.dataset,
                clf=predictor,
            )
            self._resident_val_proba(run, ctx, clf_calibrated, predictor, device)
            with self.section_profiling("Metrics vs shipped artifact"):
                MetricsCoordinator(ctx, run).compute_and_log_all()

            run.log_metric("accuracy", self.format_metric(return_msg.acc))
            run.log_dict(
                {
                    str(epoch): self.format_metric(acc)
                    for epoch, acc in enumerate(return_msg.ref_accs, 1)
                },
                "epoch_ref_accuracies.yaml",
            )

            run.log_artifact(model_npz, "model/model.npz")
            run.log_artifact(model_json, "model/model.json")
            return self.tracker.register_model(
                model_name, [model_npz, model_json], run=run
            )

    def _resident_val_proba(self, run, ctx, clf_calibrated, predictor, device):
        """The eval-the-artifact fast path: the val span already sits in the
        resident buffer, and the loaded predictor exposes its gate-validated
        params, so one on-device gather and the artifact's own head replace
        re-reading the val features from disk. A reduced-precision buffer
        feeds the STORAGE-ROUNDED rows (the rows every in-run eval used),
        and the param ``artifact_eval_inputs`` says so. When the split is
        not resident the coordinator streams it from disk; when the fast
        path fails, the run logs the failure in that param and a warning,
        and streams from disk."""
        trainer = getattr(self, "_trainer", None)
        head = predictor.head_params
        if trainer is None or head is None:
            return
        try:
            with self.section_profiling("Artifact val proba (resident)"):
                res = trainer.resident_artifact_val_proba(
                    clf_calibrated.estimator,
                    self.dataset.labels.val,
                    head.as_tensors(device),
                )
        except Exception as exc:
            logger.warning(
                "resident artifact-eval fast path failed; falling back to"
                " disk streaming",
                exc_info=True,
            )
            run.log_param(
                "artifact_eval_inputs",
                f"disk (resident path failed: {type(exc).__name__})",
            )
            ctx.val_proba = ctx.val_gt_labels = None
            return
        if res is not None:
            ctx.val_proba, ctx.val_gt_labels = res
            rdtype = trainer.resident_dtype
            run.log_param("artifact_eval_inputs", f"resident({rdtype})")
            logger.info(
                "val probabilities via resident gather + shipped head params"
                " (%d rows, %s storage)",
                len(ctx.val_gt_labels),
                rdtype,
            )

    def _on_epoch_end(self, metrics: dict) -> None:
        """Per-epoch step metrics (live training charts) + one-shot
        early-stop summary scalars on the final epoch."""
        run = self._run
        if run is None:
            return
        step = int(metrics["epoch"])
        run.log_metric("epoch/ref_accuracy", float(metrics["ref_accuracy"]), step=step)
        if metrics.get("val_accuracy") is not None:
            run.log_metric(
                "epoch/val_accuracy", float(metrics["val_accuracy"]), step=step
            )
        if metrics.get("val_loss") is not None:
            run.log_metric("epoch/val_loss", float(metrics["val_loss"]), step=step)
        if metrics.get("training_loss") is not None:
            run.log_metric(
                "epoch/training_loss", float(metrics["training_loss"]), step=step
            )
        run.log_metric(
            "epoch/cumulative_seconds", float(metrics["cumulative_seconds"]), step=step
        )
        if metrics.get("final_epoch") is not None:
            run.log_metric("early_stop/final_epoch", float(metrics["final_epoch"]), step=0)
            run.log_metric(
                "early_stop/triggered", float(bool(metrics.get("early_stopped"))), step=0
            )
            if metrics.get("best_val_epoch") is not None:
                run.log_metric(
                    "early_stop/best_val_epoch", float(metrics["best_val_epoch"]), step=0
                )
            if metrics.get("best_val_loss") is not None:
                run.log_metric(
                    "early_stop/best_val_loss", float(metrics["best_val_loss"]), step=0
                )

    # -- logging helpers -------------------------------------------------------

    def _log_system_specs(self, run: Run) -> None:
        """Host and torch/CUDA facts (the JAX runner logs jax's instead)."""
        import torch

        run.log_params(
            {
                "system/platform": platform.platform(),
                "system/python": platform.python_version(),
                "system/cpus": os.cpu_count(),
                "system/memory_gb": round(meminfo_bytes("MemTotal") / 1e9, 1),
                "system/torch": torch.__version__,
                "system/torch_device": str(self.device),
            }
        )
        if torch.device(self.device).type == "cuda":
            run.log_params(
                {
                    "system/cuda_device_name": torch.cuda.get_device_name(
                        torch.device(self.device)
                    ),
                    "system/cuda_device_count": torch.cuda.device_count(),
                }
            )

    def _log_weighting_artifacts(self, run: Run) -> None:
        log = self._weighting_log
        if not log.get("enabled"):
            return
        run.log_dataframe(log["per_class_df"], "weighting/per_class_weights.csv")
        for key, value in log["summary"].items():
            run.log_metric(f"weighting/{key}", float(value))

    def _log_subsample_audit(self, run: Run) -> None:
        assert self.dataset is not None
        audit = self.dataset._subsample_audit_df
        if audit is None:
            return
        run.log_dataframe(audit, "subsample/per_class_audit.csv")
        if self.dataset._subsample_realized_total is not None:
            run.log_metric(
                "subsample/realized_total",
                float(self.dataset._subsample_realized_total),
            )

    def _log_early_stop_info(self, run: Run) -> None:
        info = getattr(self, "_early_stop_info", None)
        if info:
            run.log_dict(info, "early_stop_info.json")

    def _log_resident_timings(self, run: Run) -> None:
        """resident/* metrics: the stage budget of the device-resident
        upload path, so a full-scale drive's wall-clock decomposes inside
        the tracked run itself."""
        timings = getattr(self, "_resident_timings", None)
        if timings:
            for key, value in timings.items():
                run.log_metric(f"resident/{key}", float(value))

    def _log_extra_annotations(self, run: Run) -> None:
        assert self.dataset is not None
        run.log_dataframe(
            self.dataset.get_annotations("all").where("training_set", "val"),
            "annotations_val.csv",
        )
        spec = self.tracking_options.extra_annotations_to_log
        if spec:
            run.log_dataframe(
                self.dataset.get_annotations(spec), f"annotations_{spec}.csv"
            )

    def log_dataset_artifacts(self) -> None:
        assert self.dataset is not None and self._run is not None
        run = self._run
        artifacts = self.dataset.artifacts
        run.log_dataframe(artifacts.ba_counts, "dataset/ba_counts.csv")
        run.log_dataframe(artifacts.bagf_counts, "dataset/bagf_counts.csv")
        if not artifacts.coralnet_project_stats.empty:
            run.log_dataframe(
                artifacts.coralnet_project_stats, "dataset/coralnet_project_stats.csv"
            )
        if not artifacts.mermaid_project_stats.empty:
            run.log_dataframe(
                artifacts.mermaid_project_stats, "dataset/mermaid_project_stats.csv"
            )
        if hasattr(artifacts, "coralnet_label_mapping"):
            run.log_dataframe(
                artifacts.coralnet_label_mapping, "dataset/coralnet_label_mapping.csv"
            )
        if hasattr(artifacts, "unmapped_labels") and len(artifacts.unmapped_labels):
            run.log_dataframe(
                artifacts.unmapped_labels, "dataset/unmapped_labels.csv"
            )
        run.log_dict(
            artifacts.train_summary_stats, "dataset/train_summary_stats.yaml"
        )
