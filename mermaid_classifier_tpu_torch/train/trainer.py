"""MermaidTrainer: the port of ``mermaid_classifier_tpu/train/trainer.py``.

The epoch loop with per-epoch evaluation, early stopping, checkpoint and
resume, batched calibration and per-epoch callbacks:

- the production architecture (500, 300, 100) at lr 1e-4, random_state 0,
  on ``device`` ("cuda" unless the caller passes another);
- per epoch: the train batches (epoch index as the shuffle seed) into
  ``partial_fit``, then ref accuracy and val accuracy + log loss;
- early stopping on val loss with a deepcopy best snapshot, restored even
  when the epoch budget runs out;
- calibration from uncalibrated ref scores, (N, K) at a time;
- a per-epoch callback dict with one-shot final-epoch summary fields;
- an atomic per-epoch checkpoint that a later call resumes bit for bit, and
  refuses when it was written by another run configuration.

With ``device_resident=True`` the [train | ref | val] feature rows go to the
device once, as one float32, bfloat16 or int8 buffer, filled from disk by a
thread pool while an upload thread streams finished slabs behind the fill;
each epoch then trains by on-device gathers (``partial_fit_resident``), the
per-epoch evals are fused on the device (two scalars per batch), and the
calibration and final evaluation read the resident ref and val rows. The
image order, batch boundaries and label order are those of the streamed
path (``ImageLabels.iter_index_batches``).

Left out: ``mesh``, ``packed_cache_dir`` (raises ``NotImplementedError``),
the TPU host's threaded page pre-touch and the ahead-of-time program warming.
``accuracy_score`` and ``log_loss`` are numpy functions with sklearn 1.9's
semantics.
"""

from __future__ import annotations

import copy
import heapq
import os
import pickle
import tempfile
import threading
import time
from collections.abc import Callable
from contextlib import contextmanager
from logging import getLogger
from typing import Any

import numpy as np
import torch

from mermaid_classifier_tpu_torch.data.labels import (
    ImageLabels,
    TrainingTaskLabels,
    evaluate_classifier,
)
from mermaid_classifier_tpu_torch.data.results import (
    TrainClassifierReturnMsg,
    ValResults,
)
from mermaid_classifier_tpu_torch.models.extractor import _resolve_device
from mermaid_classifier_tpu_torch.train.calibration import (
    CalibratedClassifier,
    TemperatureCalibratedClassifier,
)
from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier

logger = getLogger(__name__)


def accuracy_score(y_true, y_pred) -> float:
    """sklearn's ``accuracy_score``: the share of equal labels."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_true.shape != y_pred.shape:
        raise ValueError(
            f"Found input variables with inconsistent numbers of samples:"
            f" {[len(y_true), len(y_pred)]}"
        )
    return float(np.average(y_true == y_pred))


def log_loss(y_true, y_proba, labels) -> float:
    """sklearn 1.9's ``log_loss(y_true, y_proba, labels=labels)``: columns
    in sorted ``labels`` order, each row's true-class probability clipped
    to [eps, 1 - eps] at float64 eps, no renormalization, the mean of the
    negative logs."""
    proba = np.asarray(y_proba, dtype=np.float64)
    if proba.ndim == 1:
        proba = proba[:, None]
    if proba.shape[1] == 1:
        proba = np.concatenate([1.0 - proba, proba], axis=1)
    if proba.max() > 1:
        raise ValueError(f"y_prob contains values greater than 1: {proba.max()}")
    if proba.min() < 0:
        raise ValueError(f"y_prob contains values lower than 0: {proba.min()}")
    classes = np.unique(np.asarray(labels))
    y_true = np.asarray(y_true)
    if len(y_true) != proba.shape[0]:
        raise ValueError(
            f"Found input variables with inconsistent numbers of samples:"
            f" {[proba.shape[0], len(y_true)]}"
        )
    pos = np.searchsorted(classes, y_true)
    if np.any(pos >= len(classes)) or not np.array_equal(classes[np.minimum(
            pos, len(classes) - 1)], y_true):
        raise ValueError(
            f"y_true contains values {set(y_true) - set(labels)}"
            f" not belonging to the passed labels {labels}."
        )
    if len(classes) < 2:
        raise ValueError(
            f"The labels array needs to contain at least two labels, got {classes}."
        )
    if len(classes) != proba.shape[1]:
        raise ValueError(
            "The number of classes in labels is different from that in"
            f" y_prob. Classes found in labels: {classes}"
        )
    eps = np.finfo(proba.dtype).eps
    true_p = np.clip(proba, eps, 1 - eps)[np.arange(len(pos)), pos]
    return float(np.average(-np.log(true_p)))


class CheckpointMismatchError(RuntimeError):
    """A checkpoint_dir holds state from an incompatible run configuration."""


# Production MLP architecture (the reference's hidden-layer experiments).
PRODUCTION_HIDDEN_LAYERS = (500, 300, 100)
PRODUCTION_LEARNING_RATE = 1e-4
PRODUCTION_RANDOM_STATE = 0


class _FilledPrefix:
    """Thread-safe watermark over a buffer filled in disjoint row spans:
    ``add(start, n)`` publishes a finished span, ``wait(n)`` blocks until
    rows [0, n) are all finished. The fill finishes spans nearly in order
    (sorted image keys over a bounded pool), so the watermark advances
    smoothly and the upload streams slabs behind the fill. ``fail(exc)``
    aborts every waiter: a fill error must stop the uploader, never hang
    it."""

    def __init__(self, total: int):
        self._cv = threading.Condition()
        self._total = int(total)
        self._watermark = 0
        self._pending: list[tuple[int, int]] = []  # heap of (start, end)
        self._exc: BaseException | None = None

    def add(self, start: int, n: int) -> None:
        with self._cv:
            heapq.heappush(self._pending, (start, start + n))
            while self._pending and self._pending[0][0] <= self._watermark:
                _, end = heapq.heappop(self._pending)
                if end > self._watermark:
                    self._watermark = end
            self._cv.notify_all()

    def fail(self, exc: BaseException) -> None:
        with self._cv:
            self._exc = exc
            self._cv.notify_all()

    def wait(self, n: int) -> None:
        with self._cv:
            while self._watermark < min(n, self._total):
                if self._exc is not None:
                    raise RuntimeError(
                        "resident fill failed while the upload was waiting"
                        f" for {n} rows"
                    ) from self._exc
                self._cv.wait(timeout=1.0)


@contextmanager
def _log_entry_and_exit(name: str):
    """DEBUG-level enter/exit timing around a pipeline phase."""
    start_time = time.time()
    logger.debug("Entering: %s", name)
    try:
        yield
    finally:
        logger.debug("Exiting: %s after %f seconds.", name, time.time() - start_time)


def _int8_rows_into(scale_vec: np.ndarray):
    """The int8 staging transform for ``ImageLabels.load_into``: each
    image's rows quantized with the RESIDENT_DTYPES formula
    (``MLPClassifier._int8_row_scales`` and ``_quantize_rows_int8``), its
    scales into ``scale_vec`` at its buffer rows."""

    def row_transform(x, out_rows, buffer_row):
        s = MLPClassifier._int8_row_scales(x)
        MLPClassifier._quantize_rows_int8(
            x, (1.0 / s).astype(np.float32), np.empty(x.shape, np.float32),
            out_rows)
        scale_vec[buffer_row: buffer_row + len(s)] = s

    return row_transform


class MermaidTrainer:
    """Epoch-loop trainer producing a calibrated classifier + val results."""

    def __init__(
        self,
        batch_size: int,
        on_epoch_end: Callable[[dict[str, Any]], None] | None = None,
        class_weight: dict[str, float] | None = None,
        early_stopping_patience: int | None = None,
        packed_cache_dir: str | None = None,
        checkpoint_dir: str | None = None,
        device_resident: bool = False,
        resident_dtype: str = "float32",
        calibration_backend: str = "scipy",
        calibration_method: str = "sigmoid",
        resident_load_workers: int = 8,
        device="cuda",
    ):
        if early_stopping_patience is not None and early_stopping_patience < 1:
            raise ValueError(
                f"early_stopping_patience must be >= 1 or None, got"
                f" {early_stopping_patience!r}"
            )
        if packed_cache_dir is not None:
            raise NotImplementedError(
                "packed_cache_dir: the packed feature cache is not ported"
                " (it needs the native row gather)"
            )
        if resident_dtype not in MLPClassifier.RESIDENT_DTYPES:
            raise ValueError(
                f"resident dtype must be one of {MLPClassifier.RESIDENT_DTYPES},"
                f" got {resident_dtype!r}"
            )
        if calibration_method not in ("sigmoid", "temperature"):
            raise ValueError(
                f"calibration_method must be 'sigmoid' or 'temperature',"
                f" got {calibration_method!r}"
            )
        self.batch_size = batch_size
        self.on_epoch_end = on_epoch_end
        self.class_weight = class_weight
        self.early_stopping_patience = early_stopping_patience
        self.packed_cache_dir = packed_cache_dir
        # When set, the trainer state (classifier, Adam, early-stopping
        # bookkeeping, best snapshot) is checkpointed after every epoch and
        # a later call resumes from it; the epoch shuffle is seeded by the
        # epoch index, so a resumed run equals an uninterrupted one.
        self.checkpoint_dir = checkpoint_dir
        # Device-resident epochs: the features go to the device once and
        # every epoch gathers rows by index there.
        self.device_resident = bool(device_resident)
        # Storage precision of the resident buffer
        # (MLPClassifier.RESIDENT_DTYPES); compute stays f32.
        self.resident_dtype = resident_dtype
        # Thread-pool width for reading the per-image feature files into
        # the resident buffer (ImageLabels.load_into).
        self.resident_load_workers = resident_load_workers
        # Platt-fit backend (CalibratedClassifier.BACKENDS): "scipy" is the
        # per-class L-BFGS; "device" batches every fit into one solve.
        self.calibration_backend = calibration_backend
        # "sigmoid" is the prefit-Platt recipe; "temperature" the
        # single-scalar NLL fit (TemperatureCalibratedClassifier).
        self.calibration_method = calibration_method
        self.device = _resolve_device(device)
        # Populated by __call__.
        self._early_stop_info: dict[str, Any] | None = None
        # Stage budget of a resident __call__ (seconds and sizes).
        self.resident_timings: dict[str, float] | None = None

    # -- checkpoint / resume -------------------------------------------------

    _CHECKPOINT_NAME = "trainer_checkpoint.pkl"

    def _checkpoint_path(self) -> str | None:
        if self.checkpoint_dir is None:
            return None
        return os.path.join(self.checkpoint_dir, self._CHECKPOINT_NAME)

    def _save_checkpoint(self, state: dict[str, Any]) -> None:
        """Atomic (tmp + rename) per-epoch checkpoint: internal resume state
        of the training lane, never a shipped artifact."""
        path = self._checkpoint_path()
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.checkpoint_dir, suffix=".part")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(state, f)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _load_checkpoint(
        self, expected_fingerprint: dict[str, Any]
    ) -> dict[str, Any] | None:
        path = self._checkpoint_path()
        if path is None or not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            state = pickle.load(f)
        found = state.get("fingerprint")
        if found != expected_fingerprint:
            # Resuming another run's weights would pass for a resume of this
            # one: refuse; the operator clears the directory deliberately.
            raise CheckpointMismatchError(
                f"checkpoint at {path} was written by a different run"
                f" configuration and cannot be resumed here.\n"
                f"  checkpoint fingerprint: {found}\n"
                f"  this run's fingerprint: {expected_fingerprint}\n"
                f"Delete {path} (or point checkpoint_dir elsewhere) to start"
                f" fresh."
            )
        logger.info(
            "Resuming from checkpoint %s (next epoch %d).",
            path,
            state["next_epoch"],
        )
        return state

    def _clear_checkpoint(self) -> None:
        path = self._checkpoint_path()
        if path is not None and os.path.isfile(path):
            os.unlink(path)

    @staticmethod
    def _clf_to_state(clf: MLPClassifier | None) -> dict | None:
        return None if clf is None else clf.__getstate__()

    @staticmethod
    def _clf_from_state(state: dict | None) -> MLPClassifier | None:
        if state is None:
            return None
        clf = MLPClassifier.__new__(MLPClassifier)
        clf.__setstate__(dict(state))
        return clf

    def _run_fingerprint(
        self,
        clf: MLPClassifier,
        labels: TrainingTaskLabels,
        classes_list: list[Any],
        nbr_epochs: int,
    ) -> dict[str, Any]:
        """Identity of this run for checkpoint compatibility: classes,
        architecture, batch size, class weights, split sizes, epoch budget."""
        return {
            "classes": [str(c) for c in classes_list],
            "hidden_layer_sizes": list(
                getattr(clf, "hidden_layer_sizes", ()) or ()
            ),
            "learning_rate_init": getattr(clf, "learning_rate_init", None),
            "random_state": getattr(clf, "random_state", None),
            "batch_size": int(self.batch_size),
            "class_weight": (
                sorted((str(k), float(v)) for k, v in self.class_weight.items())
                if self.class_weight
                else None
            ),
            "early_stopping_patience": self.early_stopping_patience,
            "nbr_epochs": int(nbr_epochs),
            "label_counts": {
                "train": int(labels.train.label_count),
                "ref": int(labels.ref.label_count),
                "val": int(labels.val.label_count),
            },
        }

    def _make_classifier(self, class_weight: dict[str, float] | None) -> MLPClassifier:
        """Hook for tests to swap the classifier architecture."""
        return MLPClassifier(
            hidden_layer_sizes=PRODUCTION_HIDDEN_LAYERS,
            learning_rate_init=PRODUCTION_LEARNING_RATE,
            class_weight=class_weight,
            random_state=PRODUCTION_RANDOM_STATE,
            device=self.device,
        )

    # -- resident staging ----------------------------------------------------

    def _stage_resident(self, clf: MLPClassifier, labels: TrainingTaskLabels) -> None:
        """One combined [train | ref | val] buffer on the device: a thread
        pool fills a host buffer in the storage dtype (bf16 cast on
        assignment, int8 quantized per image inline with the reads) while an
        upload thread streams finished slabs behind it. A failure on either
        side stops the other."""
        # Offsets keep a strong reference to each split and match by
        # identity, so a recycled id() cannot alias a stale entry.
        self._resident_split_offsets = {}
        split_plan: list[tuple[ImageLabels, int]] = []
        pos = 0
        for split_name in ("train", "ref", "val"):
            split = getattr(labels, split_name)
            self._resident_split_offsets[split_name] = (split, pos)
            if len(split):
                split_plan.append((split, pos))
                pos += split.label_count
        dim = self._probe_feature_dim(split_plan[0][0]) if split_plan else 0

        t_load = time.time()
        rdtype = self.resident_dtype
        row_transform = None
        scale_vec = None
        if rdtype == "int8":
            stacked = np.empty((pos, dim), dtype=np.int8)
            scale_vec = np.empty(pos, dtype=np.float32)
            row_transform = _int8_rows_into(scale_vec)
        elif rdtype == "bfloat16":
            # No ml_dtypes on the card machine: bf16 rows stage in a CPU
            # tensor (the cast is round to nearest even, as jnp's).
            stacked = torch.empty((pos, dim), dtype=torch.bfloat16)
        else:
            stacked = np.empty((pos, dim), dtype=np.float32)

        tracker = _FilledPrefix(pos)
        upload_exc: list[BaseException] = []
        t_up = time.time()

        def _upload() -> None:
            try:
                if rdtype == "float32":
                    clf.set_resident_features(stacked, dtype=rdtype,
                                              wait_rows=tracker.wait)
                else:
                    clf.set_resident_features_storage(
                        stacked, scale_vec, wait_rows=tracker.wait)
            except BaseException as exc:  # rethrown after the join below
                upload_exc.append(exc)

        def _publish(start: int, n: int) -> None:
            # A dead uploader aborts the fill at its next published span.
            if upload_exc:
                raise RuntimeError(
                    "resident upload failed; aborting the disk fill"
                ) from upload_exc[0]
            tracker.add(start, n)

        upload_thread = threading.Thread(
            target=_upload, name="resident-upload", daemon=True
        )
        upload_thread.start()
        try:
            for split, offset in split_plan:
                split.load_into(
                    stacked, offset,
                    max_workers=self.resident_load_workers,
                    row_transform=row_transform,
                    on_rows_filled=_publish,
                )
        except BaseException as exc:
            tracker.fail(exc)  # abort the uploader, never hang it
            upload_thread.join()
            # The fill died because the uploader died: surface the
            # uploader's root cause, not the abort wrapper.
            if upload_exc and exc.__cause__ is upload_exc[0]:
                raise upload_exc[0]
            raise
        load_s = time.time() - t_load
        t_join = time.time()
        upload_thread.join()
        if upload_exc:
            raise upload_exc[0]
        upload_s = time.time() - t_up
        upload_extra_s = time.time() - t_join
        item = 1 if rdtype == "int8" else 2 if rdtype == "bfloat16" else 4
        logger.info(
            "resident buffer staged: %d rows x %d, %.2f GB %s; fill %.1fs,"
            " upload %.1fs (+%.1fs after the fill)",
            pos, dim, pos * dim * item / 1e9, rdtype, load_s, upload_s,
            upload_extra_s,
        )
        self.resident_timings = {
            "load_seconds": round(load_s, 1),
            # Host-side int8 quantization inside the upload (0.0 otherwise).
            "quantize_seconds": round(float(
                clf._resident_upload_timings.get("quantize_seconds", 0.0)), 1),
            # The upload thread's lifetime: it starts with the fill.
            "upload_stage_seconds": round(upload_s, 1),
            # How long it ran after the fill finished.
            "upload_extra_wait_seconds": round(upload_extra_s, 1),
            "rows": float(pos),
            "gigabytes_f32": round(pos * dim * 4 / 1e9, 2),
        }
        # Kept so that a best snapshot restored from a checkpoint (which
        # never carries the data buffer) can be re-attached before the
        # resident calibration and evaluation. The scale travels with the
        # buffer: an int8 buffer is unreadable without it.
        self._resident_buffer = clf._resident_X
        self._resident_buffer_scale = clf._resident_scale
        self._resident_buffer_dtype = clf._resident_dtype
        self._resident_buffer_n_rows = clf._resident_n_rows

    def __call__(
        self,
        labels: TrainingTaskLabels,
        nbr_epochs: int,
        pc_models: list[Any],
        **_kwargs: Any,
    ) -> tuple[CalibratedClassifier, ValResults, TrainClassifierReturnMsg]:
        logger.debug(
            "Label count: Train = %d, Ref = %d, Val = %d, Total = %d",
            labels.train.label_count,
            labels.ref.label_count,
            labels.val.label_count,
            labels.label_count,
        )
        classes_list = sorted(labels.ref.classes_set)

        with _log_entry_and_exit("training MLP"):
            clf = self._make_classifier(self.class_weight)

            ref_accs: list[float] = []
            t0 = time.time()

            best_val_loss: float = float("inf")
            best_clf_snapshot = None
            best_epoch_idx: int | None = None
            epochs_since_best: int = 0
            stop_reason: str = "budget_exhausted"
            epoch: int = 0
            start_epoch: int = 0

            fingerprint = self._run_fingerprint(
                clf, labels, classes_list, nbr_epochs
            )
            checkpoint = self._load_checkpoint(fingerprint)
            if checkpoint is not None:
                clf = self._clf_from_state(checkpoint["clf"])
                best_clf_snapshot = self._clf_from_state(
                    checkpoint["best_clf"]
                )
                ref_accs = list(checkpoint["ref_accs"])
                best_val_loss = checkpoint["best_val_loss"]
                best_epoch_idx = checkpoint["best_epoch_idx"]
                epochs_since_best = checkpoint["epochs_since_best"]
                start_epoch = int(checkpoint["next_epoch"])
                # A spent budget runs no epoch; `epoch` then points at the
                # last completed one.
                epoch = max(start_epoch - 1, 0)

            # Per-call reset: offsets and buffers of a previous call must not
            # leak into this one (a resumed run whose budget is spent skips
            # the upload and streams its evals from disk).
            self._resident_split_offsets = None
            self._resident_buffer = None
            self._resident_buffer_scale = None
            self._resident_buffer_dtype = "float32"
            self._resident_buffer_n_rows = None
            self.resident_timings = None
            if self.device_resident and nbr_epochs > start_epoch:
                # One upload for the whole run (a resumed run uploads again:
                # a checkpoint holds model state only).
                self._stage_resident(clf, labels)

            t_epochs = time.time()
            # Per-split (index, true-class index) arrays of the fused
            # resident eval, built on first use and kept for the call.
            eval_cache: dict[int, list] = {}
            for epoch in range(start_epoch, nbr_epochs):
                if self.device_resident:
                    # The image order, batch boundaries and rows of the
                    # streamed path; only the gather moved to the device.
                    for idx, y in labels.train.iter_index_batches(
                        batch_size=self.batch_size,
                        random_seed=epoch,
                    ):
                        clf.partial_fit_resident(idx, y, classes=classes_list)
                else:
                    for x, y in labels.train.load_data_in_batches(
                        batch_size=self.batch_size,
                        random_seed=epoch,
                    ):
                        clf.partial_fit(x, y, classes=classes_list)

                ref_eval = self._resident_eval_batched(
                    clf, labels.ref, eval_cache
                )
                ref_accs.append(
                    ref_eval[0]
                    if ref_eval is not None
                    else self._calc_acc_batched(clf, labels.ref)
                )

                # Val accuracy + log loss of the uncalibrated head: the trend
                # is the overfitting signal.
                val_eval = self._resident_eval_batched(
                    clf, labels.val, eval_cache
                )
                if val_eval is not None:
                    val_acc, val_loss = val_eval
                else:
                    val_acc, val_loss = self._calc_acc_and_log_loss_batched(
                        clf, labels.val, classes_list
                    )
                logger.info(
                    "Epoch %d: ref_acc=%.4f val_acc=%.4f val_loss=%.4f"
                    " (%.1fs elapsed)",
                    epoch, ref_accs[-1], val_acc, val_loss, time.time() - t0,
                )

                if self.early_stopping_patience is not None:
                    if val_loss < best_val_loss:
                        best_val_loss = val_loss
                        best_epoch_idx = epoch
                        best_clf_snapshot = copy.deepcopy(clf)
                        epochs_since_best = 0
                    else:
                        epochs_since_best += 1

                will_stop_after_this = epoch == nbr_epochs - 1 or (
                    self.early_stopping_patience is not None
                    and epochs_since_best >= self.early_stopping_patience
                )

                if self.on_epoch_end is not None:
                    loss_curve = getattr(clf, "loss_curve_", [None])
                    cb_metrics: dict[str, Any] = {
                        "epoch": epoch,
                        "ref_accuracy": ref_accs[-1],
                        "val_accuracy": val_acc,
                        "val_loss": val_loss,
                        "training_loss": loss_curve[-1] if loss_curve else None,
                        "cumulative_seconds": time.time() - t0,
                    }
                    if will_stop_after_this:
                        # One-shot summary fields on the final epoch only.
                        early_stopped = (
                            self.early_stopping_patience is not None
                            and epochs_since_best >= self.early_stopping_patience
                        )
                        cb_metrics["final_epoch"] = epoch + 1
                        cb_metrics["early_stopped"] = early_stopped
                        if best_epoch_idx is not None:
                            cb_metrics["best_val_epoch"] = best_epoch_idx + 1
                            cb_metrics["best_val_loss"] = best_val_loss
                    self.on_epoch_end(cb_metrics)

                if self.checkpoint_dir is not None:
                    self._save_checkpoint(
                        {
                            "fingerprint": fingerprint,
                            "next_epoch": epoch + 1,
                            "clf": self._clf_to_state(clf),
                            "best_clf": self._clf_to_state(best_clf_snapshot),
                            "ref_accs": list(ref_accs),
                            "best_val_loss": best_val_loss,
                            "best_epoch_idx": best_epoch_idx,
                            "epochs_since_best": epochs_since_best,
                        }
                    )

                if (
                    self.early_stopping_patience is not None
                    and epochs_since_best >= self.early_stopping_patience
                ):
                    stop_reason = "early_stopping"
                    logger.info(
                        "Early stopping at epoch %d: val_loss has not improved"
                        " for %d consecutive epochs. Best was epoch %d"
                        " (val_loss=%.4f).",
                        epoch + 1,
                        self.early_stopping_patience,
                        (best_epoch_idx or 0) + 1,
                        best_val_loss,
                    )
                    break

            epochs_s = time.time() - t_epochs

            # Restore the best-val_loss classifier whenever early stopping is
            # on, so a full-budget run ships the best snapshot too.
            if (
                self.early_stopping_patience is not None
                and best_clf_snapshot is not None
                and best_epoch_idx != epoch
            ):
                logger.info(
                    "Restoring classifier from epoch %d (val_loss=%.4f);"
                    " latest epoch was %d epochs past best.",
                    (best_epoch_idx or 0) + 1,
                    best_val_loss,
                    epochs_since_best,
                )
                clf = best_clf_snapshot
            self._early_stop_info = {
                "enabled": self.early_stopping_patience is not None,
                "patience": self.early_stopping_patience,
                "stop_reason": stop_reason,
                "final_epoch": epoch + 1,
                "best_val_epoch": (
                    best_epoch_idx + 1 if best_epoch_idx is not None else None
                ),
                "best_val_loss": (
                    best_val_loss if best_val_loss != float("inf") else None
                ),
            }
        if (
            self.device_resident
            and self._resident_buffer is not None
            and getattr(clf, "_resident_X", None) is None
        ):
            # A snapshot restored from a checkpoint has no buffer: re-attach
            # the buffer, its scale and what the resident paths read.
            clf._resident_X = self._resident_buffer
            clf._resident_scale = self._resident_buffer_scale
            clf._resident_dtype = self._resident_buffer_dtype
            clf._resident_n_rows = self._resident_buffer_n_rows

        t_calib = time.time()
        with _log_entry_and_exit("calibration"):
            clf_calibrated = self._calibrate_in_batches(clf, labels.ref)
        calibration_s = time.time() - t_calib
        classes = list(clf_calibrated.classes_)

        t_eval = time.time()
        with _log_entry_and_exit("final val evaluation"):
            val_gts, val_ests, val_scores = self._evaluate_calibrated(
                clf_calibrated, labels.val
            )
        final_eval_s = time.time() - t_eval

        if self.resident_timings is not None:
            # How the seconds after staging split across the epoch loop,
            # calibration and the final evaluation.
            self.resident_timings.update(
                {
                    "epochs_seconds": round(epochs_s, 1),
                    "epochs_run": float(max(epoch + 1 - start_epoch, 0)),
                    "calibration_seconds": round(calibration_s, 1),
                    "final_eval_seconds": round(final_eval_s, 1),
                }
            )

        # Previous classifiers on the validation set.
        pc_accs = []
        for pc_model in pc_models:
            pc_gts, pc_ests, _ = evaluate_classifier(
                pc_model, labels.val, batch_size=self.batch_size
            )
            pc_accs.append(accuracy_score(pc_gts, pc_ests))

        val_results = ValResults(
            scores=val_scores,
            gt=[classes.index(member) for member in val_gts],
            est=[classes.index(member) for member in val_ests],
            classes=classes,
        )

        return_message = TrainClassifierReturnMsg(
            acc=accuracy_score(val_gts, val_ests),
            pc_accs=pc_accs,
            ref_accs=ref_accs,
            runtime=time.time() - t0,
        )

        # The whole call succeeded: only now has the checkpoint served its
        # purpose (a preemption during calibration resumes from the final
        # epoch, not epoch zero).
        self._clear_checkpoint()

        return clf_calibrated, val_results, return_message

    @staticmethod
    def _probe_feature_dim(split: ImageLabels) -> int:
        """Feature dimensionality from the split's first image."""
        first_key = sorted(split.data.keys())[0]
        x, _ = split.load_image_data(first_key)
        return int(x.shape[1])

    def _resident_offset(self, labels: ImageLabels) -> int | None:
        """This split's row offset into the combined resident buffer, or
        None when the run is not device-resident."""
        offsets = getattr(self, "_resident_split_offsets", None)
        if not offsets:
            return None
        for split_obj, pos in offsets.values():
            if split_obj is labels:
                return pos
        return None

    def resident_artifact_val_proba(
        self, clf, labels: ImageLabels, head: dict
    ) -> tuple[np.ndarray, list] | None:
        """The exported artifact's head (``HeadParams.as_tensors``) over the
        resident rows of ``labels`` in one gather: (val_proba float64, gt
        labels in canonical row order), or None when the split is not
        resident (the caller streams from disk). The order is
        ``iter_index_batches``', which is ``load_data_in_batches``'."""
        offset = self._resident_offset(labels)
        if offset is None:
            return None
        n = labels.label_count
        batch = next(iter(labels.iter_index_batches(batch_size=n)), None)
        if batch is None:
            return None
        idx, gt = batch
        proba = clf.predict_proba_resident_head(head, idx + offset)
        return proba, list(gt)

    def _iter_proba_batches(self, clf, labels: ImageLabels):
        """Yield (proba, y) per batch: resident gathers when the split is on
        the device, disk streaming otherwise, with the same batch
        boundaries and label order."""
        offset = self._resident_offset(labels)
        if offset is not None:
            for idx, y in labels.iter_index_batches(batch_size=self.batch_size):
                yield clf.predict_proba_resident(idx + offset), y
        else:
            for x, y in labels.load_data_in_batches(batch_size=self.batch_size):
                yield clf.predict_proba(x), y

    def _evaluate_calibrated(
        self,
        clf_calibrated: CalibratedClassifier,
        labels: ImageLabels,
    ) -> tuple[list[str], list[str], list[float]]:
        """``evaluate_classifier``, with the uncalibrated scores read from
        the resident rows when ``labels`` is on the device (only (N, K)
        probabilities cross back); ``calibrate_scores`` is what
        ``predict_proba`` applies after the estimator's forward. A
        reduced-precision buffer evaluates its storage-rounded rows, the
        rows every in-run eval and the calibration read."""
        if self._resident_offset(labels) is None:
            return evaluate_classifier(
                clf_calibrated, labels, batch_size=self.batch_size
            )
        classes = list(clf_calibrated.classes_)
        gts: list[str] = []
        ests: list[str] = []
        scores: list[float] = []
        for uncalibrated, y in self._iter_proba_batches(
            clf_calibrated.estimator, labels
        ):
            proba = clf_calibrated.calibrate_scores(uncalibrated)
            top = np.argmax(proba, axis=1)
            gts.extend(y)
            ests.extend(classes[i] for i in top)
            scores.extend(float(proba[i, j]) for i, j in enumerate(top))
        return gts, ests, scores

    def _resident_eval_batched(
        self,
        clf: MLPClassifier,
        labels: ImageLabels,
        cache: dict[int, list],
    ) -> tuple[float, float] | None:
        """Per-epoch (accuracy, uncalibrated log loss) through the fused
        device eval when the split is resident (two float32 scalars per
        batch), or None (the caller streams from disk). The accuracy equals
        the streamed ``accuracy_score``; the loss is sklearn's formula
        reduced in float32, close to the float64 host value and
        decision-equal for early stopping. Batches follow
        ``iter_index_batches``, cached for the call."""
        offset = self._resident_offset(labels)
        if offset is None:
            return None
        key = id(labels)
        batches = cache.get(key)
        if batches is None:
            class_pos = {c: i for i, c in enumerate(clf.classes_)}
            batches = []
            for idx, y in labels.iter_index_batches(batch_size=self.batch_size):
                y_idx = np.fromiter(
                    (class_pos.get(v, -1) for v in y),
                    dtype=np.int32,
                    count=len(y),
                )
                batches.append(
                    (np.asarray(idx, dtype=np.int32) + offset, y_idx)
                )
            cache[key] = batches
        correct = 0.0
        neg_log_sum = 0.0
        total = 0
        for idx_arr, y_arr in batches:
            counts = clf.eval_counts_resident(idx_arr, y_arr)
            correct += float(counts[0])
            neg_log_sum += float(counts[1])
            total += int(idx_arr.shape[0])
        if total == 0:
            return None
        return correct / total, neg_log_sum / total

    def _calc_acc_batched(self, clf: MLPClassifier, labels: ImageLabels) -> float:
        """Batched accuracy: only predictions accumulate. A resident split
        takes the argmax on the device and reads back (N,) int32."""
        gt: list[str] = []
        pred: list[str] = []
        clf_classes = np.asarray(clf.classes_)
        offset = self._resident_offset(labels)
        if offset is not None:
            for idx, y in labels.iter_index_batches(batch_size=self.batch_size):
                pred.extend(clf_classes[clf.predict_indices_resident(idx + offset)])
                gt.extend(y)
            return accuracy_score(gt, pred)
        for proba, y in self._iter_proba_batches(clf, labels):
            pred.extend(clf_classes[np.argmax(proba, axis=1)])
            gt.extend(y)
        return accuracy_score(gt, pred)

    def _calc_acc_and_log_loss_batched(
        self,
        clf: MLPClassifier,
        labels: ImageLabels,
        classes_list: list[Any],
    ) -> tuple[float, float]:
        """Batched accuracy and log loss in one pass."""
        gt: list[Any] = []
        all_proba: list[np.ndarray] = []
        for proba, y in self._iter_proba_batches(clf, labels):
            all_proba.append(proba)
            gt.extend(y)
        proba = all_proba[0] if len(all_proba) == 1 else np.vstack(all_proba)
        clf_classes = list(clf.classes_)
        pred = [clf_classes[i] for i in proba.argmax(axis=1)]
        acc = accuracy_score(gt, pred)
        # labels= keeps the columns right when a class is absent from the
        # eval set.
        loss = log_loss(gt, proba, labels=clf_classes)
        return acc, loss

    def _calibrate_in_batches(
        self,
        clf: MLPClassifier,
        ref_labels: ImageLabels,
    ) -> CalibratedClassifier:
        """Calibration from batched uncalibrated ref scores: O(N x K) held,
        never O(N x 4096)."""
        all_preds: list[np.ndarray] = []
        all_y: list[np.ndarray] = []

        for preds, y_batch in self._iter_proba_batches(clf, ref_labels):
            # Binary: the calibrator takes the positive-class column.
            if len(clf.classes_) == 2:
                preds = preds[:, 1:]
            all_preds.append(preds)
            all_y.append(np.asarray(y_batch))

        predictions = np.vstack(all_preds)
        y = np.concatenate(all_y)
        if self.calibration_method == "temperature":
            return TemperatureCalibratedClassifier.fit_from_scores(
                clf, predictions, y
            )
        return CalibratedClassifier.fit_from_scores(
            clf, predictions, y, backend=self.calibration_backend,
            device=self.device,
        )

    def serialize(self) -> dict[str, Any]:
        return {
            "trainer": type(self).__name__,
            "batch_size": self.batch_size,
            # on_epoch_end is not JSON-serializable; excluded.
        }
