"""The port's MermaidTrainer against the JAX one, and its own contracts, on
the CPU, over seeded feature files (``build_synthetic_labels``, then each
package's ``preprocess_labels``).

Tolerances, each stated where it is asserted:

- the port against JAX, from the shared sklearn init, streamed and resident
  f32: ref accuracies equal, the early-stop record equal (its best loss
  within rel 1e-4), the per-epoch val loss within rtol 1e-4, the calibrated
  val probabilities within atol 1e-4;
- within the port: resident against streamed bitwise (weights, loss curve,
  calibration, final scores), resume bitwise, in one mode and across modes;
- the numpy ``accuracy_score`` and ``log_loss`` against sklearn's: accuracy
  exact, log loss within rel 1e-12 (the same float64 formula).
"""

import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.train.mlp_classifier import MLPClassifier as JMLP
from mermaid_classifier_tpu.train.trainer import MermaidTrainer as JTrainer
from mermaid_classifier_tpu_torch.data.labels import evaluate_classifier
from mermaid_classifier_tpu_torch.train.calibration import (
    CalibratedClassifier,
    TemperatureCalibratedClassifier,
)
from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier as TMLP
from mermaid_classifier_tpu_torch.train.trainer import (
    CheckpointMismatchError,
    MermaidTrainer,
    _FilledPrefix,
    accuracy_score,
    log_loss,
)

from tests.torch_training_data import synthetic_tasks


class SmallNetTrainer(MermaidTrainer):
    """The production trainer with a (16,) head, on the CPU."""

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)

    def _make_classifier(self, class_weight):
        return TMLP(hidden_layer_sizes=(16,), learning_rate_init=1e-2,
                    class_weight=class_weight, random_state=0, device="cpu")


class SklearnInitTrainer(SmallNetTrainer):
    def _make_classifier(self, class_weight):
        return TMLP(hidden_layer_sizes=(16,), learning_rate_init=1e-2,
                    class_weight=class_weight, random_state=0, init="sklearn",
                    device="cpu")


class JaxSklearnInitTrainer(JTrainer):
    def _make_classifier(self, class_weight):
        return JMLP(hidden_layer_sizes=(16,), learning_rate_init=1e-2,
                    class_weight=class_weight, random_state=0, init="sklearn")


@pytest.fixture()
def both(tmp_path):
    return synthetic_tasks(tmp_path, n_images=40, pts_per_image=10,
                           n_classes=3, dim=8, seed=0)


@pytest.fixture()
def task_labels(both):
    return both[1]


def _val_proba(clf_cal, labels):
    x, _ = labels.val.load_all()
    return clf_cal.predict_proba(x)


@pytest.mark.parametrize("resident", [False, True])
def test_trainer_matches_jax(both, resident):
    """The port's trainer and the JAX one from the same sklearn init, with
    early stopping and a class weighting: the same decisions, the numbers
    within the stated tolerances."""
    jlabels, tlabels = both
    classes = sorted(tlabels.ref.classes_set)
    kw = dict(batch_size=64, early_stopping_patience=2, device_resident=resident,
              class_weight={c: 1.0 + 0.5 * i for i, c in enumerate(classes)})
    jseen, tseen = [], []
    jt = JaxSklearnInitTrainer(on_epoch_end=jseen.append, **kw)
    tt = SklearnInitTrainer(on_epoch_end=tseen.append, **kw)
    jcal, jval, jmsg = jt(jlabels, nbr_epochs=5, pc_models=[])
    tcal, tval, tmsg = tt(tlabels, nbr_epochs=5, pc_models=[])

    assert tmsg.ref_accs == jmsg.ref_accs
    tinfo, jinfo = dict(tt._early_stop_info), dict(jt._early_stop_info)
    assert tinfo.pop("best_val_loss") == pytest.approx(jinfo.pop("best_val_loss"),
                                                       rel=1e-4)
    assert tinfo == jinfo
    assert len(tseen) == len(jseen)
    for t, j in zip(tseen, jseen):
        assert t.keys() == j.keys()
        assert t["val_loss"] == pytest.approx(j["val_loss"], rel=1e-4)
        assert t["ref_accuracy"] == j["ref_accuracy"]
        assert t["training_loss"] == pytest.approx(j["training_loss"], rel=1e-4)
    np.testing.assert_allclose(_val_proba(tcal, tlabels), _val_proba(jcal, jlabels),
                               atol=1e-4)
    np.testing.assert_allclose(tval.scores, jval.scores, atol=1e-4)
    assert tval.gt == jval.gt and tval.classes == jval.classes
    assert tmsg.acc == jmsg.acc


@pytest.mark.parametrize("method", ["sigmoid", "temperature"])
def test_calibration_matches_jax(both, method):
    jlabels, tlabels = both
    jt = JaxSklearnInitTrainer(batch_size=32, calibration_method=method)
    tt = SklearnInitTrainer(batch_size=32, calibration_method=method)
    jcal, _, _ = jt(jlabels, nbr_epochs=3, pc_models=[])
    tcal, _, _ = tt(tlabels, nbr_epochs=3, pc_models=[])
    assert type(tcal).__name__ == type(jcal).__name__
    np.testing.assert_allclose(_val_proba(tcal, tlabels), _val_proba(jcal, jlabels),
                               atol=1e-4)


class TestEndToEnd:
    def test_training_run(self, task_labels):
        epochs_seen = []
        trainer = SmallNetTrainer(batch_size=64, on_epoch_end=epochs_seen.append)
        clf_cal, val_results, msg = trainer(task_labels, nbr_epochs=8, pc_models=[])
        assert isinstance(clf_cal, CalibratedClassifier)
        assert len(msg.ref_accs) == 8
        assert msg.acc > 0.8  # separable clusters
        assert msg.runtime > 0
        assert len(epochs_seen) == 8
        assert "final_epoch" not in epochs_seen[0]
        assert epochs_seen[-1]["final_epoch"] == 8
        assert epochs_seen[-1]["early_stopped"] is False
        assert len(val_results.scores) == task_labels.val.label_count
        assert val_results.classes == sorted(task_labels.ref.classes_set)
        info = trainer._early_stop_info
        assert info["enabled"] is False
        assert info["stop_reason"] == "budget_exhausted"
        assert info["final_epoch"] == 8
        assert trainer.serialize() == {"trainer": "SmallNetTrainer", "batch_size": 64}

    def test_previous_classifier_accs(self, task_labels):
        trainer = SmallNetTrainer(batch_size=64)
        clf_cal, _, _ = trainer(task_labels, nbr_epochs=2, pc_models=[])
        _, _, msg = trainer(task_labels, nbr_epochs=1, pc_models=[clf_cal])
        assert len(msg.pc_accs) == 1
        assert 0.0 <= msg.pc_accs[0] <= 1.0

    @pytest.mark.parametrize("kw, match", [
        (dict(early_stopping_patience=0), "early_stopping_patience"),
        (dict(calibration_method="platt"), "calibration_method"),
        (dict(resident_dtype="float16"), "resident dtype"),
    ])
    def test_invalid_arguments(self, kw, match):
        with pytest.raises(ValueError, match=match):
            MermaidTrainer(batch_size=10, device="cpu", **kw)

    def test_packed_cache_is_not_ported(self, tmp_path):
        with pytest.raises(NotImplementedError, match="packed"):
            MermaidTrainer(batch_size=10, device="cpu", packed_cache_dir=str(tmp_path))

    def test_default_device_is_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            MermaidTrainer(batch_size=10)


class ScriptedValLossTrainer(SmallNetTrainer):
    """A scripted val loss sequence, so the early-stopping state machine is
    deterministic (the resident loop's fused val eval is scripted too)."""

    def __init__(self, scripted_losses, **kwargs):
        super().__init__(**kwargs)
        self.scripted_losses = list(scripted_losses)
        self._call_idx = 0

    def _next(self):
        loss = self.scripted_losses[self._call_idx]
        self._call_idx += 1
        return 0.5, loss

    def _calc_acc_and_log_loss_batched(self, clf, labels, classes_list):
        return self._next()

    def _resident_eval_batched(self, clf, labels, cache):
        offsets = self._resident_split_offsets or {}
        if labels is offsets.get("val", (None, 0))[0]:
            return self._next()
        return super()._resident_eval_batched(clf, labels, cache)


def _batches_per_epoch(labels):
    return len(list(labels.train.iter_index_batches(batch_size=64, random_seed=0)))


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("losses, epochs, patience, want", [
    # best at epoch 2, then two non-improving epochs: stop at 4.
    ([0.5, 0.4, 0.6, 0.7, 0.3, 0.2], 6, 2, ("early_stopping", 4, 2, 0.4)),
    # the budget runs out, the best snapshot is still restored.
    ([0.5, 0.3, 0.6, 0.55], 4, 5, ("budget_exhausted", 4, 2, 0.3)),
    # the last epoch is the best: nothing to restore.
    ([0.5, 0.4, 0.3], 3, 2, ("budget_exhausted", 3, 3, 0.3)),
])
def test_early_stopping_matrix(task_labels, resident, losses, epochs, patience, want):
    trainer = ScriptedValLossTrainer(losses, batch_size=64, device_resident=resident,
                                     early_stopping_patience=patience)
    clf_cal, _, _ = trainer(task_labels, nbr_epochs=epochs, pc_models=[])
    info = trainer._early_stop_info
    assert (info["stop_reason"], info["final_epoch"], info["best_val_epoch"],
            info["best_val_loss"]) == want
    # The restored classifier saw exactly best_val_epoch epochs of batches.
    assert clf_cal.estimator.n_iter_ == want[2] * _batches_per_epoch(task_labels)
    if resident:
        assert clf_cal.estimator._resident_X is not None


def test_callback_summary_fields_on_early_stop(task_labels):
    seen = []
    trainer = ScriptedValLossTrainer([0.5, 0.6, 0.7], batch_size=64,
                                     early_stopping_patience=2,
                                     on_epoch_end=seen.append)
    trainer(task_labels, nbr_epochs=10, pc_models=[])
    assert len(seen) == 3
    assert "final_epoch" not in seen[0]
    assert seen[-1]["early_stopped"] is True
    assert seen[-1]["best_val_epoch"] == 1
    assert seen[-1]["best_val_loss"] == 0.5


def test_batched_calibration_equals_whole(task_labels):
    trainer = SmallNetTrainer(batch_size=32)
    clf_cal, _, _ = trainer(task_labels, nbr_epochs=3, pc_models=[])
    clf = clf_cal.estimator
    x_ref, y_ref = task_labels.ref.load_all()
    whole = CalibratedClassifier.fit_from_scores(clf, clf.predict_proba(x_ref),
                                                 np.asarray(y_ref))
    np.testing.assert_allclose(clf_cal.calibration_a_, whole.calibration_a_, rtol=1e-8)
    np.testing.assert_allclose(clf_cal.calibration_b_, whole.calibration_b_, rtol=1e-8)


def test_temperature_calibrator(task_labels):
    """The streamed temperature fit equals a whole-ref fit (rel 1e-6) and
    its ref NLL is no worse than uncalibrated."""
    trainer = SmallNetTrainer(batch_size=32, calibration_method="temperature")
    clf_cal, _, _ = trainer(task_labels, nbr_epochs=3, pc_models=[])
    assert isinstance(clf_cal, TemperatureCalibratedClassifier)
    clf = clf_cal.estimator
    x_ref, y_ref = task_labels.ref.load_all()
    uncal = clf.predict_proba(x_ref)
    whole = TemperatureCalibratedClassifier.fit_from_scores(clf, uncal, np.asarray(y_ref))
    assert clf_cal.temperature_ == pytest.approx(whole.temperature_, rel=1e-6)
    labels_sorted = sorted(set(y_ref))
    assert (log_loss(y_ref, clf_cal.calibrate_scores(uncal), labels=labels_sorted)
            <= log_loss(y_ref, uncal, labels=labels_sorted) + 1e-9)


class Crash(RuntimeError):
    pass


def _crash_at(epoch):
    def cb(metrics):
        if metrics["epoch"] == epoch:
            raise Crash()

    return cb


def _interrupt(labels, ckpt, epochs, at, trainer_cls=SmallNetTrainer, **kw):
    with pytest.raises(Crash):
        trainer_cls(batch_size=64, checkpoint_dir=str(ckpt),
                    on_epoch_end=_crash_at(at), **kw)(labels, nbr_epochs=epochs,
                                                      pc_models=[])
    assert (ckpt / "trainer_checkpoint.pkl").is_file()


@pytest.mark.parametrize("first, then", [(False, False), (True, True),
                                         (False, True), (True, False)])
def test_resume_is_bit_identical(task_labels, tmp_path, first, then):
    """Crash after epoch 3's checkpoint, resume: the run equals an
    uninterrupted one bit for bit, in one mode and across modes (the
    checkpoint carries model state, never data)."""
    clf_a, _, msg_a = SmallNetTrainer(batch_size=64)(task_labels, nbr_epochs=5,
                                                      pc_models=[])
    ckpt = tmp_path / "ckpt"
    _interrupt(task_labels, ckpt, 5, 2, device_resident=first)
    resumed = SmallNetTrainer(batch_size=64, checkpoint_dir=str(ckpt),
                              device_resident=then)
    clf_b, _, msg_b = resumed(task_labels, nbr_epochs=5, pc_models=[])
    est_a, est_b = clf_a.estimator, clf_b.estimator
    assert est_a.loss_curve_ == est_b.loss_curve_
    assert msg_a.ref_accs == msg_b.ref_accs
    for wa, wb in zip(est_a.coefs_, est_b.coefs_):
        np.testing.assert_array_equal(wa, wb)
    np.testing.assert_array_equal(clf_a.calibration_a_, clf_b.calibration_a_)
    assert not (ckpt / "trainer_checkpoint.pkl").exists()


def test_resume_preserves_early_stopping_state(task_labels, tmp_path):
    ckpt = tmp_path / "ckpt"
    _interrupt(task_labels, ckpt, 10, 3, early_stopping_patience=2)
    resumed = SmallNetTrainer(batch_size=64, checkpoint_dir=str(ckpt),
                              early_stopping_patience=2)
    _, _, msg = resumed(task_labels, nbr_epochs=10, pc_models=[])
    straight = SmallNetTrainer(batch_size=64, early_stopping_patience=2)
    _, _, msg_ref = straight(task_labels, nbr_epochs=10, pc_models=[])
    assert resumed._early_stop_info == straight._early_stop_info
    assert msg.ref_accs == msg_ref.ref_accs


def test_resume_of_the_last_epoch(task_labels, tmp_path):
    """The callback of epoch 4 (of 4) runs before its checkpoint: the
    resumed call trains that one epoch, resident, and keeps the three
    checkpointed accuracies."""
    ckpt = tmp_path / "ckpt"
    _interrupt(task_labels, ckpt, 4, 3)
    resumed = SmallNetTrainer(batch_size=64, checkpoint_dir=str(ckpt),
                              device_resident=True)
    _, _, msg = resumed(task_labels, nbr_epochs=4, pc_models=[])
    assert len(msg.ref_accs) == 4
    assert resumed._early_stop_info["final_epoch"] == 4
    assert resumed.resident_timings["epochs_run"] == 1.0


def test_resume_resident_int8_restores_best_snapshot(task_labels, tmp_path):
    """A best snapshot restored from a checkpoint has no buffer: the int8
    buffer and its scale are re-attached before calibration."""
    ckpt = tmp_path / "ckpt"
    kw = dict(early_stopping_patience=2, device_resident=True, resident_dtype="int8")
    with pytest.raises(Crash):
        ScriptedValLossTrainer([0.5, 0.4, 0.6, 0.7, 0.8], batch_size=64,
                               checkpoint_dir=str(ckpt), on_epoch_end=_crash_at(3),
                               **kw)(task_labels, nbr_epochs=10, pc_models=[])
    resumed = ScriptedValLossTrainer([0.7, 0.8, 0.9, 1.0, 1.1], batch_size=64,
                                     checkpoint_dir=str(ckpt), **kw)
    clf_cal, _, msg = resumed(task_labels, nbr_epochs=10, pc_models=[])
    info = resumed._early_stop_info
    assert info["stop_reason"] == "early_stopping"
    assert info["best_val_epoch"] == 2
    est = clf_cal.estimator
    assert est._resident_X is not None and est._resident_X.dtype == torch.int8
    assert est._resident_scale is not None
    assert est._resident_dtype == "int8"
    assert np.isfinite(msg.acc)


def test_refuses_checkpoint_from_different_run(task_labels, tmp_path):
    ckpt = tmp_path / "ckpt"
    _interrupt(task_labels, ckpt, 4, 1)
    with pytest.raises(CheckpointMismatchError, match="different run"):
        SmallNetTrainer(batch_size=32, checkpoint_dir=str(ckpt))(
            task_labels, nbr_epochs=4, pc_models=[])

    class OtherArchTrainer(SmallNetTrainer):
        def _make_classifier(self, class_weight):
            return TMLP(hidden_layer_sizes=(8, 8), learning_rate_init=1e-2,
                        class_weight=class_weight, random_state=0, device="cpu")

    with pytest.raises(CheckpointMismatchError, match="different run"):
        OtherArchTrainer(batch_size=64, checkpoint_dir=str(ckpt))(
            task_labels, nbr_epochs=4, pc_models=[])
    # The matching configuration resumes.
    _, _, msg = SmallNetTrainer(batch_size=64, checkpoint_dir=str(ckpt))(
        task_labels, nbr_epochs=4, pc_models=[])
    assert len(msg.ref_accs) == 4


class TestDeviceResidentTrainer:
    def test_resident_matches_streamed(self, task_labels):
        streamed = SmallNetTrainer(batch_size=64, early_stopping_patience=3)
        clf_a, val_a, msg_a = streamed(task_labels, nbr_epochs=5, pc_models=[])
        resident = SmallNetTrainer(batch_size=64, early_stopping_patience=3,
                                   device_resident=True)
        clf_b, val_b, msg_b = resident(task_labels, nbr_epochs=5, pc_models=[])
        assert msg_a.ref_accs == msg_b.ref_accs
        info_a, info_b = dict(streamed._early_stop_info), dict(resident._early_stop_info)
        assert info_b.pop("best_val_loss") == pytest.approx(
            info_a.pop("best_val_loss"), rel=1e-4)
        assert info_a == info_b
        est_a, est_b = clf_a.estimator, clf_b.estimator
        assert est_a.loss_curve_ == est_b.loss_curve_
        for wa, wb in zip(est_a.coefs_, est_b.coefs_):
            np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(clf_a.calibration_a_, clf_b.calibration_a_)
        assert val_a.to_dict() == val_b.to_dict()

    @pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
    def test_reduced_storage_close_to_streamed(self, task_labels, dtype):
        streamed = SmallNetTrainer(batch_size=64, early_stopping_patience=3)
        _, _, msg_a = streamed(task_labels, nbr_epochs=4, pc_models=[])
        resident = SmallNetTrainer(batch_size=64, early_stopping_patience=3,
                                   device_resident=True, resident_dtype=dtype)
        clf_b, _, msg_b = resident(task_labels, nbr_epochs=4, pc_models=[])
        assert str(clf_b.estimator._resident_X.dtype) == f"torch.{dtype}"
        assert msg_a.acc == pytest.approx(msg_b.acc, abs=0.05)
        np.testing.assert_allclose(msg_a.ref_accs, msg_b.ref_accs, atol=0.05)

    @pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
    def test_staging_bits_match_f32_path(self, task_labels, dtype):
        """The trainer stages in the storage dtype; its buffer equals the f32
        rows converted through set_resident_features."""
        trainer = SmallNetTrainer(batch_size=64, device_resident=True,
                                  resident_dtype=dtype)
        clf_cal, _, _ = trainer(task_labels, nbr_epochs=1, pc_models=[])
        est = clf_cal.estimator
        spans = [s for s in (task_labels.train, task_labels.ref, task_labels.val)
                 if len(s)]
        f32 = np.empty((sum(s.label_count for s in spans), est._resident_X.shape[1]),
                       np.float32)
        off = 0
        for s in spans:
            s.load_into(f32, off)
            off += s.label_count
        ref = TMLP((8,), random_state=0, device="cpu")
        ref.set_resident_features(f32, dtype=dtype)
        assert torch.equal(est._resident_X, ref._resident_X)
        if dtype == "int8":
            assert torch.equal(est._resident_scale, ref._resident_scale)

    @pytest.mark.parametrize("calibration", ["sigmoid", "temperature"])
    def test_artifact_val_proba_matches_disk(self, task_labels, tmp_path, calibration):
        """The exported head over the resident val rows equals the loaded
        Predictor on the disk rows (atol 1e-6), same row order."""
        from mermaid_classifier_tpu_torch.inference import (
            export_artifact,
            load_predictor,
        )

        trainer = SmallNetTrainer(batch_size=64, device_resident=True,
                                  calibration_method=calibration)
        clf_cal, _, _ = trainer(task_labels, nbr_epochs=2, pc_models=[])
        x_val, y_val = task_labels.val.load_all()
        export_artifact(clf_cal, tmp_path, x_val, enforce_torch_pin=False)
        predictor = load_predictor(tmp_path, device="cpu")
        res = trainer.resident_artifact_val_proba(
            clf_cal.estimator, task_labels.val, predictor.head_params.as_tensors("cpu"))
        assert res is not None
        proba, gt = res
        assert gt == y_val
        np.testing.assert_allclose(proba, predictor.predict_proba(x_val), atol=1e-6)

    def test_artifact_val_proba_none_when_streamed(self, task_labels):
        trainer = SmallNetTrainer(batch_size=64)
        clf_cal, _, _ = trainer(task_labels, nbr_epochs=1, pc_models=[])
        assert trainer.resident_artifact_val_proba(clf_cal.estimator,
                                                   task_labels.val, {}) is None

    def test_final_eval_resident_matches_disk(self, task_labels):
        trainer = SmallNetTrainer(batch_size=64, device_resident=True)
        clf_cal, val_results, _ = trainer(task_labels, nbr_epochs=2, pc_models=[])
        gts, ests, scores = evaluate_classifier(clf_cal, task_labels.val, batch_size=64)
        classes = list(clf_cal.classes_)
        assert val_results.gt == [classes.index(g) for g in gts]
        assert val_results.est == [classes.index(e) for e in ests]
        np.testing.assert_array_equal(val_results.scores, scores)

    def test_timings_recorded(self, task_labels):
        trainer = SmallNetTrainer(batch_size=64, device_resident=True)
        trainer(task_labels, nbr_epochs=2, pc_models=[])
        t = trainer.resident_timings
        assert t["epochs_run"] == 2.0
        assert t["rows"] == task_labels.label_count
        for key in ("load_seconds", "quantize_seconds", "upload_stage_seconds",
                    "epochs_seconds", "calibration_seconds", "final_eval_seconds"):
            assert t[key] >= 0.0
        assert 0.0 <= t["upload_extra_wait_seconds"] <= t["upload_stage_seconds"] + 0.2
        assert not any(key.startswith("warm") for key in t)
        streamed = SmallNetTrainer(batch_size=64)
        streamed(task_labels, nbr_epochs=1, pc_models=[])
        assert streamed.resident_timings is None

    def test_device_calibration_backend_close_to_scipy(self, task_labels):
        clf_a, _, msg_a = SmallNetTrainer(batch_size=64)(task_labels, nbr_epochs=2,
                                                         pc_models=[])
        clf_b, _, msg_b = SmallNetTrainer(batch_size=64, calibration_backend="device")(
            task_labels, nbr_epochs=2, pc_models=[])
        for wa, wb in zip(clf_a.estimator.coefs_, clf_b.estimator.coefs_):
            np.testing.assert_array_equal(wa, wb)
        np.testing.assert_allclose(clf_b.calibration_a_, clf_a.calibration_a_,
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(clf_b.calibration_b_, clf_a.calibration_b_,
                                   rtol=2e-3, atol=2e-4)
        assert msg_a.acc == pytest.approx(msg_b.acc, abs=1e-3)


class TestFilledPrefix:
    def test_out_of_order_spans_advance_contiguously(self):
        t = _FilledPrefix(10)
        t.add(4, 3)
        assert t._watermark == 0
        t.add(0, 4)
        assert t._watermark == 7
        t.add(7, 3)
        assert t._watermark == 10
        t.wait(10)
        t.wait(10 ** 9)  # clamps to the total

    def test_wait_blocks_until_published(self):
        import threading
        import time

        t = _FilledPrefix(6)
        seen = []
        th = threading.Thread(target=lambda: (t.wait(6), seen.append("done")),
                              daemon=True)
        th.start()
        time.sleep(0.05)
        assert seen == []
        t.add(0, 3)
        t.add(3, 3)
        th.join(timeout=5)
        assert not th.is_alive() and seen == ["done"]

    def test_fail_aborts_waiters(self):
        import threading

        t = _FilledPrefix(8)
        errs = []

        def waiter():
            try:
                t.wait(8)
            except RuntimeError as exc:
                errs.append(exc)

        th = threading.Thread(target=waiter, daemon=True)
        th.start()
        t.fail(FileNotFoundError("gone.npz"))
        th.join(timeout=5)
        assert not th.is_alive()
        assert len(errs) == 1 and isinstance(errs[0].__cause__, FileNotFoundError)


def test_fill_failure_propagates_without_hang(task_labels):
    import os

    os.remove(sorted(task_labels.train.data.keys())[2])
    with pytest.raises(FileNotFoundError):
        SmallNetTrainer(batch_size=64, device_resident=True)(task_labels, nbr_epochs=2,
                                                             pc_models=[])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_upload_failure_surfaces(task_labels, monkeypatch, dtype):
    boom = MemoryError("device memory exhausted")

    def raising(*a, **k):
        raise boom

    name = "set_resident_features" if dtype == "float32" else "set_resident_features_storage"
    monkeypatch.setattr(TMLP, name, raising)
    trainer = SmallNetTrainer(batch_size=64, device_resident=True, resident_dtype=dtype)
    with pytest.raises(BaseException) as excinfo:
        trainer(task_labels, nbr_epochs=2, pc_models=[])
    assert excinfo.value is boom or excinfo.value.__cause__ is boom


def _metric_cases():
    rng = np.random.default_rng(0)
    labels = np.asarray(["a", "b", "c", "d"])
    y = labels[rng.integers(0, 4, 50)]
    raw = rng.random((50, 4))
    proba = raw / raw.sum(axis=1, keepdims=True)
    proba[0] = [1.0, 0.0, 0.0, 0.0]  # exact 0 and 1: the eps clip
    binary = rng.random(30)
    return {
        "multiclass": (y, proba, list(labels)),
        "absent class": (np.where(y == "d", "a", y), proba, list(labels)),
        "binary column": (labels[:2][rng.integers(0, 2, 30)], binary, ["a", "b"]),
        "binary two columns": (labels[:2][rng.integers(0, 2, 30)],
                               np.stack([1 - binary, binary], 1), ["a", "b"]),
    }


@pytest.mark.parametrize("case", list(_metric_cases()))
def test_metrics_match_sklearn(case):
    from sklearn.metrics import accuracy_score as sk_acc
    from sklearn.metrics import log_loss as sk_log_loss

    y, proba, labels = _metric_cases()[case]
    assert log_loss(y, proba, labels=labels) == pytest.approx(
        sk_log_loss(y, proba, labels=labels), rel=1e-12)
    pred = np.asarray(labels)[np.round(proba).astype(int)] if proba.ndim == 1 else \
        np.asarray(labels)[proba.argmax(axis=1)]
    assert accuracy_score(y, pred) == sk_acc(y, pred)
    assert accuracy_score(list(y), list(pred)) == sk_acc(list(y), list(pred))


@pytest.mark.parametrize("bad", ["unknown label", "columns", "above one", "length"])
def test_log_loss_errors_match_sklearn(bad):
    from sklearn.metrics import log_loss as sk_log_loss

    y, proba, labels = _metric_cases()["multiclass"]
    args = {"unknown label": (np.where(y == "a", "z", y), proba, labels),
            "columns": (y, proba[:, :3], labels),
            "above one": (y, proba * 2, labels),
            "length": (y[:-1], proba, labels)}[bad]
    with pytest.raises(ValueError) as skerr:
        sk_log_loss(args[0], args[1], labels=args[2])
    with pytest.raises(ValueError) as err:
        log_loss(args[0], args[1], labels=args[2])
    assert str(err.value).split(":")[0] == str(skerr.value).split(":")[0]
