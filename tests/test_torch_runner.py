"""The port's ``TrackingTrainingRunner`` against the JAX one on the CPU.

Both runners take the same seeded ETL environment
(``tests/torch_recipe_env``, taxonomy through the fixture-file route), a
head shrunk to (16,) from the shared sklearn init (the ``_make_trainer``
hook), effective-number weighting and a stratified subsample, resident and
streamed. Both run with the default ``use_packed_feature_cache=True``, so
each streamed run packs its splits first. Held, each as stated:

- the logged params equal (the ``system/*`` facts aside),
  ``artifact_eval_inputs`` included;
- the dataset, split, weighting and audit tables equal byte for byte;
- per-epoch val and training losses within rel 1e-4, ref accuracies equal
  (``tests/test_torch_trainer.py``'s bounds);
- the registered artifacts' calibrated probabilities within atol 1e-4, the
  val results' gt / est equal and their scores within 1e-4;
- the port's export parity <= 1e-6, the nine metric groups timed and the
  same metric names logged as the JAX run;
- two runs register v1 then v2, and ``models:/`` serves them through the
  port's ``AnnotationRun``.
"""

import json
import os

import numpy as np
import pytest

from mermaid_classifier_tpu.config import settings as jset
from mermaid_classifier_tpu.config.options import DatasetOptions as JDOpts
from mermaid_classifier_tpu.config.options import TrackingOptions as JKOpts
from mermaid_classifier_tpu.config.options import TrainingOptions as JTOpts
from mermaid_classifier_tpu.data.subsample import SubsampleOptions as JSub
from mermaid_classifier_tpu.inference import load_predictor as jload
from mermaid_classifier_tpu.tracking.local_tracker import LocalTracker as JTracker
from mermaid_classifier_tpu.train.class_weights import SampleWeightingOptions as JW
from mermaid_classifier_tpu.train.mlp_classifier import MLPClassifier as JMLP
from mermaid_classifier_tpu.train.runner import TrackingTrainingRunner as JRunner
from mermaid_classifier_tpu.train.trainer import MermaidTrainer as JTrainer
from mermaid_classifier_tpu_torch.common import taxonomy as ttax
from mermaid_classifier_tpu_torch.config.options import DatasetOptions as TDOpts
from mermaid_classifier_tpu_torch.config.options import TrackingOptions as TKOpts
from mermaid_classifier_tpu_torch.config.options import TrainingOptions as TTOpts
from mermaid_classifier_tpu_torch.config import settings as tset
from mermaid_classifier_tpu_torch.config.settings import override_settings
from mermaid_classifier_tpu_torch.data.subsample import SubsampleOptions as TSub
from mermaid_classifier_tpu_torch.inference import load_predictor as tload
from mermaid_classifier_tpu_torch.tracking.local_tracker import LocalTracker as TTracker
from mermaid_classifier_tpu_torch.train.class_weights import (
    SampleWeightingOptions as TW,
)
from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier as TMLP
from mermaid_classifier_tpu_torch.train.runner import TrackingTrainingRunner as TRunner
from mermaid_classifier_tpu_torch.train.trainer import MermaidTrainer as TTrainer

from tests.torch_recipe_env import (
    both_settings,
    build_both,
    clear_taxonomy_caches,
    write_taxonomy_fixture,
)


class JSmallTrainer(JTrainer):
    def _make_classifier(self, cw):
        return JMLP(hidden_layer_sizes=(16,), learning_rate_init=1e-2,
                    class_weight=cw, random_state=0, init="sklearn")


class TSmallTrainer(TTrainer):
    def _make_classifier(self, cw):
        return TMLP(hidden_layer_sizes=(16,), learning_rate_init=1e-2,
                    class_weight=cw, random_state=0, init="sklearn",
                    device=self.device)


class JSmallRunner(JRunner):
    def _make_trainer(self, batch_size, class_weight):
        trainer = super()._make_trainer(batch_size, class_weight)
        trainer.__class__ = JSmallTrainer
        return trainer


class TSmallRunner(TRunner):
    def _make_trainer(self, batch_size, class_weight):
        trainer = super()._make_trainer(batch_size, class_weight)
        trainer.__class__ = TSmallTrainer
        return trainer


@pytest.fixture()
def env(tmp_path, monkeypatch):
    monkeypatch.setenv(ttax.TAXONOMY_FIXTURE_ENV,
                       str(write_taxonomy_fixture(tmp_path / "taxonomy")))
    clear_taxonomy_caches()
    jstore, tstore, manifest_path, mermaid_path = build_both(
        tmp_path, n_sources=2, images_per_source=5, points_per_image=15)
    with both_settings(tmp_path, mermaid_path, batch_size=200):
        yield jstore, tstore, manifest_path, tmp_path
    clear_taxonomy_caches()


def _options(resident, manifest_path, sub_cls, w_cls, d_cls, t_cls, k_cls):
    return dict(
        dataset_options=d_cls(
            coralnet_manifest_uri=manifest_path,
            subsample=sub_cls(strategy="stratified", total_annotations=260,
                              min_per_class=12),
            weighting=w_cls(enabled=True, weight_ratio_cap=100.0)),
        training_options=t_cls(epochs=4, early_stopping_patience=2,
                               device_resident=resident,
                               calibration_backend="device"),
        tracking_options=k_cls(experiment_name="recipe", model_name="reef-mlp"),
    )


def run_port(env, resident, tracker_root, **kw):
    _, tstore, manifest_path, tmp_path = env
    runner = TSmallRunner(
        **_options(resident, manifest_path, TSub, TW, TDOpts, TTOpts, TKOpts),
        tracker=TTracker(tracker_root), store=tstore, device="cpu",
        enforce_torch_pin=False, **kw)
    msg, registered = runner.run(run_name="run")
    return runner, msg, registered


def run_jax(env, resident, tracker_root):
    jstore, _, manifest_path, tmp_path = env
    runner = JSmallRunner(
        **_options(resident, manifest_path, JSub, JW, JDOpts, JTOpts, JKOpts),
        tracker=JTracker(tracker_root), store=jstore)
    msg, registered = runner.run(run_name="run")
    return runner, msg, registered


SAME_BYTES = (
    "dataset/ba_counts.csv", "dataset/bagf_counts.csv",
    "dataset/coralnet_project_stats.csv", "dataset/mermaid_project_stats.csv",
    "dataset/coralnet_label_mapping.csv", "dataset/unmapped_labels.csv",
    "dataset/train_summary_stats.yaml", "weighting/per_class_weights.csv",
    "subsample/per_class_audit.csv", "annotations_val.csv",
    "epoch_ref_accuracies.yaml",
)
PORTED_SCALARS = ("balanced_accuracy", "mcc", "precision_macro", "recall_macro",
                  "f1_macro", "log_loss", "accuracy", "export_parity_max_abs_diff")


def _only_run(tracker):
    runs = tracker.runs("recipe")
    assert len(runs) == 1
    return runs[0]


@pytest.mark.parametrize("resident", [False, True])
def test_runner_matches_jax(env, resident):
    tmp_path = env[3]
    jrunner, jmsg, jreg = run_jax(env, resident, tmp_path / "jtrack")
    trunner, tmsg, treg = run_port(env, resident, tmp_path / "ttrack")
    jrun, trun = _only_run(JTracker(tmp_path / "jtrack")), \
        _only_run(TTracker(tmp_path / "ttrack"))

    def params(run):
        return {k: v for k, v in run.params().items()
                if not k.startswith("system/")}

    assert params(trun) == params(jrun)
    assert ("artifact_eval_inputs" in params(trun)) == resident
    assert "packed_feature_cache" not in trun.params()
    assert trun.params()["system/torch_device"] == "cpu"
    for path in SAME_BYTES:
        assert trun.artifact(path).read_bytes() == jrun.artifact(path).read_bytes(), path
    jinfo = json.loads(jrun.artifact("early_stop_info.json").read_text())
    tinfo = json.loads(trun.artifact("early_stop_info.json").read_text())
    assert tinfo.pop("best_val_loss") == pytest.approx(jinfo.pop("best_val_loss"),
                                                       rel=1e-4)
    assert tinfo == jinfo
    jman = json.loads(jrun.artifact("model/model.json").read_text())
    tman = json.loads(trun.artifact("model/model.json").read_text())
    assert {k: v for k, v in tman.items() if k != "trained_with"} == \
        {k: v for k, v in jman.items() if k != "trained_with"}

    for name in ("epoch/val_loss", "epoch/training_loss"):
        jh, th = jrun.metric_history(name), trun.metric_history(name)
        assert [h["step"] for h in th] == [h["step"] for h in jh]
        np.testing.assert_allclose([h["value"] for h in th],
                                   [h["value"] for h in jh], rtol=1e-4)
    assert [h["value"] for h in trun.metric_history("epoch/ref_accuracy")] == \
        [h["value"] for h in jrun.metric_history("epoch/ref_accuracy")]
    assert tmsg.ref_accs == jmsg.ref_accs and tmsg.acc == jmsg.acc

    jval = json.loads(jrun.artifact("valresult.json").read_text())
    tval = json.loads(trun.artifact("valresult.json").read_text())
    assert (tval["gt"], tval["est"], tval["classes"]) == \
        (jval["gt"], jval["est"], jval["classes"])
    np.testing.assert_allclose(tval["scores"], jval["scores"], atol=1e-4)

    x = np.random.default_rng(7).normal(size=(64, 8)).astype(np.float32)
    jp = jload(jreg / "model.npz", jreg / "model.json").predict_proba(x)
    tp = tload(treg, device="cpu").predict_proba(x)
    np.testing.assert_allclose(tp, jp, atol=1e-4)

    metrics = trun.latest_metrics()
    for name in PORTED_SCALARS:
        assert name in metrics, name
    assert metrics["export_parity_max_abs_diff"] <= 1e-6
    assert metrics["accuracy"] == jrun.latest_metrics()["accuracy"]
    assert any(k.startswith("weighting/") for k in metrics)
    assert "subsample/realized_total" in metrics
    assert (treg.name, json.loads((treg / "registry_meta.json").read_text())["run_id"]) \
        == ("v1", trun.run_id)
    sections = trun.artifact("profiled_sections.csv").read_text()
    for name in ("Export and parity gate", "Metrics vs shipped artifact",
                 "Training call", "Per-class subsampling"):
        assert name in sections

    def names(run):
        text = run.artifact("profiled_sections.csv").read_text()
        return [line.split(",")[0] for line in text.splitlines()]

    assert names(trun) == names(jrun)
    assert list(json.loads(trun.artifact("metrics_group_seconds.json").read_text())) \
        == list(json.loads(jrun.artifact("metrics_group_seconds.json").read_text()))
    # The system samplers and the resident stage budgets (JAX's compile
    # warm-ups) are each package's own.
    def evaluated(run):
        return {m for m in run.latest_metrics()
                if not m.startswith(("system/", "resident/"))}

    assert evaluated(trun) == evaluated(jrun)


@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("resident", [False, True])
def test_packs_only_streamed_runs_and_removes_the_cache(env, monkeypatch,
                                                        resident, use_cache):
    """A streamed run with the setting on packs every split under one
    temporary directory, trains from the packed rows and removes the
    directory when it ends; a resident run, or the setting off, packs
    nothing. The JAX runner makes the same choice."""
    seen = []

    class SpyTrainer(TSmallTrainer):
        def __call__(self, labels, *args, **kwargs):
            out = super().__call__(labels, *args, **kwargs)
            seen.append((self.packed_cache_dir,
                         self.packed_cache_dir is not None
                         and sorted(os.listdir(self.packed_cache_dir)),
                         [getattr(labels, s).packed_cache is not None
                          for s in ("train", "ref", "val")]))
            return out

    class SpyRunner(TRunner):
        def _make_trainer(self, batch_size, class_weight):
            trainer = super()._make_trainer(batch_size, class_weight)
            trainer.__class__ = SpyTrainer
            return trainer

    _, tstore, manifest_path, tmp_path = env
    jpacked = []
    jmake = JRunner._make_trainer

    def jax_make_trainer(self, *args):
        trainer = jmake(self, *args)
        jpacked.append(trainer.packed_cache_dir)
        return trainer

    monkeypatch.setattr(JRunner, "_make_trainer", jax_make_trainer)
    with override_settings(use_packed_feature_cache=use_cache), \
            jset.override_settings(use_packed_feature_cache=use_cache):
        runner = SpyRunner(
            **_options(resident, manifest_path, TSub, TW, TDOpts, TTOpts, TKOpts),
            tracker=TTracker(tmp_path / "t"), store=tstore, device="cpu",
            enforce_torch_pin=False)
        runner.run(run_name="run")
        JSmallRunner(**_options(resident, manifest_path, JSub, JW, JDOpts, JTOpts,
                                JKOpts),
                     tracker=JTracker(tmp_path / "j"), store=env[0]).run(
            run_name="run")
    (packed_dir, listing, attached), = seen
    packs = use_cache and not resident
    assert (packed_dir is not None) == packs == (jpacked[0] is not None)
    assert attached == [packs] * 3
    if packs:
        assert listing == ["ref", "train", "val"]
        assert not os.path.exists(packed_dir) and not os.path.exists(jpacked[0])
        assert _only_run(TTracker(tmp_path / "t")).latest_metrics()["accuracy"] == \
            _only_run(JTracker(tmp_path / "j")).latest_metrics()["accuracy"]


def test_registry_versions_and_models_spec(env):
    """Two port runs register v1 then v2 under one name; ``models:/`` (the
    latest) and ``models:/<name>/v1`` serve through the port's
    ``AnnotationRun``, each equal to its version's predictor."""
    from mermaid_classifier_tpu_torch.models.efficientnet import (
        EfficientNetConfig,
        init_backbone_params,
    )
    from mermaid_classifier_tpu_torch.models.extractor import build_extractor
    from mermaid_classifier_tpu_torch.serve.annotation import AnnotationRun
    from tests.models.test_efficientnet import TINY

    tmp_path = env[3]
    _, _, v1 = run_port(env, True, tmp_path / "ttrack")
    _, _, v2 = run_port(env, False, tmp_path / "ttrack")
    assert (v1.name, v2.name) == ("v1", "v2")
    assert TTracker(tmp_path / "ttrack").latest_model_version("reef-mlp") == v2

    config = EfficientNetConfig.from_dict({**TINY.to_dict(), "feature_dim": 8})
    extractor = build_extractor(init_backbone_params(0, config), config,
                                device="cpu")
    image = np.random.default_rng(2).integers(0, 256, (96, 128, 3), np.uint8)
    points = tmp_path / "points.csv"
    points.write_text("row,col\n10,12\n50,64\n95,127\n")
    feats = extractor.extract_features(image, np.array([[10, 12], [50, 64], [95, 127]]))
    for spec, version in (("models:/reef-mlp", v2), ("models:/reef-mlp/v1", v1)):
        ann = AnnotationRun(image, points, spec, extractor=extractor,
                            tracker_root=tmp_path / "ttrack")
        ann.run()
        np.testing.assert_array_equal(
            ann.proba, tload(version, device="cpu").predict_proba(feats))
    with override_settings(tracking_dir=str(tmp_path / "ttrack")):
        ann = AnnotationRun(image, points, "models:/reef-mlp/v2", extractor=extractor)
        assert ann.predictor.classes_ == tload(v2, device="cpu").classes_


def test_mesh_runner_matches_single_device(env):
    """``train_mesh_devices=2``: two gloo ranks, one process each as
    torchrun starts them, run the resident recipe data-parallel (the buffer
    row-sharded) on one feature cache and one tracking root. Only rank 0
    writes: the root holds one run and one registered version, and the
    other rank returns no version. Both ranks train to the same result, and
    rank 0's run to the single-device run's: ref accuracies and accuracy
    equal, val scores and the registered artifact's probabilities within
    atol 1e-4 (the bounds this file holds the port to JAX with)."""
    import time

    from tests.test_torch_parallel_worker import collect, start_ranks

    _, tstore, manifest_path, tmp_path = env
    _, smsg, sreg = run_port(env, True, tmp_path / "tsingle")
    strack = _only_run(TTracker(tmp_path / "tsingle"))
    probe = np.random.default_rng(7).normal(size=(64, 8)).astype(np.float32)
    run_dir = tmp_path / "ranks"
    run_dir.mkdir()
    inputs = {
        "options": _options(True, manifest_path, TSub, TW, TDOpts, TTOpts, TKOpts),
        "settings": {k: getattr(tset.settings, k) for k in (
            "coralnet_train_data_bucket", "mermaid_train_data_bucket",
            "mermaid_annotations_parquet_pattern", "batch_size")},
        "store_root": tstore.root, "run_root": run_dir, "probe": probe,
    }
    ranks = collect(start_ranks(2, run_dir, inputs, ["runner_mesh"]), run_dir,
                    time.monotonic() + 150)
    for res in ranks:
        assert "error" not in res["runner_mesh"], res["runner_mesh"]["error"]
    res, other = ranks[0]["runner_mesh"], ranks[1]["runner_mesh"]
    assert (bool(res["registered"]), bool(other["registered"])) == (True, False)
    assert list(other["ref_accs"]) == list(res["ref_accs"])
    assert float(other["acc"]) == float(res["acc"])
    tracker = TTracker(run_dir / "track")
    assert tracker.latest_model_version("reef-mlp").name == "v1"
    mrun = _only_run(tracker)
    assert list(res["ref_accs"]) == smsg.ref_accs and float(res["acc"]) == smsg.acc
    mval = json.loads(mrun.artifact("valresult.json").read_text())
    sval = json.loads(strack.artifact("valresult.json").read_text())
    assert (mval["gt"], mval["est"]) == (sval["gt"], sval["est"])
    np.testing.assert_allclose(mval["scores"], sval["scores"], atol=1e-4)
    np.testing.assert_allclose(
        res["proba"], tload(sreg, device="cpu").predict_proba(probe), atol=1e-4)


def test_unported_settings_raise(env):
    """The store mirror is ported: with ``tracking_sync_bucket`` set, the
    run trains and mirrors itself and the registry into the default store,
    key for key and byte for byte, where it used to raise. (The mesh, which
    raised here too, is ported: ``test_mesh_runner_matches_single_device``.)"""
    from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore

    sync_root = env[3] / "sync_store"
    with override_settings(tracking_sync_bucket="trk",
                           object_store_root=str(sync_root)):
        _, _, registered = run_port(env, False, env[3] / "t2")
    tracker = TTracker(env[3] / "t2")
    run = _only_run(tracker)
    local = {
        f"tracking/{p.relative_to(tracker.root).as_posix()}": p.read_bytes()
        for p in sorted(tracker.root.rglob("*")) if p.is_file()
    }
    store = LocalFSObjectStore(sync_root)
    remote = {k: store.get_bytes("trk", k) for k in store.list_keys("trk")}
    assert remote == local
    assert f"tracking/recipe/{run.run_id}/meta.json" in remote
    assert f"tracking/_models/reef-mlp/{registered.name}/model.npz" in remote
