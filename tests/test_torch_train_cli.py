"""The port's ``classifier_train`` and ``train_job_entrypoint`` CLIs.

Through their runner seams (``_resolve_runner_factory``), as
tests/test_classifier_train_cli.py and tests/test_train_job_entrypoint.py
drive the JAX scripts: the YAML flows into the runner's options, the env
block is applied and the settings re-read before the options are built,
``--device`` and ``--allow-unpinned-torch`` reach the runner, and the job
entrypoint marks each stage, redacts secrets and exits 1 on any failure.
Then one end-to-end run of ``classifier_train --device cpu`` over a small
seeded store (``tests/torch_recipe_env``), configured only by its YAML
directory: all nine metric groups logged, their figures written, a model
registered."""

import json
import logging
import os
import textwrap
from pathlib import Path

import pytest

from mermaid_classifier_tpu_torch.common import taxonomy as ttax
from mermaid_classifier_tpu_torch.config import settings as tset
from mermaid_classifier_tpu_torch.metrics import REPORT_ORDER
from mermaid_classifier_tpu_torch.scripts import classifier_train as cli
from mermaid_classifier_tpu_torch.scripts import train_job_entrypoint as job
from mermaid_classifier_tpu_torch.tracking import LocalTracker
from mermaid_classifier_tpu_torch.utils import logging_config as lc
from tests.data.dataset_fixtures import BUCKET, build_environment
from tests.torch_recipe_env import clear_taxonomy_caches, write_taxonomy_fixture


class _FakeReturnMsg:
    acc = 0.91


class FakeRunner:
    instances: list = []

    def __init__(self, **kwargs):
        self.kwargs = kwargs
        self.run_names = []
        type(self).instances.append(self)

    def run(self, run_name=None):
        self.run_names.append(run_name)
        return _FakeReturnMsg(), Path("/fake/registry/v1")


class CrashingRunner(FakeRunner):
    def run(self, run_name=None):
        raise RuntimeError("boom in training")


@pytest.fixture(autouse=True)
def process_state(monkeypatch):
    """The CLIs apply the env block to os.environ and re-read the settings
    in place; both are put back afterwards. The script's logging setup is
    stubbed so the suite's logging stays as it is."""
    FakeRunner.instances = []
    env = dict(os.environ)
    saved = {n: getattr(tset.settings, n) for n in tset.Settings.field_names()}
    monkeypatch.setattr(lc, "logging_config_for_script", lambda *a, **k: Path("/dev/null"))
    yield
    os.environ.clear()
    os.environ.update(env)
    for name, value in saved.items():
        setattr(tset.settings, name, value)


def write_config(directory: Path, text: str) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "training_config.yaml").write_text(textwrap.dedent(text))
    return directory


CONFIG = """\
    dataset:
      include_mermaid: true
    training:
      epochs: 7
      early_stopping_patience: 2
    tracking:
      experiment_name: cli-test
    env:
      CLI_TEST_FLAG: "on"
      OBJECT_STORE_ROOT: {root}
    """


def test_config_flows_to_runner(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "_resolve_runner_factory", lambda: FakeRunner)
    config_dir = write_config(tmp_path / "config", CONFIG.format(root=tmp_path / "store"))
    monkeypatch.setenv("OBJECT_STORE_ROOT", "/from/the/environment")
    assert cli.main(["--config-dir", str(config_dir), "--run-name", "cli-run",
                     "--device", "cpu"]) == 0
    (runner,) = FakeRunner.instances
    assert runner.kwargs["training_options"].epochs == 7
    assert runner.kwargs["training_options"].early_stopping_patience == 2
    assert runner.kwargs["tracking_options"].experiment_name == "cli-test"
    assert runner.kwargs["device"] == "cpu"
    assert runner.kwargs["enforce_torch_pin"] is True
    assert runner.run_names == ["cli-run"]
    # The env block was applied and the settings re-read before the runner.
    assert os.environ["CLI_TEST_FLAG"] == "on"
    assert tset.settings.object_store_root == str(tmp_path / "store")


def test_unpinned_torch_flag(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "_resolve_runner_factory", lambda: FakeRunner)
    config_dir = write_config(tmp_path / "config", "training: {epochs: 1}\n")
    assert cli.main(["--config-dir", str(config_dir), "--device", "cpu",
                     "--allow-unpinned-torch"]) == 0
    assert FakeRunner.instances[0].kwargs["enforce_torch_pin"] is False


def test_missing_config_errors(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "_resolve_runner_factory", lambda: FakeRunner)
    with pytest.raises(FileNotFoundError):
        cli.main(["--config-dir", str(tmp_path), "--device", "cpu"])
    assert FakeRunner.instances == []


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cli, "_resolve_runner_factory", lambda: FakeRunner)
    config_dir = write_config(tmp_path / "config", "training: {epochs: 1}\n")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--config-dir", str(config_dir)])
    assert job.main(["--config-dir", str(config_dir)]) == 1
    assert FakeRunner.instances == []


def run_job(argv, factory, monkeypatch, caplog):
    monkeypatch.setattr(job, "_resolve_runner_factory", lambda: factory)
    with caplog.at_level(logging.INFO, logger=job.logger.name):
        rc = job.main(argv)
    return rc, "\n".join(r.getMessage() for r in caplog.records)


def test_job_success_marks_every_stage(tmp_path, monkeypatch, caplog):
    config_dir = write_config(tmp_path / "config", "training:\n  epochs: 2\n")
    rc, log = run_job(["--config-dir", str(config_dir), "--run-name", "r1",
                       "--device", "cpu"], FakeRunner, monkeypatch, caplog)
    assert rc == 0
    for stage in ("load_config", "apply_env", "build_options", "runner_run"):
        assert f"ENTER {stage}" in log and f"EXIT {stage}" in log
    assert "FAIL" not in log
    assert "torch " in log
    (runner,) = FakeRunner.instances
    assert runner.run_names == ["r1"]
    assert runner.kwargs["training_options"].epochs == 2
    assert runner.kwargs["device"] == "cpu"


def test_job_runner_crash_marks_fail_and_exits_1(tmp_path, monkeypatch, caplog):
    config_dir = write_config(tmp_path / "config", "training:\n  epochs: 2\n")
    rc, log = run_job(["--config-dir", str(config_dir), "--device", "cpu"],
                      CrashingRunner, monkeypatch, caplog)
    assert rc == 1
    assert "ENTER runner_run" in log and "FAIL runner_run" in log
    assert "boom in training" in log
    assert "EXIT build_options" in log


def test_job_bad_config_fails_load_stage(tmp_path, monkeypatch, caplog):
    config_dir = write_config(tmp_path / "config", "not_a_real_block: {}\n")
    rc, log = run_job(["--config-dir", str(config_dir), "--device", "cpu"],
                      FakeRunner, monkeypatch, caplog)
    assert rc == 1
    assert "FAIL load_config" in log
    assert "ENTER apply_env" not in log
    assert FakeRunner.instances == []


def test_job_missing_config_dir_fails_load_stage(monkeypatch, caplog):
    rc, log = run_job(["--config-dir", "/nope/never/exists", "--device", "cpu"],
                      FakeRunner, monkeypatch, caplog)
    assert rc == 1
    assert "does not exist" in log
    assert "FAIL load_config" in log


def test_debug_dump_redacts_secrets(tmp_path, monkeypatch, caplog):
    secrets = {"MY_API_KEY": "k123", "STORE_SECRET": "s456", "AUTH_TOKEN": "t789",
               "DB_PASSWORD": "p000", "GCP_CREDENTIALS": "c111"}
    for key, value in {**secrets, "SAFE_FLAG": "visible"}.items():
        monkeypatch.setenv(key, value)
    with caplog.at_level(logging.DEBUG, logger=job.logger.name):
        job._debug_dump(tmp_path)
    dump = "\n".join(r.getMessage() for r in caplog.records)
    for key, value in secrets.items():
        assert f"env {key}=<redacted>" in dump
        assert value not in dump
    assert "env SAFE_FLAG=visible" in dump


@pytest.mark.parametrize("matplotlib", ["present", "hidden"])
def test_cli_end_to_end_on_cpu(tmp_path, monkeypatch, matplotlib):
    """``classifier_train --device cpu`` over a seeded store, with the store,
    buckets, annotation table, taxonomy, feature cache and tracking dir set
    only by the YAML's env block: the run logs all nine groups and
    registers its model; with matplotlib hidden the figures are named in
    ``figures_not_written`` instead of written."""
    import sys

    store, manifest_path, mermaid_path = build_environment(
        tmp_path, n_sources=2, images_per_source=6, points_per_image=15)
    taxonomy_dir = write_taxonomy_fixture(tmp_path / "taxonomy")
    tracking = tmp_path / "tracking"
    config_dir = write_config(tmp_path / "config", f"""\
        dataset:
          coralnet_manifest_uri: {manifest_path}
          label_rollup_spec_csv: rollups.csv
          subsample: {{strategy: stratified, total_annotations: 200}}
          weighting: {{enabled: true, weight_ratio_cap: 100}}
        training:
          epochs: 2
          calibration_backend: device
        tracking:
          experiment_name: cli-e2e
          model_name: cli-mlp
        env:
          OBJECT_STORE_ROOT: {store.root}
          CORALNET_TRAIN_DATA_BUCKET: {BUCKET}
          MERMAID_TRAIN_DATA_BUCKET: {BUCKET}
          MERMAID_ANNOTATIONS_PARQUET_PATTERN: {mermaid_path}
          {ttax.TAXONOMY_FIXTURE_ENV}: {taxonomy_dir}
          FEATURE_CACHE_DIR: {tmp_path / "cache"}
          TRACKING_DIR: {tracking}
          BATCH_SIZE: "200"
        """)
    (config_dir / "rollups.csv").write_text("from_ba_id,from_gf_id,to_ba_id,to_gf_id\n")
    if matplotlib == "hidden":
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    clear_taxonomy_caches()
    try:
        assert cli.main(["--config-dir", str(config_dir), "--device", "cpu",
                         "--allow-unpinned-torch"]) == 0
    finally:
        clear_taxonomy_caches()
    (run,) = LocalTracker(tracking).runs("cli-e2e")
    seconds = json.loads(run.artifact("metrics_group_seconds.json").read_text())
    assert list(seconds) == list(REPORT_ORDER)
    metrics = run.latest_metrics()
    for name in ("accuracy", "mcc", "cross_branch_error_rate", "ece",
                 "cover_mean_rmse_pct", "per_source/n_sources", "log_loss", "mrr"):
        assert name in metrics, name
    pngs = [p for p in run.list_artifacts() if p.endswith(".png")]
    if matplotlib == "present":
        assert "figures_not_written" not in run.params()
        assert {"confusion_matrix/frequencies.png", "calibration/reliability_diagram.png",
                "taxonomic/top_level_confusion.png"} <= set(pngs)
    else:
        assert pngs == []
        named = run.params()["figures_not_written"].split(", ")
        assert {"confusion_matrix/percents.png", "per_source/accuracy_by_source.png",
                "taxonomic/top_level_confusion.png"} <= set(named)
    registered = LocalTracker(tracking).latest_model_version("cli-mlp")
    assert json.loads((registered / "registry_meta.json").read_text())["run_id"] == run.run_id
