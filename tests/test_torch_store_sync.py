"""The port's remote tracking (``tracking/store_sync.py``) against the JAX
package's: one port tracking tree (a finished run and a registered model)
synced by each package into its own store gives the same keys, the same
bytes and the same written lists; the port pulls what either package
pushed, refuses to overwrite, and a report from the pulled run equals the
report from the local one, byte for byte. The same over the fake S3
endpoint, and the ``sync_tracking`` CLI's push / list / pull."""

from pathlib import Path

import pytest

from mermaid_classifier_tpu.data.store import LocalFSObjectStore as JStore
from mermaid_classifier_tpu.tracking import store_sync as jsync
from mermaid_classifier_tpu_torch.config.settings import override_settings
from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore as TStore
from mermaid_classifier_tpu_torch.tracking import store_sync as tsync
from mermaid_classifier_tpu_torch.tracking.local_tracker import LocalTracker
from mermaid_classifier_tpu_torch.tracking.report import generate_report

from tests.data.fake_s3_server import make_server


def finished_tree(root: Path):
    """Two finished runs in two experiments and a registered model."""
    tracker = LocalTracker(root)
    runs = []
    for exp, name in (("exp-a", "run-one"), ("exp-b", "run-two")):
        with tracker.start_run(exp, name) as run:
            run.log_params({"epochs": 3, "lr": 1e-4})
            run.log_metric("accuracy", 0.91)
            run.log_metric("accuracy", 0.95, step=1)
            run.log_dict({"classes": ["a", "b"]}, "labels.json")
            run.log_text("hello", "notes/readme.txt")
            run.log_dataframe({"ba": ["x", "NA"], "n": [1, None]}, "dataset/counts.csv")
        runs.append(run)
    (root.parent / "model.npz").write_bytes(b"weights")
    (root.parent / "model.json").write_text("{}")
    tracker.register_model("mermaid-mlp", [root.parent / "model.npz",
                                           root.parent / "model.json"], run=runs[0])
    return tracker, runs


def contents(store, bucket):
    return {k: store.get_bytes(bucket, k) for k in store.list_keys(bucket)}


SYNCS = {
    "run": lambda mod, tracker, runs, store: mod.sync_run_to_store(runs[0], store, "trk"),
    "registry": lambda mod, tracker, runs, store: mod.sync_registry_to_store(
        tracker, store, "trk"),
    "tracker": lambda mod, tracker, runs, store: mod.sync_tracker_to_store(
        tracker, store, "trk"),
}


@pytest.mark.parametrize("kind", sorted(SYNCS))
def test_sync_keys_and_bytes_equal_jax(tmp_path, kind):
    tracker, runs = finished_tree(tmp_path / "tracking")
    tstore, jstore = TStore(tmp_path / "tstore"), JStore(tmp_path / "jstore")
    twritten = SYNCS[kind](tsync, tracker, runs, tstore)
    jwritten = SYNCS[kind](jsync, tracker, runs, jstore)
    assert twritten == jwritten and twritten
    assert contents(tstore, "trk") == contents(jstore, "trk")
    assert tsync.list_remote_runs(tstore, "trk") == jsync.list_remote_runs(jstore, "trk")


def test_sync_is_idempotent_and_incremental(tmp_path):
    tracker, runs = finished_tree(tmp_path / "a")
    store = TStore(tmp_path / "store")
    first = tsync.sync_tracker_to_store(tracker, store, "trk")
    assert first
    assert tsync.sync_tracker_to_store(tracker, store, "trk") == []
    assert tsync.sync_run_to_store(runs[0], store, "trk") == []
    again = tsync.sync_tracker_to_store(tracker, store, "trk", skip_existing=False)
    assert again == first


def test_round_trip_between_machines(tmp_path):
    tracker, runs = finished_tree(tmp_path / "machine_a")
    store = TStore(tmp_path / "store")
    tsync.sync_run_to_store(runs[0], store, "trk")
    assert tsync.list_remote_runs(store, "trk") == {"exp-a": [runs[0].run_id]}
    pulled = tsync.pull_run_from_store(store, "trk", "exp-a", runs[0].run_id,
                                       tmp_path / "machine_b")
    assert pulled.latest_metrics()["accuracy"] == 0.95
    assert pulled.params()["epochs"] == 3
    assert pulled.artifact("notes/readme.txt").read_text() == "hello"
    with pytest.raises(FileExistsError):
        tsync.pull_run_from_store(store, "trk", "exp-a", runs[0].run_id,
                                  tmp_path / "machine_b")
    tsync.pull_run_from_store(store, "trk", "exp-a", runs[0].run_id,
                              tmp_path / "machine_b", overwrite=True)
    with pytest.raises(FileNotFoundError, match="no run objects"):
        tsync.pull_run_from_store(store, "trk", "exp-a", "nope", tmp_path / "c")


def test_port_pulls_what_jax_pushed_and_reports_equal(tmp_path):
    """JAX pushes, the port pulls on a second machine, and the port's
    report of the pulled run equals its report of the local run."""
    tracker, runs = finished_tree(tmp_path / "machine_a")
    jstore = JStore(tmp_path / "store")
    jsync.sync_tracker_to_store(tracker, jstore, "trk")
    tstore = TStore(tmp_path / "store")
    for run in runs:
        exp = run.run_dir.parent.name
        pulled = tsync.pull_run_from_store(tstore, "trk", exp, run.run_id,
                                           tmp_path / "machine_b")
        local = generate_report(run, tmp_path / f"local_{exp}.html").read_bytes()
        remote = generate_report(pulled, tmp_path / f"pulled_{exp}.html").read_bytes()
        assert remote == local


def test_sync_over_s3_equals_local(tmp_path):
    from mermaid_classifier_tpu.data.s3_store import S3Credentials as JCreds
    from mermaid_classifier_tpu.data.s3_store import S3ObjectStore as JS3
    from mermaid_classifier_tpu_torch.data.s3_store import S3Credentials, S3ObjectStore

    tracker, runs = finished_tree(tmp_path / "tracking")
    server, state, endpoint = make_server()
    try:
        state.max_keys = 4
        s3 = S3ObjectStore(endpoint, credentials=S3Credentials("AK", "SK"),
                           retry_backoff_s=0.01)
        written = tsync.sync_tracker_to_store(tracker, s3, "trk")
        local = TStore(tmp_path / "local")
        assert tsync.sync_tracker_to_store(tracker, local, "trk") == written
        assert contents(s3, "trk") == contents(local, "trk")
        jax_view = JS3(endpoint, credentials=JCreds("AK", "SK"), retry_backoff_s=0.01)
        assert jsync.list_remote_runs(jax_view, "trk") == \
            tsync.list_remote_runs(s3, "trk")
        pulled = tsync.pull_run_from_store(s3, "trk", "exp-b", runs[1].run_id,
                                           tmp_path / "pulled")
        assert generate_report(pulled, tmp_path / "p.html").read_bytes() == \
            generate_report(runs[1], tmp_path / "l.html").read_bytes()
    finally:
        server.shutdown()


def test_sync_tracking_cli(tmp_path, capsys):
    from mermaid_classifier_tpu_torch.scripts import sync_tracking as cli

    tracker, runs = finished_tree(tmp_path / "tracking")
    with override_settings(object_store_root=str(tmp_path / "store")):
        assert cli.main(["push", "--bucket", "trk", "--tracking-root",
                         str(tracker.root)]) == 0
        capsys.readouterr()
        assert cli.main(["list", "--bucket", "trk"]) == 0
        listed = capsys.readouterr().out
        assert listed == "".join(f"{r.run_dir.parent.name}:\n  {r.run_id}\n" for r in runs)
        assert cli.main(["pull", "--bucket", "trk", "--experiment", "exp-a",
                         "--run-id", runs[0].run_id, "--dest",
                         str(tmp_path / "pulled")]) == 0
    pulled_dir = tmp_path / "pulled" / "exp-a" / runs[0].run_id
    assert sorted(p.relative_to(pulled_dir) for p in pulled_dir.rglob("*") if p.is_file()) \
        == sorted(p.relative_to(runs[0].run_dir) for p in runs[0].run_dir.rglob("*")
                  if p.is_file())
    assert contents(TStore(tmp_path / "store"), "trk") == contents(
        _jax_pushed(tracker, tmp_path / "jstore"), "trk")


def _jax_pushed(tracker, root):
    store = JStore(root)
    jsync.sync_tracker_to_store(tracker, store, "trk")
    return store
