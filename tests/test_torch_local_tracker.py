"""The port's local tracker against the JAX one: the same calls leave the
same files, byte for byte, apart from run ids and timestamps (JSON params,
tags, dicts and metric lines; CSV tables, the JAX side from a DataFrame and
the port's from records, columns or a ``Table``; YAML from flat dicts,
numeric-string keys included). Each package's tracker reads the other's
runs and registered versions. ``safe_dump_flat`` is held to PyYAML's
``safe_dump(sort_keys=False)`` on a spread of keys and values."""

import json
import math
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import yaml

from mermaid_classifier_tpu.tracking.local_tracker import LocalTracker as JTracker
from mermaid_classifier_tpu_torch.common.table import Table
from mermaid_classifier_tpu_torch.tracking.local_tracker import (
    LocalTracker as TTracker,
)
from mermaid_classifier_tpu_torch.tracking.local_tracker import safe_dump_flat

VOLATILE = {"run_id", "start_time", "end_time", "registered_at", "time"}


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in VOLATILE}
    return obj


def tables():
    rng = np.random.default_rng(0)
    weights = [{"bagf_id": f"ba-{i}::", "count": int(c), "weight": float(w)}
                for i, (c, w) in enumerate(zip(rng.integers(1, 900, 6), rng.random(6)))]
    counts = {"benthic_attribute_name": ["Acropora", None, "Hard, coral"],
              "num_annotations": [12, 7, 3],
              "train": [9, None, 2], "ref": [1.5, 2.0, None],
              "dropped": [0, 0, 0]}
    return [
        ("weighting/per_class_weights.csv", weights, weights),
        ("dataset/ba_counts.csv", counts, Table.from_columns(counts)),
        ("empty.csv", pd.DataFrame(columns=["category", "log_loss", "n_samples"]),
         Table(["category", "log_loss", "n_samples"])),
        ("quotes.csv", {"s": ['a"b', "line\nbreak", ""], "b": [True, False, True]},
         {"s": ['a"b', "line\nbreak", ""], "b": [True, False, True]}),
    ]


DICTS = [
    ({"1": 0.5, "2": 0.9167, "10": 1.0}, "epoch_ref_accuracies.yaml"),
    ({"annotations": 120, "annotations_train": 80, "bas": 3, "bagfs_dropped": 0},
     "dataset/train_summary_stats.yaml"),
    ({"precision_macro": 0.3333, "recall_macro": 1e-05, "f1_macro": 0.0},
     "metrics_overall.yaml"),
    ({"best_val_epoch": 2, "note": "x", "nested": {"a": [1, 2]}}, "early_stop_info.json"),
]


def drive(tracker, table_arg):
    run = tracker.start_run("exp/one", "run-a")
    run.log_params({"epochs": 3, "ref_val_ratios": str((0.1, 0.1)), "none": None,
                    "obj": Path("/x")})
    run.log_param("subsample/enabled", False)
    run.set_tag("kind", "test")
    for step, v in enumerate([0.5, float("nan"), 0.25, math.inf]):
        run.log_metric("epoch/val_loss", v, step=step)
    run.log_metrics({"accuracy": 0.9, "weighting/weight_mean": 1e-4})
    for data, path in DICTS:
        run.log_dict(data, path)
    run.log_text("hello\n", "notes/readme.txt")
    for path, jarg, targ in tables():
        run.log_dataframe(table_arg(jarg, targ), path)
    src = tracker.root.parent / "model.json"
    src.write_text('{"schema_version": 1}')
    run.log_artifact(src, "model/model.json")
    run.end()
    v1 = tracker.register_model("reef model", [src], run=run)
    v2 = tracker.register_model("reef model", [src])
    return run, v1, v2


@pytest.fixture()
def both(tmp_path):
    j = drive(JTracker(tmp_path / "jax" / "root"),
              lambda jarg, targ: jarg if isinstance(jarg, pd.DataFrame)
              else pd.DataFrame(jarg))
    t = drive(TTracker(tmp_path / "port" / "root"), lambda jarg, targ: targ)
    return j, t


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_same_files_same_bytes(both):
    (jrun, jv1, jv2), (trun, tv1, tv2) = both
    jfiles, tfiles = _files(jrun.run_dir), _files(trun.run_dir)
    assert tfiles == jfiles
    for rel in jfiles:
        jb, tb = (jrun.run_dir / rel).read_bytes(), (trun.run_dir / rel).read_bytes()
        if rel == "meta.json":
            assert _strip(json.loads(tb)) == _strip(json.loads(jb))
        elif rel.endswith(".jsonl"):
            load = (lambda b: [_strip(json.loads(x)) for x in b.splitlines()])
            assert load(tb) == load(jb), rel
        else:
            assert tb == jb, rel
    assert (jv1.name, jv2.name) == (tv1.name, tv2.name) == ("v1", "v2")
    for jv, tv in ((jv1, tv1), (jv2, tv2)):
        assert _files(tv) == _files(jv)
        jm = json.loads((jv / "registry_meta.json").read_text())
        tm = json.loads((tv / "registry_meta.json").read_text())
        assert _strip(tm) == _strip(jm)
        assert (tm["run_id"] is None) == (jm["run_id"] is None)
    assert json.loads((tv1 / "registry_meta.json").read_text())["run_id"] == trun.run_id


def test_each_reads_the_other(both):
    (jrun, _, _), (trun, _, _) = both
    for reader, run in ((TTracker, jrun), (JTracker, trun)):
        tracker = reader(run.run_dir.parents[1])
        runs = tracker.runs("exp/one")
        assert [r.run_id for r in runs] == [run.run_id]
        got = tracker.get_run(run.run_id)
        assert got.params() == run.params()
        assert got.latest_metrics() == run.latest_metrics()
        assert got.metric_history("epoch/val_loss") == run.metric_history("epoch/val_loss")
        assert got.list_artifacts() == run.list_artifacts()
        assert tracker.latest_model_version("reef model").name == "v2"
        assert tracker.model_version("reef model", "v1").name == "v1"
        assert tracker.model_version("reef model", "v9") is None
        assert tracker.model_version("reef model", "latest") is None


def test_nonfinite_metrics_skipped(both):
    _, (trun, _, _) = both
    assert [h["value"] for h in trun.metric_history("epoch/val_loss")] == [0.5, 0.25]


def test_artifact_path_cannot_escape(tmp_path):
    run = TTracker(tmp_path).start_run("e")
    with pytest.raises(ValueError, match="escapes"):
        run.log_text("x", "../../outside.txt")


def test_failed_run_status(tmp_path):
    tracker = TTracker(tmp_path)
    with pytest.raises(RuntimeError):
        with tracker.start_run("e", "r") as run:
            raise RuntimeError("boom")
    assert json.loads((run.run_dir / "meta.json").read_text())["status"] == "FAILED"


YAML_CASES = [
    {"a": 1, "b": None, "c": True, "d": "x", "e": "", "f": "1.5", "g": "yes",
     "h": "a: b", "i": "-x", "j": "- x", "k": "#x", "l": "a #b", "m": "it's"},
    {"n": 1e17, "o": 1e-7, "p": float("nan"), "q": -math.inf, "r": "2024-01-01",
     "s": "~", "t": "null", "u": "0x1F", "v": "a:b", "w": "weighting/weight_mean"},
    {"x": "-", "y": "?x", "z": "? x", "aa": 12345678901234567890, "bb": 0.1 + 0.2,
     "cc": -0.0, "ee": ":x", "ff": "a,b", "gg": "[x", "ii": "<<", "jj": "=",
     "kk": "0o7", "ll": "012", "mm": "1_000", "nn": "+1", "oo": ".5", "pp": "1e5",
     "rr": "---", "ss": "...x", "tt": "%x", "uu": "x%", "007": "007"},
    {},
]


@pytest.mark.parametrize("case", range(len(YAML_CASES)))
def test_safe_dump_flat_matches_pyyaml(case):
    data = YAML_CASES[case]
    assert safe_dump_flat(data) == yaml.safe_dump(data, sort_keys=False)


def test_safe_dump_flat_refuses_what_it_cannot_write():
    with pytest.raises(TypeError):
        safe_dump_flat({"a": [1]})
    with pytest.raises(ValueError):
        safe_dump_flat({"a": "café"})
