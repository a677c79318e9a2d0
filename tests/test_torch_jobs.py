"""The port's job layer (``mermaid_classifier_tpu_torch.jobs``) against the
JAX package's ``mermaid_classifier_tpu.jobs``, on the same inputs.

- Request construction: one run YAML through each package's
  ``parse_run_config`` + ``build_processing_requests`` /
  ``build_training_request`` gives equal names, args (the entrypoint
  swapped), env and tags, for 1-5 workers over 0-7 items; the port's
  committed run YAML gives the JAX committed YAML's requests with the
  port's entrypoint.
- ``RunConfig`` accepts exactly what the JAX pydantic models accept, with
  equal parsed fields, strict and loose: a case table of the schema's traps
  and a hypothesis property over generated YAML mappings.
- ``load_items`` returns the JAX (pandas) strings on a case table and on
  seeded random CSVs.
- The rest of tests/jobs/test_launch.py on the port: chunking, dry-run,
  the local backend's fan-out, env and log tee, ``stage_config_dir``,
  ``wait_for_completion``'s timeout, and the two launch CLIs' exit codes.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mermaid_classifier_tpu.jobs import launch as jlaunch
from mermaid_classifier_tpu.jobs import launcher_config as jcfg
from mermaid_classifier_tpu_torch.jobs import (
    DryRunBackend,
    JobStatus,
    LocalProcessBackend,
    build_processing_requests,
    chunk_items,
    launch_processing,
    parse_run_config,
    wait_for_completion,
)
from mermaid_classifier_tpu_torch.jobs import launch as tlaunch
from mermaid_classifier_tpu_torch.jobs.backend import JobRequest
from mermaid_classifier_tpu_torch.jobs.launcher_config import ConfigError

REPO = Path(__file__).resolve().parents[1]
JAX_ENTRY = "scripts/build_feature_bucket.py"
PORT_ENTRY = "mermaid_classifier_tpu_torch/scripts/build_feature_bucket.py"


def write_run_yaml(tmp: Path, entrypoint: str, n_items: int, workers: int) -> Path:
    (tmp / "sources.csv").write_text(
        "source_id\n" + "".join(f"{10 + i}\n" for i in range(n_items)))
    (tmp / "config").mkdir(exist_ok=True)
    (tmp / "config" / "training_config.yaml").write_text("{}\n")
    path = tmp / f"run-{Path(entrypoint).parts[0]}.yaml"
    path.write_text(textwrap.dedent(f"""\
        job:
          entrypoint: {entrypoint}
          env: {{RUN_FLAG: "1", OBJECT_STORE_ROOT: /data/store}}
          tags: {{team: mermaid, run_id: overridden}}
        processing:
          container_args: [--source-bucket, img, --target-bucket, feat]
          shard:
            items_csv: sources.csv
            workers: {workers}
            per_worker_arg: --source-ids
        training:
          config_dir: config
          container_args: [--device, cpu]
        """))
    return path


def as_tuple(request, entry):
    command = list(request.command)
    assert command[1] == entry
    return (request.name, command[0], command[2:], request.env, request.tags)


@pytest.mark.parametrize("workers", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n_items", range(8))
def test_requests_equal_jax(tmp_path, workers, n_items):
    jpath = write_run_yaml(tmp_path, JAX_ENTRY, n_items, workers)
    tpath = write_run_yaml(tmp_path, PORT_ENTRY, n_items, workers)
    jconfig, tconfig = jcfg.parse_run_config(jpath), parse_run_config(tpath)
    want = [as_tuple(r, JAX_ENTRY) for r in jlaunch.build_processing_requests(
        jconfig, "run1")]
    got = [as_tuple(r, PORT_ENTRY) for r in build_processing_requests(tconfig, "run1")]
    assert got == want
    assert len(got) == min(workers, n_items)
    assert as_tuple(tlaunch.build_training_request(tconfig, "run1"), PORT_ENTRY) == \
        as_tuple(jlaunch.build_training_request(jconfig, "run1"), JAX_ENTRY)


def test_committed_run_yaml_is_the_jax_one_with_the_port_entrypoint():
    """The port's run YAML reads the committed configs/example/sources.csv
    and gives the JAX example's requests with the port's bucket CLI."""
    tconfig = parse_run_config(REPO / "mermaid_classifier_tpu_torch" / "jobs"
                               / "processing_run.yaml")
    jconfig = jcfg.parse_run_config(REPO / "configs" / "example" / "processing_run.yaml")
    assert tconfig.resolve_sibling(tconfig.processing.shard.items_csv) == \
        REPO / "configs" / "example" / "sources.csv"
    got = [as_tuple(r, PORT_ENTRY) for r in build_processing_requests(tconfig, "e2e")]
    want = [as_tuple(r, JAX_ENTRY) for r in jlaunch.build_processing_requests(
        jconfig, "e2e")]
    assert got == want and len(got) == 2


@pytest.mark.parametrize("items,workers", [
    (["a", "b", "c", "d", "e"], 2), (["a"], 4), (["a", "b"], 1), ([], 3),
    ([str(i) for i in range(11)], 4), ([7, 8, 9], 2),
])
def test_chunk_items_equals_jax(items, workers):
    assert chunk_items(items, workers) == jlaunch.chunk_items(items, workers)


# -- RunConfig accept / reject against pydantic ----------------------------

def parse_both(tmp: Path, doc, strict: bool):
    """(port result, JAX result): each the parsed fields as a dict, or
    "rejected" (a ``ValueError``: pydantic's ValidationError, the port's
    ConfigError, or either package's error for a non-mapping document)."""
    path = tmp / "run.yaml"
    path.write_text(doc if isinstance(doc, str) else yaml.safe_dump(doc))
    out = []
    for parse, dump in ((parse_run_config, dataclasses.asdict),
                        (jcfg.parse_run_config, lambda c: c.model_dump())):
        try:
            out.append(dump(parse(path, strict=strict)))
        except ValueError:
            out.append("rejected")
    return out


JOB = {"entrypoint": "x.py"}
SHARD = {"items_csv": "s.csv"}
CASES = {
    "minimal": {"job": JOB},
    "full": {"job": {**JOB, "env": {"A": "1"}, "tags": {"t": "v"},
                     "cluster": {"image": "i", "namespace": "n", "accelerator": "a",
                                 "chips": 2, "cpu": "8", "memory": "1Gi", "spot": True,
                                 "service_account": "sa",
                                 "active_deadline_seconds": 60}},
             "processing": {"container_args": ["--a", "b"], "shard": {
                 **SHARD, "workers": 3, "per_worker_arg": "--ids"}},
             "training": {"config_dir": "c", "config_name": "t.yaml",
                          "container_args": ["--x"]}},
    "missing job": {"processing": {"shard": SHARD}},
    "job null": {"job": None},
    "job a list": {"job": ["x"]},
    "missing entrypoint": {"job": {"env": {}}},
    "entrypoint an int": {"job": {"entrypoint": 3}},
    "processing without shard": {"job": JOB, "processing": {"container_args": []}},
    "processing null": {"job": JOB, "processing": None},
    "shard without items_csv": {"job": JOB, "processing": {"shard": {"workers": 2}}},
    "workers '4'": {"job": JOB, "processing": {"shard": {**SHARD, "workers": "4"}}},
    "workers ' 4 '": {"job": JOB, "processing": {"shard": {**SHARD, "workers": " 4 "}}},
    "workers 4.0": {"job": JOB, "processing": {"shard": {**SHARD, "workers": 4.0}}},
    "workers 4.5": {"job": JOB, "processing": {"shard": {**SHARD, "workers": 4.5}}},
    "workers '1e3'": {"job": JOB, "processing": {"shard": {**SHARD, "workers": "1e3"}}},
    "workers true": {"job": JOB, "processing": {"shard": {**SHARD, "workers": True}}},
    "workers 0": {"job": JOB, "processing": {"shard": {**SHARD, "workers": 0}}},
    "workers -2": {"job": JOB, "processing": {"shard": {**SHARD, "workers": -2}}},
    "workers '0.0'": {"job": JOB, "processing": {"shard": {**SHARD, "workers": "0.0"}}},
    "env int value": {"job": {**JOB, "env": {"A": 1}}},
    "env int key": {"job": {**JOB, "env": {1: "a"}}},
    "env null": {"job": {**JOB, "env": None}},
    "env a list": {"job": {**JOB, "env": ["A"]}},
    "tags bool value": {"job": {**JOB, "tags": {"t": True}}},
    "cpu an int": {"job": {**JOB, "cluster": {"image": "i", "cpu": 4}}},
    "memory an int": {"job": {**JOB, "cluster": {"image": "i", "memory": 16}}},
    "chips '2'": {"job": {**JOB, "cluster": {"image": "i", "chips": "2"}}},
    "spot 'yes'": {"job": {**JOB, "cluster": {"image": "i", "spot": "yes"}}},
    "spot 2": {"job": {**JOB, "cluster": {"image": "i", "spot": 2}}},
    "deadline '30'": {"job": {**JOB, "cluster": {"image": "i",
                                                 "active_deadline_seconds": "30"}}},
    "deadline 3.5": {"job": {**JOB, "cluster": {"image": "i",
                                                "active_deadline_seconds": 3.5}}},
    "cluster without image": {"job": {**JOB, "cluster": {"namespace": "n"}}},
    "container_args a str": {"job": JOB, "processing": {"container_args": "--a",
                                                        "shard": SHARD}},
    "container_args an int item": {"job": JOB, "processing": {
        "container_args": ["--a", 1], "shard": SHARD}},
    "container_args null": {"job": JOB, "training": {"container_args": None}},
    "unknown top-level block": {"job": JOB, "unknown_block": {}},
    "unknown int top-level key": {"job": JOB, 7: "x"},
    "unknown key in job": {"job": {**JOB, "zz": 1}},
    "unknown key in shard": {"job": JOB, "processing": {"shard": {**SHARD, "zz": 1}}},
    "unknown key in processing": {"job": JOB, "processing": {"shard": SHARD, "zz": 1}},
    "unknown key in training": {"job": JOB, "training": {"zz": 1}},
    "unknown key in cluster": {"job": {**JOB, "cluster": {"image": "i", "zz": 1}}},
    "config_dir a str": {"job": JOB, "config_dir": "/elsewhere"},
    "config_dir an int": {"job": JOB, "config_dir": 5},
    "config_dir null": {"job": JOB, "config_dir": None},
    "training null": {"job": JOB, "training": None},
    "training config_dir an int": {"job": JOB, "training": {"config_dir": 1}},
}


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "loose"])
@pytest.mark.parametrize("case", list(CASES))
def test_run_config_accepts_and_rejects_as_pydantic(tmp_path, case, strict):
    got, want = parse_both(tmp_path, CASES[case], strict)
    assert got == want
    if isinstance(want, dict):
        assert want["config_dir"] == tmp_path.resolve()


@pytest.mark.parametrize("doc", ["- a\n- b\n", "just text\n", "", "42\n"])
def test_non_mapping_document_raises_value_error(tmp_path, doc):
    path = tmp_path / "run.yaml"
    path.write_text(doc)
    for parse in (parse_run_config, jcfg.parse_run_config):
        with pytest.raises(ValueError, match="is not a YAML mapping") as info:
            parse(path)
        assert type(info.value) is ValueError


def test_rejection_is_a_config_error(tmp_path):
    path = tmp_path / "run.yaml"
    path.write_text(yaml.safe_dump({"job": {**JOB, "env": {"A": 1}}}))
    with pytest.raises(ConfigError, match="job.env.A"):
        parse_run_config(path)
    path.write_text(yaml.safe_dump({"job": JOB, "processing": {"shard": {
        **SHARD, "workers": 0}}}))
    with pytest.raises(ConfigError, match="workers must be >= 1"):
        parse_run_config(path)


TRICKY = ["4", " 4 ", "4.0", "4.5", "1e3", "0", "-1", "1_0", "yes", "off", "true",
          "nan", "", "x.csv", "--ids", "nvidia-h100-80gb"]
SCALARS = st.one_of(
    st.none(), st.booleans(), st.integers(-2, 2**40),
    st.floats(-1e3, 1e3, allow_nan=False), st.sampled_from(TRICKY),
    st.text(st.sampled_from("ab01 ._-"), max_size=4))
VALUES = st.one_of(
    SCALARS, st.lists(SCALARS, max_size=3),
    st.dictionaries(st.one_of(st.sampled_from(["A", "b"]), st.integers(0, 2)),
                    SCALARS, max_size=2))
TEXT = st.text(st.sampled_from("abc./_-"), min_size=1, max_size=6)
TEXTS = st.lists(TEXT, max_size=3)
TEXT_DICTS = st.dictionaries(st.sampled_from(["A", "B", "run_id"]), TEXT, max_size=2)
INTS = st.one_of(st.integers(0, 6), st.sampled_from(["3", " 2 ", 2.0, True]))


def block(required: dict, optional: dict):
    return st.fixed_dictionaries(required, optional=optional)


# Valid documents, in lax mode's every spelling ...
VALID = block({"job": block({"entrypoint": TEXT}, {
    "env": TEXT_DICTS, "tags": TEXT_DICTS,
    "cluster": st.one_of(st.none(), block({"image": TEXT}, {
        "namespace": TEXT, "accelerator": st.one_of(st.none(), TEXT),
        "topology": st.one_of(st.none(), TEXT), "chips": INTS,
        "cpu": st.sampled_from(["4", "500m"]), "memory": st.sampled_from(["16Gi", "1"]),
        "spot": st.sampled_from([True, False, "yes", "off", 1, 0.0]),
        "service_account": st.one_of(st.none(), TEXT),
        "active_deadline_seconds": st.one_of(st.none(), INTS)}))}),
    "processing": st.one_of(st.none(), block({"shard": block({"items_csv": TEXT}, {
        "workers": st.one_of(st.integers(1, 6), st.sampled_from(["3", " 2 ", 2.0, True])),
        "per_worker_arg": TEXT})}, {"container_args": TEXTS}))}, {
    "training": st.one_of(st.none(), block({}, {
        "config_dir": TEXT, "config_name": TEXT, "container_args": TEXTS})),
    "config_dir": st.one_of(st.none(), TEXT)})
# ... then up to two edits: a key of one block set to any value, deleted,
# or an unknown key added.
BLOCKS = {(): ("job", "processing", "training", "config_dir"),
          ("job",): ("entrypoint", "env", "tags", "cluster"),
          ("job", "cluster"): ("image", "namespace", "accelerator", "topology",
                               "chips", "cpu", "memory", "spot", "service_account",
                               "active_deadline_seconds"),
          ("processing",): ("container_args", "shard"),
          ("processing", "shard"): ("items_csv", "workers", "per_worker_arg"),
          ("training",): ("config_dir", "config_name", "container_args")}
EDITS = st.lists(st.tuples(
    st.sampled_from(sorted(BLOCKS)), st.integers(0, 10),
    st.one_of(st.just("delete"), VALUES)), max_size=2)


def edited(doc_edits):
    doc, edits = doc_edits
    for path, key_index, value in edits:
        node = doc
        for part in path:
            node = node.get(part) if isinstance(node, dict) else None
        if not isinstance(node, dict):
            continue
        keys = BLOCKS[path]
        key = keys[key_index] if key_index < len(keys) else ("unknown", 7)[key_index % 2]
        if value == "delete":
            node.pop(key, None)
        else:
            node[key] = value
    return doc


DOCUMENTS = st.tuples(VALID, EDITS).map(edited)


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "loose"])
@settings(max_examples=300, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.filter_too_much,
                                 HealthCheck.function_scoped_fixture])
@given(doc=DOCUMENTS)
def test_run_config_property_equals_pydantic(strict, doc):
    with tempfile.TemporaryDirectory() as td:
        got, want = parse_both(Path(td), doc, strict)
    assert got == want


# -- load_items against pandas ----------------------------------------------

ITEM_CSVS = {
    "leading zeros": "source_id\n007\n12\n",
    "blank field": "source_id,name\n007,a\n,b\n12,c\n",
    "blank line, one column": "source_id\n7\n\n12\n",
    "float ids": "source_id\n1.5\n2\n",
    "strings": "source_id\nabc\nNA\n x \n",
    "bools": "item\nTrue\nfalse\n",
    "column source": "name,source\na,3\nb,4\n",
    "column id": "id,name\n5,a\n6,b\n",
    "column item": "x,item\n1,9\n2,8\n",
    "source before id": "id,source\n1,2\n3,4\n",
    "single unnamed column": "whatever\n1\n2\n",
    "header only": "source_id\n",
    "exponent": "source_id\n1e3\n2\n",
    "bom": "﻿source_id\n3\n",
}


@pytest.mark.parametrize("case", list(ITEM_CSVS))
def test_load_items_equals_jax(tmp_path, case):
    path = tmp_path / "items.csv"
    path.write_text(ITEM_CSVS[case])
    assert tlaunch.load_items(path) == jlaunch.load_items(path)


def test_load_items_without_an_item_column_raises_in_both(tmp_path):
    path = tmp_path / "items.csv"
    path.write_text("a,b\n1,2\n")
    for load in (tlaunch.load_items, jlaunch.load_items):
        with pytest.raises(ValueError, match="cannot find an item column"):
            load(path)


@pytest.mark.parametrize("seed", range(12))
def test_load_items_equals_jax_on_seeded_csvs(tmp_path, seed):
    """Random columns of ids with leading zeros, blanks, floats and words."""
    rng = np.random.default_rng(seed)
    names = list(rng.permutation(["source_id", "source", "id", "item", "other"]))
    names = names[: int(rng.integers(1, 4))]
    kinds = ("int", "zeros", "float", "word", "blank")
    n = int(rng.integers(1, 9))
    columns = []
    for _ in names:
        kind = kinds[int(rng.integers(0, len(kinds)))]
        col = []
        for _ in range(n):
            v = int(rng.integers(0, 2000))
            col.append({"int": str(v), "zeros": f"{v:05d}", "float": f"{v / 8}",
                        "word": f"s{v}", "blank": "" if v % 3 == 0 else str(v)}[kind])
        columns.append(col)
    text = ",".join(names) + "\n" + "".join(
        ",".join(row) + "\n" for row in zip(*columns))
    path = tmp_path / "items.csv"
    path.write_text(text)
    try:
        want = jlaunch.load_items(path)
    except ValueError:
        with pytest.raises(ValueError):
            tlaunch.load_items(path)
        return
    assert tlaunch.load_items(path) == want


# -- the rest of tests/jobs/test_launch.py on the port ----------------------

def test_missing_items_csv_fails_at_request_build(tmp_path):
    config = parse_run_config(write_run_yaml(tmp_path, PORT_ENTRY, 3, 2))
    (tmp_path / "sources.csv").unlink()
    with pytest.raises(FileNotFoundError):
        build_processing_requests(config, "run1")


def test_dry_run_submits_nothing(tmp_path):
    config = parse_run_config(write_run_yaml(tmp_path, PORT_ENTRY, 3, 2))
    backend = DryRunBackend()
    assert launch_processing(config, backend, "run1", dry_run=True) == []
    assert backend.requests == []
    assert tlaunch.launch_training(config, backend, "run1", dry_run=True) == []
    assert launch_processing(config, backend, "run1") == ["dryrun-0", "dryrun-1"]
    assert backend.describe("dryrun-0") is JobStatus.COMPLETED


def test_local_backend_fan_out_env_and_log(tmp_path):
    backend = LocalProcessBackend(log_dir=tmp_path / "logs")
    ok = backend.submit(JobRequest(name="ok", command=[
        sys.executable, "-c", "import os; print('flag', os.environ['SHARD_FLAG'])"],
        env={"SHARD_FLAG": "42"}))
    bad = backend.submit(JobRequest(name="bad", command=[
        sys.executable, "-c", "raise SystemExit(3)"]))
    statuses = wait_for_completion(backend, [ok, bad], poll_seconds=0.05,
                                   timeout_seconds=60)
    assert statuses == {ok: JobStatus.COMPLETED, bad: JobStatus.FAILED}
    assert (tmp_path / "logs" / f"{ok}.log").read_text() == "flag 42\n"


def test_wait_times_out_and_terminate_all_stops_workers(tmp_path):
    backend = LocalProcessBackend()
    job = backend.submit(JobRequest(name="slow", command=[
        sys.executable, "-c", "import time; time.sleep(60)"]))
    with pytest.raises(TimeoutError, match="slow"):
        wait_for_completion(backend, [job], poll_seconds=0.05, timeout_seconds=0.2)
    backend.terminate_all(timeout=10)
    assert backend.describe(job) is JobStatus.FAILED
    assert JobStatus.FAILED.terminal and not JobStatus.IN_PROGRESS.terminal


def test_stage_config_dir_equals_jax(tmp_path):
    from mermaid_classifier_tpu.data.store import LocalFSObjectStore as JStore
    from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore as TStore

    config = tmp_path / "config"
    (config / "sub").mkdir(parents=True)
    (config / "training_config.yaml").write_text("a: 1\n")
    (config / "sub" / "labels.csv").write_text("ba_id\nx\n")
    written = tlaunch.stage_config_dir(TStore(tmp_path / "t"), "staging", "run7", config)
    assert written == jlaunch.stage_config_dir(JStore(tmp_path / "j"), "staging",
                                               "run7", config)
    assert sorted((tmp_path / "t").rglob("*.*")) != []
    assert TStore(tmp_path / "t").get_bytes(
        "staging", "runs/run7/config/training_config.yaml") == b"a: 1\n"
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tlaunch.stage_config_dir(TStore(tmp_path / "t"), "b", "r", tmp_path / "nope")
    with pytest.raises(ValueError):
        tlaunch.stage_config_dir(TStore(tmp_path / "t"), "b", "r", tmp_path / "empty")


def write_cli_yaml(tmp: Path, code: str) -> Path:
    """A run YAML whose entrypoint is a script running ``code``."""
    script = tmp / "worker.py"
    script.write_text(code)
    (tmp / "sources.csv").write_text("source_id\n1\n2\n3\n")
    (tmp / "config").mkdir(exist_ok=True)
    path = tmp / "run.yaml"
    path.write_text(textwrap.dedent(f"""\
        job:
          entrypoint: {script}
        processing:
          shard: {{items_csv: sources.csv, workers: 2}}
        training:
          config_dir: config
        """))
    return path


def run_cli(name: str, *args, timeout: float = 120) -> subprocess.CompletedProcess:
    """A launch CLI as a user runs it, under a deadline of its own."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    return subprocess.run(
        [sys.executable, "-m", f"mermaid_classifier_tpu_torch.scripts.{name}", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("code,want", [
    ("import sys; sys.exit(0)", 0),
    ("import sys; sys.exit(1 if '1,3' in sys.argv else 0)", 1),
])
def test_launch_clis_exit_codes(tmp_path, code, want):
    path = str(write_cli_yaml(tmp_path, code))
    logs = tmp_path / "logs"
    proc = run_cli("launch_processing", "--run-config", path, "--run-id", "r",
                   "--log-dir", str(logs))
    assert proc.returncode == want, proc.stderr
    assert sorted(p.name for p in logs.iterdir()) == ["r-w0-0.log", "r-w1-1.log"]
    assert run_cli("launch_training", "--run-config", path, "--run-id", "t").returncode == 0
    dry = run_cli("launch_processing", "--run-config", path, "--dry-run")
    assert dry.returncode == 0 and "[dry-run] " in dry.stderr
    assert run_cli("launch_processing", "--run-config", path, "--no-wait").returncode == 0
    k8s = run_cli("launch_processing", "--run-config", path, "--backend", "k8s")
    assert k8s.returncode == 1 and "needs a job.cluster: block" in k8s.stderr
