"""The port's Kubernetes backend against the JAX package's, with a fake
``kubectl`` runner (no cluster).

A CPU job (no accelerator) gives the JAX manifest, equal as JSON; an
accelerator job is placed on a GPU node (``nvidia.com/gpu`` and the GKE
accelerator selector) where the JAX one asks for a TPU, and ``topology``
(a TPU slice shape) raises. Names, labels, the container command, status
mapping, submit and terminate follow tests/jobs/test_kubernetes.py."""

import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mermaid_classifier_tpu.jobs import backend as jbackend
from mermaid_classifier_tpu.jobs import kubernetes as jk8s
from mermaid_classifier_tpu_torch.jobs import kubernetes as tk8s
from mermaid_classifier_tpu_torch.jobs.backend import JobRequest, JobStatus

GPU_CLUSTER = tk8s.ClusterSpec(
    image="gcr.io/reef/mermaid-cuda:abc123", namespace="extraction",
    accelerator="nvidia-h100-80gb", chips=1, cpu="8", memory="32Gi", spot=True,
    service_account="mermaid-jobs")


def request(name="run1-w0", tags=None, command=None):
    return JobRequest(
        name=name,
        command=command or ["/usr/bin/python3", "mermaid_classifier_tpu_torch/"
                            "scripts/build_feature_bucket.py", "--source-ids", "1,3"],
        env={"OBJECT_STORE_ROOT": "s3://", "AWS_REGION": "us-east-1", "N": "2"},
        tags={"run_id": "run1", "worker": "0"} if tags is None else tags)


CPU_CLUSTERS = {
    "bare": {"image": "img"},
    "namespaced": {"image": "img", "namespace": "train", "cpu": "2", "memory": "4Gi"},
    "spot with account": {"image": "img", "spot": True, "service_account": "sa"},
    "deadline and selectors": {"image": "img", "active_deadline_seconds": 7200,
                               "extra_node_selectors": {"pool": "cpu-high"}},
    "chips without accelerator": {"image": "img", "chips": 4},
}
REQUESTS = {
    "worker": ("run1-w0", {"run_id": "run1", "worker": "0"}, None),
    "messy names": ("Run_1 w/0!", {"team": "reef team #7", "run_id": "r" * 80}, None),
    "long run id": ("nightly-extraction-" + "x" * 60 + "-w13", {}, None),
    "host interpreter": ("t", {}, ["/usr/local/bin/python3.12", "x.py", "--flag"]),
    "not python": ("t", {}, ["bash", "-c", "echo hi"]),
}


@pytest.mark.parametrize("req", list(REQUESTS))
@pytest.mark.parametrize("cluster", list(CPU_CLUSTERS))
def test_cpu_job_manifest_equals_jax_as_json(cluster, req):
    name, tags, command = REQUESTS[req]
    got = tk8s.build_job_manifest(
        request(name, tags, command), tk8s.ClusterSpec(**CPU_CLUSTERS[cluster]))
    want = jk8s.build_job_manifest(
        jbackend.JobRequest(**vars(request(name, tags, command))),
        jk8s.ClusterSpec(**CPU_CLUSTERS[cluster]))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("chips,want", [(0, 1), (1, 1), (4, 4)])
def test_gpu_job_is_placed_on_a_gpu_node(chips, want):
    cluster = tk8s.ClusterSpec(**{**vars(GPU_CLUSTER), "chips": chips})
    m = tk8s.build_job_manifest(request(), cluster)
    pod = m["spec"]["template"]["spec"]
    assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
                                   "cloud.google.com/gke-spot": "true"}
    (container,) = pod["containers"]
    assert container["resources"] == {
        "requests": {"cpu": "8", "memory": "32Gi", "nvidia.com/gpu": want},
        "limits": {"nvidia.com/gpu": want}}
    assert "google.com/tpu" not in json.dumps(m)
    # Everything but the placement is the JAX manifest of the same job.
    jm = jk8s.build_job_manifest(
        jbackend.JobRequest(**vars(request())),
        jk8s.ClusterSpec(**{**vars(GPU_CLUSTER), "chips": chips,
                            "accelerator": "tpu-v5-lite-podslice"}))
    jpod = jm["spec"]["template"]["spec"]
    for manifest_pod in (pod, jpod):
        manifest_pod.pop("nodeSelector")
        manifest_pod["containers"][0].pop("resources")
    assert m == jm


@pytest.mark.parametrize("accelerator", ["nvidia-h100-80gb", None])
def test_topology_raises(accelerator):
    cluster = tk8s.ClusterSpec(image="img", accelerator=accelerator, topology="1x1")
    with pytest.raises(ValueError, match="topology='1x1'"):
        tk8s.build_job_manifest(request(), cluster)


@settings(max_examples=200, deadline=None, derandomize=True)
@given(value=st.text(max_size=90))
def test_names_and_labels_equal_jax(value):
    assert tk8s._name_safe(value) == jk8s._name_safe(value)
    assert tk8s._label_safe(value) == jk8s._label_safe(value)


def test_long_names_stay_unique_after_truncation():
    run_id = "nightly-extraction-" + "x" * 50
    names = {tk8s._name_safe(f"{run_id}-w{i}") for i in range(20)}
    assert len(names) == 20
    assert all(len(n) <= 63 for n in names)
    assert tk8s._name_safe("run1-w0") == "run1-w0"


class FakeKubectl:
    """Records invocations; scripted ``get job`` responses."""

    def __init__(self):
        self.calls = []
        self.job_status: dict = {}

    def __call__(self, args, stdin=None):
        self.calls.append((list(args), stdin))
        if args[0] == "get":
            return json.dumps({"status": self.job_status})
        if args[0] == "delete" and "run1-w1" in args:
            raise RuntimeError("kubectl delete failed")
        return ""


STATUSES = [
    ({}, JobStatus.IN_PROGRESS),
    ({"active": 1}, JobStatus.IN_PROGRESS),
    ({"succeeded": 1}, JobStatus.COMPLETED),
    ({"failed": 1, "conditions": [{"type": "Failed", "status": "True"}]},
     JobStatus.FAILED),
    ({"failed": 1}, JobStatus.FAILED),
    ({"failed": 1, "active": 1}, JobStatus.IN_PROGRESS),
    ({"conditions": [{"type": "Failed", "status": "False"}]}, JobStatus.IN_PROGRESS),
    ({"conditions": None}, JobStatus.IN_PROGRESS),
]


@pytest.mark.parametrize("status,want", STATUSES)
def test_describe_status_mapping_equals_jax(status, want):
    got = []
    for k8s in (tk8s, jk8s):
        kubectl = FakeKubectl()
        backend = k8s.KubernetesJobBackend(GPU_CLUSTER if k8s is tk8s else
                                           jk8s.ClusterSpec(image="img"), kubectl)
        kubectl.job_status = status
        got.append(backend.describe("run1-w0").value)
        assert kubectl.calls[-1][0] == ["get", "job", "run1-w0", "-n",
                                        backend.cluster.namespace, "-o", "json"]
    assert got == [want.value] * 2


def test_submit_applies_manifest_and_terminate_deletes_each():
    kubectl = FakeKubectl()
    backend = tk8s.KubernetesJobBackend(GPU_CLUSTER, kubectl)
    ids = [backend.submit(request(f"run1-w{i}")) for i in range(3)]
    assert ids == ["run1-w0", "run1-w1", "run1-w2"]
    args, stdin = kubectl.calls[0]
    assert args == ["apply", "-f", "-"]
    assert json.loads(stdin) == tk8s.build_job_manifest(request("run1-w0"), GPU_CLUSTER)
    backend.terminate_all()  # one failing delete is logged, the rest go on
    deletes = [a for a, _ in kubectl.calls if a[0] == "delete"]
    assert [d[2] for d in deletes] == ids
    assert all(d[-1] == "--ignore-not-found" for d in deletes)


def test_launch_processing_submits_one_gpu_job_per_worker(tmp_path):
    from mermaid_classifier_tpu_torch.jobs import launch_processing, parse_run_config

    (tmp_path / "sources.csv").write_text("source_id\n1\n2\n3\n")
    run = tmp_path / "run.yaml"
    run.write_text(
        "job:\n  entrypoint: mermaid_classifier_tpu_torch/scripts/"
        "build_feature_bucket.py\n"
        "  cluster: {image: img, accelerator: nvidia-h100-80gb}\n"
        "processing:\n  shard: {items_csv: sources.csv, workers: 2}\n")
    config = parse_run_config(run)
    kubectl = FakeKubectl()
    cluster = tk8s.ClusterSpec(**vars(config.job.cluster))
    backend = tk8s.KubernetesJobBackend(cluster, kubectl)
    assert launch_processing(config, backend, "run9") == ["run9-w0", "run9-w1"]
    commands = [m["spec"]["template"]["spec"]["containers"][0]["command"]
                for m in backend.manifests.values()]
    assert [c[0] for c in commands] == ["python", "python"]
    assert [c[-2:] for c in commands] == [["--source-ids", "1,3"], ["--source-ids", "2"]]
