"""Kubernetes/GKE job backend: the cloud-scale analog of the reference's
SageMaker launchers.

The port's own copy of ``mermaid_classifier_tpu/jobs/kubernetes.py``. The
reference fans out by building one ``CreateProcessingJob`` request per
worker (reference: scripts/launch_processing.py:81-124) and one Estimator
TrainingJob (launch_training.py:131-198). The equivalent here is a
Kubernetes ``batch/v1 Job`` per worker on a GKE cluster: job labels carry
the run metadata, and for an accelerator job a node selector pins the GPU
type and ``nvidia.com/gpu`` requests cards.

One deliberate difference from the JAX backend: the port's workers run
CUDA kernels, so ``accelerator`` names a GKE GPU type (for example
``nvidia-h100-80gb``, node selector ``cloud.google.com/gke-accelerator``)
and ``chips`` counts ``nvidia.com/gpu``, where the JAX backend requests
``google.com/tpu`` under TPU selectors. ``topology`` is a TPU slice shape
with no GPU meaning: setting it raises ``ValueError``. A CPU job
(``accelerator`` None) gives the same manifest as the JAX backend.

The backend shells out through an injectable ``kubectl_runner`` callable
(default: the real ``kubectl``), so the manifest construction and
lifecycle logic is fully unit-testable with a fake runner — the same
no-cloud-needed test discipline the reference applies to its launchers
(reference: tests/sagemaker_launcher/).
"""

from __future__ import annotations

import json
import re
import subprocess
from dataclasses import dataclass, field
from logging import getLogger
from typing import Callable

from mermaid_classifier_tpu_torch.jobs.backend import (
    JobBackend,
    JobRequest,
    JobStatus,
)

logger = getLogger(__name__)

_LABEL_BAD = re.compile(r"[^A-Za-z0-9._-]+")
_NAME_BAD = re.compile(r"[^a-z0-9-]+")


def _label_safe(value: str) -> str:
    """Kubernetes label values: alphanumerics, '-', '_', '.', max 63;
    must start and end alphanumeric."""
    cleaned = _LABEL_BAD.sub("-", str(value))[:63].strip("-_.")
    return cleaned or "x"


def _name_safe(value: str) -> str:
    """Job names are DNS-1123 labels: lowercase alphanumerics and '-',
    start/end alphanumeric, max 63 — stricter than label VALUES
    ('_' and '.' are label-legal but name-illegal).

    Truncation must not collapse distinct requests onto one Job name
    (a long run_id would otherwise cut off the per-worker -wN suffix,
    making worker 1 and workers 10..19 the same Job): names over the
    limit keep a deterministic hash of the FULL value as a suffix."""
    import zlib

    cleaned = _NAME_BAD.sub("-", str(value).lower()).strip("-")
    if len(cleaned) > 63:
        suffix = f"-{zlib.crc32(cleaned.encode()):08x}"
        cleaned = cleaned[: 63 - len(suffix)].rstrip("-") + suffix
    return cleaned or "job"


def _container_command(command: list[str]) -> list[str]:
    """The launcher builds commands with the HOST interpreter path
    (sys.executable); inside the container that path means nothing — swap
    it for the image's `python` on PATH."""
    if command and "python" in command[0].rsplit("/", 1)[-1]:
        return ["python", *command[1:]]
    return list(command)


@dataclass(frozen=True)
class ClusterSpec:
    """Where and how jobs run on the cluster.

    ``accelerator`` maps to GKE's GPU node selector
    (``cloud.google.com/gke-accelerator``); ``chips`` requests
    ``nvidia.com/gpu`` on the container (1 when 0). ``topology`` (a TPU
    slice shape in the JAX backend) must stay None. Leave ``accelerator``
    None for CPU-only jobs (e.g. head training)."""

    image: str
    namespace: str = "default"
    accelerator: str | None = None  # e.g. "nvidia-h100-80gb"
    topology: str | None = None  # TPU-only; must stay None here
    chips: int = 0
    cpu: str = "4"
    memory: str = "16Gi"
    spot: bool = False
    service_account: str | None = None
    extra_node_selectors: dict[str, str] = field(default_factory=dict)
    active_deadline_seconds: int | None = None


def build_job_manifest(request: JobRequest, cluster: ClusterSpec) -> dict:
    """One worker = one ``batch/v1 Job``: restartPolicy Never and
    backoffLimit 0 because workers are idempotent-resumable at the data
    level (the bucket is the progress truth) — relaunching the RUN, not
    retrying the pod, is the recovery path."""
    if cluster.topology:
        raise ValueError(
            f"ClusterSpec.topology={cluster.topology!r} is a TPU slice shape;"
            " a GPU job is placed by accelerator and chips only."
        )
    job_name = _name_safe(request.name)
    labels = {
        "app": "mermaid-classifier",
        **{k: _label_safe(v) for k, v in request.tags.items()},
    }
    resources: dict = {
        "requests": {"cpu": cluster.cpu, "memory": cluster.memory},
        "limits": {},
    }
    node_selector = dict(cluster.extra_node_selectors)
    if cluster.accelerator:
        node_selector["cloud.google.com/gke-accelerator"] = cluster.accelerator
        resources["limits"]["nvidia.com/gpu"] = cluster.chips or 1
        resources["requests"]["nvidia.com/gpu"] = cluster.chips or 1
    if cluster.spot:
        node_selector["cloud.google.com/gke-spot"] = "true"

    container = {
        "name": "worker",
        "image": cluster.image,
        "command": _container_command(request.command),
        "env": [
            {"name": k, "value": str(v)} for k, v in sorted(request.env.items())
        ],
        "resources": resources,
    }
    pod_spec: dict = {
        "restartPolicy": "Never",
        "containers": [container],
    }
    if node_selector:
        pod_spec["nodeSelector"] = node_selector
    if cluster.spot:
        # Spot nodes carry this taint on GKE.
        pod_spec["tolerations"] = [
            {
                "key": "cloud.google.com/gke-spot",
                "operator": "Equal",
                "value": "true",
                "effect": "NoSchedule",
            }
        ]
    if cluster.service_account:
        pod_spec["serviceAccountName"] = cluster.service_account

    spec: dict = {
        "backoffLimit": 0,
        "template": {"metadata": {"labels": labels}, "spec": pod_spec},
    }
    if cluster.active_deadline_seconds:
        spec["activeDeadlineSeconds"] = cluster.active_deadline_seconds

    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {
            "name": job_name,
            "namespace": cluster.namespace,
            "labels": labels,
        },
        "spec": spec,
    }


def _default_kubectl(args: list[str], stdin: str | None = None) -> str:
    proc = subprocess.run(
        ["kubectl", *args],
        input=stdin,
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"kubectl {' '.join(args)} failed ({proc.returncode}):"
            f" {proc.stderr.strip()[:500]}"
        )
    return proc.stdout


class KubernetesJobBackend(JobBackend):
    """submit/describe over ``kubectl``; construction logic pure and
    testable via an injected runner."""

    def __init__(
        self,
        cluster: ClusterSpec,
        kubectl_runner: Callable[..., str] | None = None,
    ) -> None:
        self.cluster = cluster
        self._kubectl = kubectl_runner or _default_kubectl
        self.manifests: dict[str, dict] = {}

    def submit(self, request: JobRequest) -> str:
        manifest = build_job_manifest(request, self.cluster)
        job_id = manifest["metadata"]["name"]
        logger.info(
            "submitting k8s job %s to namespace %s",
            job_id,
            self.cluster.namespace,
        )
        self._kubectl(
            ["apply", "-f", "-"], stdin=json.dumps(manifest)
        )
        self.manifests[job_id] = manifest
        return job_id

    def describe(self, job_id: str) -> JobStatus:
        out = self._kubectl(
            [
                "get",
                "job",
                job_id,
                "-n",
                self.cluster.namespace,
                "-o",
                "json",
            ]
        )
        status = json.loads(out).get("status", {})
        if status.get("succeeded", 0) >= 1:
            return JobStatus.COMPLETED
        for condition in status.get("conditions", []) or []:
            if condition.get("type") == "Failed" and condition.get(
                "status"
            ) == "True":
                return JobStatus.FAILED
        if status.get("failed", 0) >= 1 and not status.get("active", 0):
            return JobStatus.FAILED
        return JobStatus.IN_PROGRESS

    def terminate_all(self) -> None:
        for job_id in self.manifests:
            try:
                self._kubectl(
                    [
                        "delete",
                        "job",
                        job_id,
                        "-n",
                        self.cluster.namespace,
                        "--ignore-not-found",
                    ]
                )
            except RuntimeError:
                logger.warning("failed to delete job %s", job_id, exc_info=True)
