"""Job backends: submit/describe semantics behind one interface.

The port's own copy of ``mermaid_classifier_tpu/jobs/backend.py`` (standard
library only). The reference submits CreateProcessingJob / CreateTrainingJob requests and
polls describe_* until a terminal status (reference:
launch_processing.py:135-165). The same contract here:

- ``submit(request) -> job_id``
- ``describe(job_id) -> JobStatus`` with terminal-state semantics

Backends:
- ``LocalProcessBackend`` — each job is a subprocess on this host (the
  idiomatic single-machine fan-out; workers coordinate only through the
  object store, exactly like the reference's remote workers).
- ``DryRunBackend`` — records requests without running anything
  (reference: launch_processing.py:214-224 dry-run mode).
"""

from __future__ import annotations

import enum
import os
import subprocess
import sys
from dataclasses import dataclass, field
from logging import getLogger
from pathlib import Path

logger = getLogger(__name__)


class JobStatus(str, enum.Enum):
    IN_PROGRESS = "InProgress"
    COMPLETED = "Completed"
    FAILED = "Failed"

    @property
    def terminal(self) -> bool:
        return self is not JobStatus.IN_PROGRESS


@dataclass
class JobRequest:
    """One job submission: a command line plus env and metadata tags
    (the analog of the reference's request dict, launch_processing.py:81-124)."""

    name: str
    command: list[str]
    env: dict[str, str] = field(default_factory=dict)
    tags: dict[str, str] = field(default_factory=dict)
    log_path: str | None = None


class JobBackend:
    def submit(self, request: JobRequest) -> str:
        raise NotImplementedError

    def describe(self, job_id: str) -> JobStatus:
        raise NotImplementedError


class DryRunBackend(JobBackend):
    """Records requests; every job is immediately Completed."""

    def __init__(self) -> None:
        self.requests: list[JobRequest] = []

    def submit(self, request: JobRequest) -> str:
        self.requests.append(request)
        return f"dryrun-{len(self.requests) - 1}"

    def describe(self, job_id: str) -> JobStatus:
        return JobStatus.COMPLETED


class LocalProcessBackend(JobBackend):
    """Each job is a local subprocess; stdout/stderr tee to a log file."""

    def __init__(self, log_dir: str | Path | None = None) -> None:
        self.log_dir = Path(log_dir) if log_dir else None
        self._procs: dict[str, subprocess.Popen] = {}

    def submit(self, request: JobRequest) -> str:
        job_id = f"{request.name}-{len(self._procs)}"
        env = {**os.environ, **request.env}
        log_path = request.log_path
        if log_path is None and self.log_dir is not None:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            log_path = str(self.log_dir / f"{job_id}.log")
        logger.info("submitting job %s: %s", job_id, " ".join(request.command))
        if log_path:
            # The child inherits the descriptor; closing the parent's copy
            # right after Popen means no handle outlives submit() even on
            # --no-wait paths where describe() is never called.
            with open(log_path, "w") as stdout:
                self._procs[job_id] = subprocess.Popen(
                    request.command,
                    env=env,
                    stdout=stdout,
                    stderr=subprocess.STDOUT,
                )
        else:
            self._procs[job_id] = subprocess.Popen(
                request.command, env=env, stdout=subprocess.DEVNULL
            )
        return job_id

    def describe(self, job_id: str) -> JobStatus:
        rc = self._procs[job_id].poll()
        if rc is None:
            return JobStatus.IN_PROGRESS
        return JobStatus.COMPLETED if rc == 0 else JobStatus.FAILED

    def terminate_all(self, timeout: float = 10.0) -> None:
        """Kill every still-running job (launcher shutdown / test cleanup);
        no orphaned workers survive the backend."""
        for proc in self._procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in self._procs.values():
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def python_command(script: str, args: list[str]) -> list[str]:
    """The interpreter-invocation shim (the entrypoint.sh analog)."""
    return [sys.executable, script, *args]
