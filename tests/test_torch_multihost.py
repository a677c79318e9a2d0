"""The port's multi-process dryrun (``mermaid_classifier_tpu_torch/scripts/
dryrun_multihost.py``) on the CPU, beside the JAX one
(``tests/parallel/test_multihost.py``): gloo ranks grouped per simulated
host, the model dim kept inside a host, and the classifier's mesh paths
held to mesh-less runs (losses within 1e-5, probabilities rtol 1e-5 /
atol 1e-6) inside each worker. Exit 0 with the OK marker, or the workers'
logs on failure."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from mermaid_classifier_tpu_torch.scripts.dryrun_multihost import OK_MARKER

REPO = Path(__file__).resolve().parents[1]


def _run(*args, timeout=150):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "mermaid_classifier_tpu_torch.scripts.dryrun_multihost",
         "--timeout", "120", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("processes,local_ranks", [(4, 2), (2, 1)],
                         ids=["2_hosts_x_2", "2_hosts_x_1"])
def test_dryrun_passes(processes, local_ranks):
    proc = _run("--processes", str(processes), "--local-ranks", str(local_ranks))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    assert f"{OK_MARKER}: {processes} processes" in proc.stdout
    assert proc.stdout.count(" ok\n") == processes


def test_dryrun_rejects_uneven_hosts():
    proc = _run("--processes", "4", "--local-ranks", "3")
    assert proc.returncode != 0
    assert "--local-ranks 3 must divide --processes 4" in proc.stderr
    assert OK_MARKER not in proc.stdout
