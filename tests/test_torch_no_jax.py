"""Import and no-fallback guards of the PyTorch port.

Every module of ``mermaid_classifier_tpu_torch`` imports without jax, flax,
optax, sklearn, pandas, PIL, ml_dtypes, pyarrow, yaml, psutil, pydantic,
matplotlib or any module of the JAX package
``mermaid_classifier_tpu`` (checked in a fresh interpreter: the test process
has jax loaded by tests/conftest.py), and ``chip_smoke.py`` refuses to run —
exit code non-zero, no ``"ok": true`` — where there is no CUDA card or no
port beside it."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# The top-level name of each module: "mermaid_classifier_tpu_torch" is its
# own name, not the JAX package's.
FORBIDDEN = ("jax", "flax", "optax", "sklearn", "pandas", "PIL", "ml_dtypes",
             "pyarrow", "yaml", "psutil", "pydantic", "matplotlib",
             "mermaid_classifier_tpu")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
import mermaid_classifier_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
print(len(names), bad)
"""


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax_pandas_or_pil():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_clean_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    n_modules, bad = proc.stdout.split(" ", 1)
    assert int(n_modules) >= 109
    assert bad.strip() == "[]", bad


NEW_MODULES = (
    "mermaid_classifier_tpu_torch.models.remap",
    "mermaid_classifier_tpu_torch.models.canonical_mirror",
    "mermaid_classifier_tpu_torch.scripts.diff_backbone",
    "mermaid_classifier_tpu_torch.scripts.extract_reference_features",
    "mermaid_classifier_tpu_torch.native",
    "mermaid_classifier_tpu_torch.native.fastbatch",
    "mermaid_classifier_tpu_torch.train.quality_parity",
    "mermaid_classifier_tpu_torch.scripts.quality_parity_bench",
    "mermaid_classifier_tpu_torch.scripts.full_recipe_drive",
    "mermaid_classifier_tpu_torch.scripts.feature_bucket_drive",
    "mermaid_classifier_tpu_torch.scripts.sklearn_reference_baseline",
)


def test_landing_strip_cache_and_quality_modules_in_the_walk():
    """The weight landing strip, the packed cache, the quality check and
    the at-scale drives are walked (and so import-checked) above, and
    importing the native module builds nothing."""
    code = (
        "import pkgutil, mermaid_classifier_tpu_torch as pkg\n"
        "from mermaid_classifier_tpu_torch.native import fastbatch\n"
        "names = {m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')}\n"
        f"print(sorted(set({NEW_MODULES!r}) - names), fastbatch._lib)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] None"


JOB_MODULES = (
    "mermaid_classifier_tpu_torch.jobs",
    "mermaid_classifier_tpu_torch.jobs.backend",
    "mermaid_classifier_tpu_torch.jobs.launcher_config",
    "mermaid_classifier_tpu_torch.jobs.launch",
    "mermaid_classifier_tpu_torch.jobs.kubernetes",
    "mermaid_classifier_tpu_torch.scripts.launch_processing",
    "mermaid_classifier_tpu_torch.scripts.launch_training",
    "mermaid_classifier_tpu_torch.scripts.e2e_smoke",
)


def test_job_layer_modules_in_the_walk_and_free_of_torch():
    """The job layer and its CLIs are walked (and so import-checked)
    above, and importing them loads no torch or numpy: a launcher starts
    in well under a second, its workers import the model stack."""
    code = (
        "import importlib, pkgutil, sys, mermaid_classifier_tpu_torch as pkg\n"
        f"for name in {JOB_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy'))\n"
        "names = {m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')}\n"
        f"print(sorted(set({JOB_MODULES!r}) - names), heavy)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] []"


def test_chip_smoke_fails_without_cuda():
    env = _clean_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


PARALLEL_MODULES = (
    "mermaid_classifier_tpu_torch.parallel",
    "mermaid_classifier_tpu_torch.parallel.mesh",
    "mermaid_classifier_tpu_torch.parallel.sharded_extract",
    "mermaid_classifier_tpu_torch.parallel.sharded_serve",
    "mermaid_classifier_tpu_torch.parallel.sharded_train",
    "mermaid_classifier_tpu_torch.parallel.preflight",
    "mermaid_classifier_tpu_torch.scripts.dryrun_multihost",
)


def test_parallel_layer_modules_in_the_walk():
    """The parallel layer and the port's multi-process dryrun are walked
    (and so import-checked) above, and importing them starts no process
    group."""
    code = (
        "import importlib, pkgutil, mermaid_classifier_tpu_torch as pkg\n"
        "import torch.distributed as dist\n"
        f"for name in {PARALLEL_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "names = {m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')}\n"
        f"print(sorted(set({PARALLEL_MODULES!r}) - names), dist.is_initialized())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] False"
