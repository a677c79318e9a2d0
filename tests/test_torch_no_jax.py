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
    assert int(n_modules) >= 83
    assert bad.strip() == "[]", bad


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
