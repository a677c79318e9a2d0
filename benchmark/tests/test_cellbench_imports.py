"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references load nothing of the program. Top-level module names are
compared whole: ``mermaid_classifier_tpu_torch`` is the program, not the
JAX package ``mermaid_classifier_tpu``."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def loaded_top_level(code: str) -> set[str]:
    script = (f"import sys, json\nsys.path.insert(0, {str(ROOT)!r})\n{code}\n"
              "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_and_every_cells_modules_load_no_jax():
    from benchmark.run import FORBIDDEN

    names = loaded_top_level(
        "import benchmark.run\n"
        "from benchmark.manifest import Manifest\n"
        "m = Manifest()\n"
        "for w in m.data['workloads']:\n"
        "    c = m.cell(w['name']); c.driver()\n"
        "    [c.reader(x) for x in c.per_layer]\n")
    assert "mermaid_classifier_tpu_torch" in names  # the program is loaded ...
    assert not names & set(FORBIDDEN)               # ... and nothing of JAX


def test_the_references_load_nothing_of_the_program():
    names = loaded_top_level(
        "import benchmark.reference.efficientnet, benchmark.reference.mlp\n"
        "import benchmark.compare, benchmark.costs, benchmark.weights, benchmark.corpus\n")
    assert not names & {"mermaid_classifier_tpu_torch", "mermaid_classifier_tpu", "jax",
                        "jaxlib", "flax", "optax"}


def test_forbidden_modules_compares_top_level_names_whole(monkeypatch):
    import types

    from benchmark.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "mermaid_classifier_tpu_torch_x", types.ModuleType("x"))
    assert "mermaid_classifier_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "mermaid_classifier_tpu.ops", types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("z"))
    assert {"mermaid_classifier_tpu", "jaxlib"} <= set(forbidden_modules())
