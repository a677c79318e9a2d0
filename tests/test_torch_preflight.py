"""The port's production-geometry preflight against the JAX one.

The port side runs in 8 gloo ranks (``tests/test_torch_parallel_worker.py``,
one shared deadline); the JAX side on conftest's 8 virtual CPU devices. At
JAX's ``REDUCED`` geometry (``tests/parallel/test_preflight.py``) the
padding arithmetic equals JAX's report key for key (``rows_padded`` 1008,
``batch_rows`` 200, the head's 40 rows), on every rank; the dtype variants
run; the full C2 resident leg (449,099 x 4096 int8) runs on ``meta`` and
its per-rank buffer is JAX's ``buffer_gb_per_device``; an indivisible
extraction batch raises as in JAX.
"""

import time

import jax
import pytest

from mermaid_classifier_tpu.parallel.mesh import make_mesh
from mermaid_classifier_tpu.parallel.preflight import (
    C2_GEOMETRY,
    production_geometry_report,
)
from mermaid_classifier_tpu_torch.parallel import preflight as tpreflight
from tests.parallel.test_preflight import REDUCED
from tests.test_torch_parallel_worker import collect, start_ranks

WORLD = 8
GEOMETRIES = {
    "reduced": REDUCED,
    **{f"reduced_{d}": {**REDUCED, "resident_dtype": d}
       for d in ("float32", "bfloat16", "int8")},
    "c2_resident": {**C2_GEOMETRY, "extract_batch": WORLD, "val_rows": WORLD},
    "indivisible": {**REDUCED, "extract_batch": WORLD + 1},
}
ARITHMETIC = {
    "resident_epoch": ("rows", "rows_padded", "dim", "dtype", "n_batches",
                       "batch_rows", "buffer_gb_per_device"),
    "serve_head": ("rows", "rows_padded", "n_classes"),
    "extract_b0": ("batch", "patch"),
}


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("preflight_ranks")
    procs = start_ranks(WORLD, run_dir, {"preflight": GEOMETRIES}, ["preflight"])
    ranks = collect(procs, run_dir, time.monotonic() + 150)
    for rank, res in enumerate(ranks):
        assert "error" not in res["preflight"], (rank, res["preflight"]["error"])
    return [res["preflight"] for res in ranks]


@pytest.fixture(scope="module")
def jax_reduced():
    assert len(jax.devices()) == WORLD
    return production_geometry_report(make_mesh(WORLD), REDUCED)


def test_c2_geometry_matches_jax():
    assert tpreflight.C2_GEOMETRY == C2_GEOMETRY


def test_reduced_geometry_matches_jax(reports, jax_reduced):
    for report in reports:
        got = report["reduced"]
        assert got["devices"] == jax_reduced["devices"] == WORLD
        for leg, keys in ARITHMETIC.items():
            assert got[leg]["seconds"] >= 0.0
            assert got[leg]["argument_mb"] >= 0.0 and got[leg]["output_mb"] >= 0.0
            for key in keys:
                assert got[leg][key] == jax_reduced[leg][key], (leg, key)
        re = got["resident_epoch"]
        assert re["rows_padded"] == 1008  # 1001 -> next multiple of 8
        assert re["batch_rows"] == 200
        assert re["n_batches"] == -(-1001 // 200)
        assert got["serve_head"]["rows_padded"] == 40  # 33 -> 40


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_dtype_variants(reports, dtype):
    itemsize = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    for report in reports:
        re = report[f"reduced_{dtype}"]["resident_epoch"]
        assert re["dtype"] == dtype
        assert re["buffer_gb_per_device"] == round(1008 * 64 * itemsize / WORLD / 1e9, 2)


def test_full_c2_resident_leg(reports):
    for report in reports:
        re = report["c2_resident"]["resident_epoch"]
        assert re["rows"] == 449_099 and re["dtype"] == "int8"
        assert re["rows_padded"] == 449_104
        assert re["buffer_gb_per_device"] == round(449_104 * 4096 / WORLD / 1e9, 2)


def test_indivisible_extract_batch_rejected(reports):
    for report in reports:
        assert report["indivisible"].startswith("ValueError: ")
        assert "must divide" in report["indivisible"]
