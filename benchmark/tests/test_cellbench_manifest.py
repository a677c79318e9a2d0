"""BENCHMARK.json against the contract's rules, and the harness finding
what it names by name."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.manifest import Manifest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def data():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_and_units_use_only_the_allowed_characters():
    d = data()
    metrics = d["end_to_end"] + d["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in d["configs"]] + \
        [w["name"] for w in d["workloads"]]
    names += [w["config"] for w in d["workloads"]] + [w["traffic"] for w in d["workloads"]]
    names += [k for c in d["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for kind in (metrics, d["configs"], d["workloads"]):
        assert len({x["name"] for x in kind}) == len(kind)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") and m["source"] in SOURCES for m in metrics)
    assert all(m["source"] in ("host_clock", "device_trace") for m in d["end_to_end"])
    assert all(one_line(x["why"]) for x in d["configs"] + d["workloads"])
    assert all(one_line(m["layer"]) for m in d["per_layer"])
    assert all(one_line(c["source"]) for c in d["configs"])
    assert all(one_line(w) for w in d["command"])
    assert 0 < d["run_seconds"] <= 51 and isinstance(d["run_seconds"], int)
    assert all(0.01 <= m["bound"] <= 0.25 for m in d["end_to_end"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_file_a_name_points_to_exists():
    d = data()
    home = ROOT / "benchmark"
    for c in d["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in d["workloads"]:
        traffic = json.loads((home / "traffic" / f"{w['traffic']}.json").read_text())
        assert (home / "traffic" / f"{traffic['kind']}.py").is_file()
        assert (home / "limits" / f"{w['name']}.json").is_file()
    for m in d["per_layer"]:
        assert (home / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in data()["workloads"]])
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = Manifest().cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    # Every per-layer metric's ``moves`` is reported in each of its cells.
    assert all(m["moves"] in e2e for m in c.per_layer)
    assert all(set(c.limits[k]) >= {"limit"} for k in c.limits)


def test_per_layer_moves_is_reported_in_each_of_its_cells():
    d = data()
    for m in d["per_layer"]:
        for cell in m.get("workloads", [w["name"] for w in d["workloads"]]):
            moved = next(e for e in d["end_to_end"] if e["name"] == m["moves"])
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_are_found_without_editing_a_file(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "benchmark")
    home = tmp_path / "benchmark"
    config = json.loads((home / "configs" / "effnet_b0_224.json").read_text())
    config["backbone"]["patch_size"] = 240
    (home / "configs" / "effnet_b0_240.json").write_text(json.dumps(config))
    mix = json.loads((home / "traffic" / "bulk_200pt.json").read_text())
    mix["points_per_image"] = 25
    (home / "traffic" / "bulk_25pt.json").write_text(json.dumps(mix))
    (home / "metrics" / "bulk_points_total.py").write_text(
        "def read(record):\n    return record.get('patches')\n")
    (home / "limits" / "b0_240_bulk_25pt.json").write_text(
        json.dumps({"bad_files": {"limit": 0}, "feature_gap": {"limit": 0.055}}))
    d = data()
    d["configs"].append({"name": "effnet_b0_240", "source": "x", "why": "x", "reduced": [],
                         "file": "benchmark/configs/effnet_b0_240.json"})
    d["workloads"].append({"name": "b0_240_bulk_25pt", "config": "effnet_b0_240",
                           "traffic": "bulk_25pt", "chips": 1, "why": "x"})
    d["per_layer"].append({"name": "bulk_points_total", "unit": "patches", "better": "higher",
                           "source": "host_clock", "layer": "builder",
                           "moves": "bulk_patches_per_s", "workloads": ["b0_240_bulk_25pt"]})
    d["end_to_end"][1]["workloads"].append("b0_240_bulk_25pt")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(d))

    cell = Manifest(tmp_path).cell("b0_240_bulk_25pt")
    assert cell.config["backbone"]["patch_size"] == 240
    assert cell.traffic["points_per_image"] == 25
    assert cell.driver().Cell is not None
    names = [m["name"] for m in cell.per_layer]
    assert "bulk_points_total" in names
    metric = next(m for m in cell.per_layer if m["name"] == "bulk_points_total")
    assert cell.reader(metric).read({"patches": 7}) == 7
    after = _digests(home)
    assert {k: v for k, v in after.items() if k in before} == before
