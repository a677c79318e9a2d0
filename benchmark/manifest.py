"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration's sizes: the ``file`` of its entry in ``configs``;
- a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``kind``
  names the driver module ``benchmark/traffic/<kind>.py``;
- a per-layer metric's reader: ``benchmark/metrics/<name>.py``, with a
  ``read(record)`` that returns a number or None;
- a cell's limits for ``correct``: ``benchmark/limits/<cell>.json``, each
  number's ``limit`` beside the readings it was set from.

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    home: Path = HERE

    def driver(self):
        kind = self.traffic["kind"]
        return load_module(self.home / "traffic" / f"{kind}.py", f"benchmark.traffic.{kind}")

    def reader(self, metric: dict):
        """The per-layer metric's reader module."""
        return load_module(self.home / "metrics" / f"{metric['name']}.py",
                           f"benchmark.metrics.{metric['name']}")


class Manifest:
    """``BENCHMARK.json`` of the checkout at ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.home = self.root / HERE.name
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _reports(self, metric: dict, cell: str, e2e_names: set[str] | None = None) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        return e2e_names is None or metric["moves"] in e2e_names

    def cell(self, name: str) -> Cell:
        entries = {w["name"]: w for w in self.data["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
        entry = entries[name]
        config_entry = {c["name"]: c for c in self.data["configs"]}[entry["config"]]
        e2e = [m for m in self.data["end_to_end"] if self._reports(m, name)]
        names = {m["name"] for m in e2e}
        return Cell(
            name=name,
            chips=int(entry["chips"]),
            config=json.loads((self.root / config_entry["file"]).read_text()),
            traffic=json.loads((self.home / "traffic" / f"{entry['traffic']}.json").read_text()),
            limits=json.loads((self.home / "limits" / f"{name}.json").read_text()),
            end_to_end=e2e,
            per_layer=[m for m in self.data["per_layer"] if self._reports(m, name, names)],
            home=self.home,
        )
