"""LocalTracker: filesystem experiment tracking.

The port's own copy of ``mermaid_classifier_tpu/tracking/local_tracker.py``,
on the stdlib alone, with the same on-disk layout, so either package's
tracker reads the other's runs and registered versions:

  <root>/<experiment>/<run_id>/
      meta.json            run name, experiment, status, timestamps
      params.json          flat params dict
      tags.json            tags
      metrics/<name>.jsonl one line per logged value: {step, value, time}
      artifacts/<path>     artifact tree (CSV/JSON/YAML/PNG/...)
  <root>/_models/<name>/v<N>/   registered model versions (copied files
                                + meta.json pointing back at the run)

Metric names may contain '/' (grouping separator, like MLflow's UI).
NaN scalar values are skipped with a warning.

Artifacts are written as the JAX tracker writes them: ``log_dataframe``
takes a ``Table``, a list of records or a dict of columns and writes the
bytes ``DataFrame.to_csv(index=False)`` writes (``common.table``), and
``log_dict`` to a ``.yaml`` path writes the bytes
``yaml.safe_dump(data, sort_keys=False)`` writes for a flat dict of str
keys and None / bool / int / float / str values (``safe_dump_flat``).
``log_figure`` saves a matplotlib Figure as the JAX tracker does;
matplotlib is imported inside the call only.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import time
import uuid
from pathlib import Path
from typing import Any

from logging import getLogger

from mermaid_classifier_tpu_torch.common.table import to_csv_text

logger = getLogger(__name__)

_SAFE_SEGMENT = re.compile(r"[^A-Za-z0-9._=-]+")


def _safe_path_segment(name: str) -> str:
    return _SAFE_SEGMENT.sub("_", name)


_YAML_BOOL = re.compile(
    r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
    r"|on|On|ON|off|Off|OFF)$"
)
_YAML_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)
_YAML_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_YAML_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_YAML_TIMESTAMP = re.compile(
    r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
    r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$"
)
# Each implicit resolver of PyYAML's SafeLoader with the first characters
# it is tried on ("" for the empty string).
_YAML_RESOLVERS = (
    (_YAML_BOOL, "yYnNtTfFoO"),
    (_YAML_FLOAT, "-+0123456789."),
    (_YAML_INT, "-+0123456789"),
    (re.compile(r"^(?:<<)$"), "<"),
    (_YAML_NULL, "~nN"),
    (_YAML_TIMESTAMP, "0123456789"),
    (re.compile(r"^(?:=)$"), "="),
)


def _yaml_resolves_to_non_str(s: str) -> bool:
    if s == "":
        return True
    return any(s[0] in first and rx.match(s) for rx, first in _YAML_RESOLVERS)


def _yaml_plain_allowed(s: str) -> bool:
    """PyYAML's ``analyze_scalar`` verdict for a block-context plain scalar
    of printable ASCII."""
    if s.startswith(("---", "...")):
        return False
    if s[0] in "#,[]{}&*!|>'\"%@`":
        return False
    if s[0] in "?:-" and (len(s) == 1 or s[1] == " "):
        return False
    if s[0] == " " or s[-1] == " ":
        return False
    for i, ch in enumerate(s):
        if ch == ":" and (i + 1 == len(s) or s[i + 1] == " "):
            return False
        if ch == "#" and i > 0 and s[i - 1] == " ":
            return False
    return True


def _yaml_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(int(value))
    if isinstance(value, float):
        value = float(value)
        if value != value:
            return ".nan"
        if value in (math.inf, -math.inf):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        if any(not (" " <= ch <= "~") for ch in value):
            raise ValueError(
                f"safe_dump_flat writes printable ASCII strings only: {value!r}"
            )
        if value and not _yaml_resolves_to_non_str(value) and _yaml_plain_allowed(value):
            return value
        return "'" + value.replace("'", "''") + "'"
    raise TypeError(f"safe_dump_flat cannot write {type(value).__name__} values")


def safe_dump_flat(data: dict) -> str:
    """``yaml.safe_dump(data, sort_keys=False)`` for a flat dict of str keys
    and None / bool / int / float / printable-ASCII str values (no line
    longer than PyYAML's 80-column width)."""
    if not data:
        return "{}\n"
    lines = []
    for key, value in data.items():
        if not isinstance(key, str):
            raise TypeError(f"safe_dump_flat takes str keys, got {key!r}")
        line = f"{_yaml_scalar(key)}: {_yaml_scalar(value)}"
        if len(line) > 80 and " " in str(value):
            raise ValueError(f"safe_dump_flat does not fold long lines: {line!r}")
        lines.append(line + "\n")
    return "".join(lines)


def _jsonable(value: Any) -> Any:
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return str(value)


class Run:
    """One tracked run. Use as a context manager or call ``end()``."""

    def __init__(self, run_dir: Path, experiment: str, run_name: str, run_id: str):
        self.run_dir = run_dir
        self.run_id = run_id
        self.experiment = experiment
        self.run_name = run_name
        (run_dir / "metrics").mkdir(parents=True, exist_ok=True)
        (run_dir / "artifacts").mkdir(parents=True, exist_ok=True)
        self._params: dict[str, Any] = {}
        self._tags: dict[str, Any] = {}
        self._meta = {
            "run_id": run_id,
            "run_name": run_name,
            "experiment": experiment,
            "status": "RUNNING",
            "start_time": time.time(),
        }
        self._write_meta()

    # -- lifecycle -----------------------------------------------------------

    def _write_meta(self) -> None:
        (self.run_dir / "meta.json").write_text(json.dumps(self._meta, indent=2))

    def end(self, status: str = "FINISHED") -> None:
        self._meta["status"] = status
        self._meta["end_time"] = time.time()
        self._write_meta()

    def __enter__(self) -> "Run":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end("FAILED" if exc_type is not None else "FINISHED")

    # -- params / tags ---------------------------------------------------------

    def log_param(self, key: str, value: Any) -> None:
        self._params[key] = _jsonable(value)
        (self.run_dir / "params.json").write_text(
            json.dumps(self._params, indent=2, sort_keys=True)
        )

    def log_params(self, params: dict[str, Any]) -> None:
        for k, v in params.items():
            self._params[k] = _jsonable(v)
        (self.run_dir / "params.json").write_text(
            json.dumps(self._params, indent=2, sort_keys=True)
        )

    def set_tag(self, key: str, value: Any) -> None:
        self._tags[key] = _jsonable(value)
        (self.run_dir / "tags.json").write_text(
            json.dumps(self._tags, indent=2, sort_keys=True)
        )

    # -- metrics ------------------------------------------------------------------

    def log_metric(self, name: str, value: float, step: int | None = None) -> None:
        value = float(value)
        if math.isnan(value) or math.isinf(value):
            logger.warning(
                "Skipping metric %r with non-finite value %r", name, value
            )
            return
        path = self.run_dir / "metrics" / (
            "/".join(_safe_path_segment(p) for p in name.split("/")) + ".jsonl"
        )
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("a") as f:
            f.write(
                json.dumps({"step": step, "value": value, "time": time.time()}) + "\n"
            )

    def log_metrics(self, metrics: dict[str, float], step: int | None = None) -> None:
        for name, value in metrics.items():
            self.log_metric(name, value, step=step)

    # -- artifacts -----------------------------------------------------------------

    def _artifact_path(self, artifact_path: str) -> Path:
        path = (self.run_dir / "artifacts" / artifact_path).resolve()
        if not str(path).startswith(str((self.run_dir / "artifacts").resolve())):
            raise ValueError(f"artifact path escapes the run: {artifact_path!r}")
        path.parent.mkdir(parents=True, exist_ok=True)
        return path

    def log_dict(self, data: dict, artifact_path: str) -> None:
        path = self._artifact_path(artifact_path)
        if artifact_path.endswith((".yaml", ".yml")):
            path.write_text(safe_dump_flat(data))
        else:
            path.write_text(json.dumps(data, indent=2, default=str))

    def log_text(self, text: str, artifact_path: str) -> None:
        self._artifact_path(artifact_path).write_text(text)

    def log_dataframe(self, table: Any, artifact_path: str) -> None:
        """Write a Table, records or a dict of columns as CSV."""
        with open(self._artifact_path(artifact_path), "w", newline="") as f:
            f.write(to_csv_text(table))

    def log_figure(self, fig: Any, artifact_path: str, **save_kwargs: Any) -> None:
        """``fig.savefig`` into the run, ``bbox_inches="tight"`` unless the
        caller's kwargs say otherwise; the figure is closed either way."""
        kwargs: dict[str, Any] = {"bbox_inches": "tight"}
        kwargs.update(save_kwargs)
        try:
            fig.savefig(self._artifact_path(artifact_path), **kwargs)
        finally:
            import matplotlib.pyplot as plt

            plt.close(fig)

    def log_artifact(self, local_path: str | Path, artifact_path: str | None = None) -> None:
        local_path = Path(local_path)
        dest = self._artifact_path(
            artifact_path if artifact_path else local_path.name
        )
        if artifact_path and not Path(artifact_path).suffix:
            dest = dest / local_path.name
            dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(local_path, dest)

    # -- read API (report generation) -------------------------------------------

    def params(self) -> dict[str, Any]:
        path = self.run_dir / "params.json"
        return json.loads(path.read_text()) if path.exists() else {}

    def metric_history(self, name: str) -> list[dict]:
        path = self.run_dir / "metrics" / (name + ".jsonl")
        if not path.exists():
            return []
        return [json.loads(line) for line in path.read_text().splitlines() if line]

    def latest_metrics(self) -> dict[str, float]:
        out: dict[str, float] = {}
        metrics_root = self.run_dir / "metrics"
        for path in sorted(metrics_root.rglob("*.jsonl")):
            name = str(path.relative_to(metrics_root))[: -len(".jsonl")]
            lines = path.read_text().splitlines()
            if lines:
                out[name] = json.loads(lines[-1])["value"]
        return out

    def artifact(self, artifact_path: str) -> Path:
        return self.run_dir / "artifacts" / artifact_path

    def list_artifacts(self) -> list[str]:
        root = self.run_dir / "artifacts"
        return sorted(
            str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()
        )


class LocalTracker:
    """Tracker root; creates runs and registers models."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def start_run(
        self, experiment_name: str, run_name: str | None = None
    ) -> Run:
        run_id = uuid.uuid4().hex[:16]
        run_name = run_name or f"run-{run_id[:8]}"
        run_dir = self.root / _safe_path_segment(experiment_name) / run_id
        return Run(run_dir, experiment_name, run_name, run_id)

    def runs(self, experiment_name: str) -> list[Run]:
        exp_dir = self.root / _safe_path_segment(experiment_name)
        out = []
        if exp_dir.is_dir():
            for run_dir in sorted(exp_dir.iterdir()):
                meta_path = run_dir / "meta.json"
                if meta_path.is_file():
                    meta = json.loads(meta_path.read_text())
                    run = Run.__new__(Run)
                    run.run_dir = run_dir
                    run.run_id = meta["run_id"]
                    run.experiment = meta["experiment"]
                    run.run_name = meta["run_name"]
                    run._meta = meta
                    run._params = run.params()
                    run._tags = {}
                    out.append(run)
        # Chronological, not directory-name order: run ids are random hex,
        # and callers rely on runs[-1] being the LATEST run.
        out.sort(key=lambda r: r._meta.get("start_time", 0.0))
        return out

    def get_run(self, run_id: str) -> Run:
        for exp_dir in self.root.iterdir():
            if exp_dir.name == "_models" or not exp_dir.is_dir():
                continue
            run_dir = exp_dir / run_id
            if (run_dir / "meta.json").is_file():
                meta = json.loads((run_dir / "meta.json").read_text())
                run = Run.__new__(Run)
                run.run_dir = run_dir
                run.run_id = run_id
                run.experiment = meta["experiment"]
                run.run_name = meta["run_name"]
                run._meta = meta
                run._params = run.params()
                run._tags = {}
                return run
        raise KeyError(f"run {run_id!r} not found under {self.root}")

    # -- model registry ------------------------------------------------------------

    def register_model(
        self, name: str, files: list[str | Path], run: Run | None = None
    ) -> Path:
        """Register a new version of ``name`` from artifact files; returns
        the version directory."""
        model_root = self.root / "_models" / _safe_path_segment(name)
        model_root.mkdir(parents=True, exist_ok=True)
        existing = [
            int(p.name[1:])
            for p in model_root.iterdir()
            if p.is_dir() and re.fullmatch(r"v\d+", p.name)
        ]
        version = max(existing, default=0) + 1
        version_dir = model_root / f"v{version}"
        version_dir.mkdir()
        for f in files:
            shutil.copy2(f, version_dir / Path(f).name)
        meta = {
            "name": name,
            "version": version,
            "run_id": run.run_id if run else None,
            "registered_at": time.time(),
        }
        (version_dir / "registry_meta.json").write_text(json.dumps(meta, indent=2))
        return version_dir

    def model_version(self, name: str, version: str) -> Path | None:
        """Directory of a specific registered version ('v<N>'), or None.
        Applies the same name sanitization as register_model."""
        if not re.fullmatch(r"v\d+", version):
            return None
        version_dir = self.root / "_models" / _safe_path_segment(name) / version
        return version_dir if version_dir.is_dir() else None

    def latest_model_version(self, name: str) -> Path | None:
        model_root = self.root / "_models" / _safe_path_segment(name)
        if not model_root.is_dir():
            return None
        versions = sorted(
            (
                int(p.name[1:])
                for p in model_root.iterdir()
                if p.is_dir() and re.fullmatch(r"v\d+", p.name)
            ),
        )
        return model_root / f"v{versions[-1]}" if versions else None


def get_default_tracker() -> LocalTracker:
    from mermaid_classifier_tpu_torch.config.settings import settings

    root = settings.tracking_dir
    if not root:
        raise ValueError(
            "settings.tracking_dir is not set; configure TRACKING_DIR or pass"
            " a LocalTracker explicitly."
        )
    return LocalTracker(root)
