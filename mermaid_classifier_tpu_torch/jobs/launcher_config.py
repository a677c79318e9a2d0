"""Launcher run-config YAML schema (reference analog:
mermaid_classifier/sagemaker/launcher_config.py:22-115).

The port's own copy of ``mermaid_classifier_tpu/jobs/launcher_config.py``,
validated with dataclasses instead of pydantic. A YAML document is accepted
or rejected exactly as the JAX package's pydantic v2 models (lax mode,
``extra="forbid"``) accept or reject it, through the coercers of
``config/run_config.py``:

- int fields take ints, bools, integral floats and strings of digits
  ("4", 4.0 and True are ints; 4.5 and "1e3" are not); ``shard.workers``
  must then be at least 1;
- str fields take str only: ``env``, ``tags``, ``cpu`` and ``memory`` given
  an int are rejected;
- ``container_args`` is a list of str;
- a missing ``job:`` is rejected, and so is a ``processing:`` block
  without ``shard:``;
- the loose parse (``strict=False``, the container side) ignores unknown
  top-level blocks only: an unknown key inside ``job:``, ``processing:``,
  ``shard:``, ``training:`` or ``cluster:`` is still rejected;
- ``config_dir`` is a field (a path), so a YAML may set it;
  ``parse_run_config`` then overwrites it with the YAML's own directory.

A rejection raises ``ConfigError`` (a ``ValueError``). PyYAML is imported
inside ``parse_run_config`` only.

Layout::

    job:
      entrypoint: mermaid_classifier_tpu_torch/scripts/build_feature_bucket.py
      env: {FEATURE_CACHE_DIR: /data/cache}
      tags: {team: mermaid}
      cluster: {image: ..., accelerator: nvidia-h100-80gb}   # k8s runs only
    processing:                      # present for extraction fan-out runs
      container_args: [--source-bucket, reef-images, --target-bucket, reef-features]
      shard:
        items_csv: sources.csv       # sibling of this YAML
        workers: 4
        per_worker_arg: --source-ids
    training:                        # present for training runs
      config_dir: config/            # sibling of this YAML
      config_name: training_config.yaml
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from pathlib import Path

from mermaid_classifier_tpu_torch.config.run_config import (
    ConfigError,
    _str_dict,
    lax_bool,
    lax_int,
    lax_str,
)


def _str_list(value: typing.Any, where: str) -> list[str]:
    if not isinstance(value, (list, tuple, set, frozenset)):
        raise ConfigError(f"{where}: Input should be a valid list, got {value!r}")
    return [lax_str(v, f"{where}[{i}]") for i, v in enumerate(value)]


def _path(value: typing.Any, where: str) -> Path:
    if isinstance(value, Path):
        return value
    return Path(lax_str(value, where))


def _workers(value: typing.Any, where: str) -> int:
    workers = lax_int(value, where)
    if workers < 1:
        raise ConfigError(f"{where}: workers must be >= 1, got {workers}")
    return workers


def _optional(convert):
    def optional(value: typing.Any, where: str):
        return None if value is None else convert(value, where)
    return optional


def _section(cls):
    def section(value: typing.Any, where: str):
        return cls.from_mapping(value, where)
    return section


class _Block:
    """Shared validation: each field through its converter, unknown keys
    rejected (or, for the loose top level, ignored), required fields
    checked."""

    @classmethod
    def _converters(cls) -> dict:
        raise NotImplementedError

    @classmethod
    def from_mapping(cls, data: typing.Any, where: str | None = None, *,
                     ignore_extra: bool = False):
        where = where or cls.__name__
        if not isinstance(data, dict):
            raise ConfigError(f"{where}: Input should be a valid dictionary, got {data!r}")
        converters = cls._converters()
        extra = [k for k in data if k not in converters]
        if extra and not ignore_extra:
            raise ConfigError(f"{where}: Extra inputs are not permitted: {extra}")
        values = {}
        for f in dataclasses.fields(cls):
            if f.name in data:
                values[f.name] = converters[f.name](data[f.name], f"{where}.{f.name}")
            elif (f.default is dataclasses.MISSING
                  and f.default_factory is dataclasses.MISSING):
                raise ConfigError(f"{where}: Field required: {f.name}")
        return cls(**values)


@dataclass
class ShardSpec(_Block):
    items_csv: str
    workers: int = 1
    per_worker_arg: str = "--source-ids"

    @classmethod
    def _converters(cls) -> dict:
        return {"items_csv": lax_str, "workers": _workers, "per_worker_arg": lax_str}


@dataclass
class ProcessingSpec(_Block):
    shard: ShardSpec
    container_args: list[str] = field(default_factory=list)

    @classmethod
    def _converters(cls) -> dict:
        return {"container_args": _str_list, "shard": _section(ShardSpec)}


@dataclass
class TrainingSpec(_Block):
    config_dir: str = "config"
    config_name: str = "training_config.yaml"
    container_args: list[str] = field(default_factory=list)

    @classmethod
    def _converters(cls) -> dict:
        return {"config_dir": lax_str, "config_name": lax_str,
                "container_args": _str_list}


@dataclass
class ClusterBlock(_Block):
    """Kubernetes placement for cluster-backed runs (jobs/kubernetes.py).
    Absent -> local/dry-run backends only."""

    image: str
    namespace: str = "default"
    accelerator: str | None = None
    topology: str | None = None
    chips: int = 0
    cpu: str = "4"
    memory: str = "16Gi"
    spot: bool = False
    service_account: str | None = None
    active_deadline_seconds: int | None = None

    @classmethod
    def _converters(cls) -> dict:
        return {
            "image": lax_str, "namespace": lax_str,
            "accelerator": _optional(lax_str), "topology": _optional(lax_str),
            "chips": lax_int, "cpu": lax_str, "memory": lax_str, "spot": lax_bool,
            "service_account": _optional(lax_str),
            "active_deadline_seconds": _optional(lax_int),
        }


@dataclass
class JobSpec(_Block):
    entrypoint: str
    env: dict[str, str] = field(default_factory=dict)
    tags: dict[str, str] = field(default_factory=dict)
    cluster: ClusterBlock | None = None

    @classmethod
    def _converters(cls) -> dict:
        return {"entrypoint": lax_str, "env": _str_dict, "tags": _str_dict,
                "cluster": _optional(_section(ClusterBlock))}


@dataclass
class RunConfig(_Block):
    job: JobSpec
    processing: ProcessingSpec | None = None
    training: TrainingSpec | None = None

    # Set by parse_run_config; sibling paths resolve against it.
    config_dir: Path | None = None

    @classmethod
    def _converters(cls) -> dict:
        return {"job": _section(JobSpec),
                "processing": _optional(_section(ProcessingSpec)),
                "training": _optional(_section(TrainingSpec)),
                "config_dir": _optional(_path)}

    def resolve_sibling(self, filename: str) -> Path:
        base = self.config_dir or Path.cwd()
        resolved = (base / filename).resolve()
        if not resolved.exists():
            raise FileNotFoundError(
                f"run config references {filename!r} but {resolved} does not"
                " exist."
            )
        return resolved


def parse_run_config(path: str | Path, *, strict: bool = True) -> RunConfig:
    """The run YAML at ``path``, validated strict (the launcher) or loose
    (unknown top-level blocks ignored: the container side)."""
    import yaml

    path = Path(path)
    data = yaml.safe_load(path.read_text())
    if not isinstance(data, dict):
        raise ValueError(f"run config {path} is not a YAML mapping.")
    config = RunConfig.from_mapping(data, ignore_extra=not strict)
    config.config_dir = path.parent.resolve()
    return config
