"""TrainingRunConfig: the committed-YAML schema driving training runs.

The port's own copy of ``mermaid_classifier_tpu/config/run_config.py``,
validated with dataclasses instead of pydantic. A YAML file is accepted or
rejected exactly as the JAX package's pydantic v2 models (lax mode,
``extra="forbid"``) accept or reject it:

- an unknown key at any level is rejected;
- int fields take ints, bools, integral floats below 2**63 (10.0) and strings of
  ASCII digits with single underscores and an optional ".0…" tail ("10",
  " 1_000 ", "10.00"); 10.5 and "1e3" are rejected;
- float fields take ints, bools, floats and ASCII strings Python's
  ``float`` parses ("1e3", "inf");
- bool fields take bools, 0 / 1 (int or float) and the strings 0 / 1 /
  true / false / t / f / yes / no / y / n / on / off in any case;
- str fields take str (and bytes, decoded); an int, a float or a bool is
  rejected, ``env`` values included;
- ``ref_val_ratios`` takes exactly two floats (a list, tuple or set);
- null is taken only where a field is optional;
- the three training validators (``resident_dtype``,
  ``calibration_backend``, ``calibration_method``) and the model-name
  pattern.

A rejection raises ``ConfigError`` (a ``ValueError``). Contracts kept from
the JAX module: CSV paths resolve relative to the YAML's own directory;
the ``env:`` block reaches ``os.environ`` only through ``apply_env()``;
``build_options()`` builds the port's option dataclasses. PyYAML is
imported inside ``from_yaml_path`` only.

YAML layout::

    dataset:
      coralnet_manifest_uri: ...
      include_mermaid: true
      drop_growthforms: false
      label_rollup_spec_csv: rollups.csv        # sibling of this YAML
      included_labels_csv: included_labels.csv
      ref_val_ratios: [0.1, 0.1]
      subsample: {strategy: balanced, total_annotations: 500000, min_per_class: 200}
      weighting: {enabled: true, weight_ratio_cap: 5000}
    training:
      epochs: 40
      early_stopping_patience: 3
    tracking:
      experiment_name: prod
      model_name: mermaid-mlp-prod
    env:
      FEATURE_CACHE_DIR: /data/features
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import typing
from pathlib import Path

_MODEL_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")
_INT_TEXT = re.compile(r"[+-]?[0-9](?:_?[0-9])*(?:\.0+)?", re.ASCII)
_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


class ConfigError(ValueError):
    """A training config that the schema rejects."""


def _text(value: typing.Any) -> str | None:
    if isinstance(value, str):
        return value
    if isinstance(value, (bytes, bytearray)):
        return bytes(value).decode()
    return None


def lax_str(value: typing.Any, where: str) -> str:
    text = _text(value)
    if text is None:
        raise ConfigError(f"{where}: Input should be a valid string, got {value!r}")
    return text


def lax_int(value: typing.Any, where: str) -> int:
    if isinstance(value, int):
        return int(value)
    if isinstance(value, float):
        if math.isfinite(value) and value.is_integer() and abs(value) < 2.0**63:
            return int(value)
        raise ConfigError(
            f"{where}: Input should be a finite number with no fractional part,"
            f" got {value!r}"
        )
    text = _text(value)
    if text is not None:
        text = text.strip()
        if _INT_TEXT.fullmatch(text):
            return int(text.split(".")[0])
        raise ConfigError(f"{where}: Input should be a valid integer, got {value!r}")
    raise ConfigError(f"{where}: Input should be a valid integer, got {value!r}")


def lax_float(value: typing.Any, where: str) -> float:
    if isinstance(value, (int, float)):
        return float(value)
    text = _text(value)
    if text is not None and text.isascii():
        try:
            return float(text)
        except ValueError:
            pass
    raise ConfigError(f"{where}: Input should be a valid number, got {value!r}")


def lax_bool(value: typing.Any, where: str) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)) and value in (0, 1):
        return bool(value)
    text = _text(value)
    if text is not None:
        if text.lower() in _TRUE:
            return True
        if text.lower() in _FALSE:
            return False
    raise ConfigError(f"{where}: Input should be a valid boolean, got {value!r}")


def _float_pair(value: typing.Any, where: str) -> tuple[float, float]:
    if not isinstance(value, (list, tuple, set, frozenset)):
        raise ConfigError(f"{where}: Input should be a valid tuple, got {value!r}")
    items = list(value)
    if len(items) != 2:
        raise ConfigError(f"{where}: exactly two numbers, got {len(items)}")
    return tuple(lax_float(v, f"{where}[{i}]") for i, v in enumerate(items))


def _str_dict(value: typing.Any, where: str) -> dict[str, str]:
    if not isinstance(value, dict):
        raise ConfigError(f"{where}: Input should be a valid dictionary, got {value!r}")
    return {lax_str(k, f"{where} key"): lax_str(v, f"{where}.{k}")
            for k, v in value.items()}


def _path(value: typing.Any, where: str) -> Path:
    if isinstance(value, Path):
        return value
    text = _text(value)
    if text is None:
        raise ConfigError(f"{where}: Input is not a valid path, got {value!r}")
    return Path(text)


_CONVERTERS: dict[str, typing.Callable[[typing.Any, str], typing.Any]] = {
    "str": lax_str,
    "int": lax_int,
    "float": lax_float,
    "bool": lax_bool,
    "tuple[float, float]": _float_pair,
    "dict[str, str]": _str_dict,
    "Path": _path,
}


class _Section:
    """Shared validation of the config dataclasses: each field converted by
    its annotation, unknown keys rejected, then ``_check``."""

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            setattr(self, f.name, _convert(f.type, value, f"{self._name()}.{f.name}"))
        self._check()

    def _check(self) -> None:
        pass

    @classmethod
    def _name(cls) -> str:
        return cls.__name__

    @classmethod
    def from_mapping(cls, data: typing.Any, where: str | None = None):
        where = where or cls._name()
        if isinstance(data, cls):
            return data
        if not isinstance(data, dict):
            raise ConfigError(
                f"{where}: Input should be a valid dictionary, got {data!r}"
            )
        names = {f.name for f in dataclasses.fields(cls)}
        extra = [k for k in data if k not in names]
        if extra:
            raise ConfigError(f"{where}: Extra inputs are not permitted: {extra}")
        required = [
            f.name for f in dataclasses.fields(cls)
            if f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING
            and f.name not in data
        ]
        if required:
            raise ConfigError(f"{where}: Field required: {required}")
        return cls(**data)


def _convert(annotation: str, value: typing.Any, where: str) -> typing.Any:
    optional = annotation.endswith(" | None")
    base = annotation.removesuffix(" | None")
    if value is None:
        if optional:
            return None
        raise ConfigError(f"{where}: Input should not be null")
    section = _SECTIONS.get(base)
    if section is not None:
        return section.from_mapping(value, where)
    return _CONVERTERS[base](value, where)


@dataclasses.dataclass(kw_only=True)
class SubsampleConfig(_Section):
    strategy: str = "stratified"
    total_annotations: int
    min_per_class: int = 0


@dataclasses.dataclass(kw_only=True)
class WeightingConfig(_Section):
    enabled: bool = True
    weight_ratio_cap: float | None = None


@dataclasses.dataclass(kw_only=True)
class DatasetConfig(_Section):
    include_mermaid: bool = True
    coralnet_manifest_uri: str | None = None
    drop_growthforms: bool = False
    label_rollup_spec_csv: str | None = None
    included_labels_csv: str | None = None
    excluded_labels_csv: str | None = None
    ref_val_ratios: tuple[float, float] = (0.1, 0.1)
    subsample: SubsampleConfig | None = None
    weighting: WeightingConfig | None = None


@dataclasses.dataclass(kw_only=True)
class TrainingConfig(_Section):
    epochs: int = 10
    early_stopping_patience: int | None = None
    checkpoint_dir: str | None = None
    device_resident: bool = False
    resident_dtype: str = "float32"
    calibration_backend: str = "scipy"
    calibration_method: str = "sigmoid"

    def _check(self) -> None:
        # Fail at config load, not after the multi-GB feature load.
        if self.resident_dtype not in ("float32", "bfloat16", "int8"):
            raise ConfigError(
                f"resident_dtype must be 'float32', 'bfloat16' or 'int8',"
                f" got {self.resident_dtype!r}"
            )
        if self.calibration_backend not in ("scipy", "device"):
            raise ConfigError(
                f"calibration_backend must be 'scipy' or 'device', got"
                f" {self.calibration_backend!r}"
            )
        if self.calibration_method not in ("sigmoid", "temperature"):
            raise ConfigError(
                f"calibration_method must be 'sigmoid' or 'temperature',"
                f" got {self.calibration_method!r}"
            )


@dataclasses.dataclass(kw_only=True)
class TrackingConfig(_Section):
    experiment_name: str | None = None
    model_name: str | None = None
    extra_annotations_to_log: str | None = None

    def _check(self) -> None:
        # Fail at config load, not after an hour of training.
        if self.model_name is not None and not _MODEL_NAME_RE.fullmatch(
            self.model_name
        ):
            raise ConfigError(
                f"model_name {self.model_name!r} must match"
                f" {_MODEL_NAME_RE.pattern}"
            )


_SECTIONS: dict[str, type[_Section]] = {
    "SubsampleConfig": SubsampleConfig,
    "WeightingConfig": WeightingConfig,
    "DatasetConfig": DatasetConfig,
    "TrainingConfig": TrainingConfig,
    "TrackingConfig": TrackingConfig,
}


@dataclasses.dataclass(kw_only=True)
class TrainingRunConfig(_Section):
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    # Set by from_yaml_path; sibling-CSV resolution anchors here.
    config_dir: Path | None = None

    @classmethod
    def from_yaml_path(cls, path: str | Path) -> "TrainingRunConfig":
        import yaml

        path = Path(path)
        payload = yaml.safe_load(path.read_text()) or {}
        if not isinstance(payload, dict):
            raise TypeError(
                f"{path}: the config is a {type(payload).__name__}, not a mapping"
            )
        config = cls.from_mapping(payload)
        config.config_dir = path.parent.resolve()
        return config

    def _resolve_sibling(self, filename: str | None) -> str | None:
        """CSV paths are siblings of the YAML."""
        if filename is None:
            return None
        if os.path.isabs(filename):
            return filename
        assert self.config_dir is not None, "load via from_yaml_path first"
        resolved = self.config_dir / filename
        if not resolved.is_file():
            raise FileNotFoundError(
                f"config references {filename!r} but {resolved} does not exist."
            )
        return str(resolved)

    def apply_env(self) -> None:
        """Apply the env block to os.environ. Call BEFORE the settings are
        re-read (``reload_settings_from_env``)."""
        for key, value in self.env.items():
            os.environ[key] = str(value)

    def build_options(self):
        """Materialize the port's (DatasetOptions, TrainingOptions,
        TrackingOptions)."""
        from mermaid_classifier_tpu_torch.config.options import (
            DatasetOptions,
            TrackingOptions,
            TrainingOptions,
        )
        from mermaid_classifier_tpu_torch.data.subsample import SubsampleOptions
        from mermaid_classifier_tpu_torch.train.class_weights import (
            SampleWeightingOptions,
        )

        subsample = None
        if self.dataset.subsample is not None:
            subsample = SubsampleOptions(
                strategy=self.dataset.subsample.strategy,
                total_annotations=self.dataset.subsample.total_annotations,
                min_per_class=self.dataset.subsample.min_per_class,
            )
        weighting = None
        if self.dataset.weighting is not None:
            weighting = SampleWeightingOptions(
                enabled=self.dataset.weighting.enabled,
                weight_ratio_cap=self.dataset.weighting.weight_ratio_cap,
            )
        dataset_options = DatasetOptions(
            include_mermaid=self.dataset.include_mermaid,
            coralnet_manifest_uri=self.dataset.coralnet_manifest_uri,
            drop_growthforms=self.dataset.drop_growthforms,
            label_rollup_spec_csv=self._resolve_sibling(
                self.dataset.label_rollup_spec_csv
            ),
            included_labels_csv=self._resolve_sibling(self.dataset.included_labels_csv),
            excluded_labels_csv=self._resolve_sibling(self.dataset.excluded_labels_csv),
            ref_val_ratios=tuple(self.dataset.ref_val_ratios),
            subsample=subsample,
            weighting=weighting,
        )
        training_options = TrainingOptions(
            epochs=self.training.epochs,
            early_stopping_patience=self.training.early_stopping_patience,
            checkpoint_dir=self.training.checkpoint_dir,
            device_resident=self.training.device_resident,
            resident_dtype=self.training.resident_dtype,
            calibration_backend=self.training.calibration_backend,
            calibration_method=self.training.calibration_method,
        )
        tracking_options = TrackingOptions(
            experiment_name=self.tracking.experiment_name,
            model_name=self.tracking.model_name,
            extra_annotations_to_log=self.tracking.extra_annotations_to_log,
        )
        return dataset_options, training_options, tracking_options
