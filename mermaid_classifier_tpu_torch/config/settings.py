"""Environment-driven settings.

The port's own copy of ``mermaid_classifier_tpu/config/settings.py`` as a
plain dataclass (no pydantic): lowercase field names in code, UPPERCASE
environment variables, an optional ``.env`` file in the working directory,
the same fields and defaults, and no import-time side effect beyond reading
the environment. Forwarding settings into other layers' environment
variables happens only through the explicit ``apply_settings_to_env()``.

A value read from the environment is converted to the field's type as
pydantic converts it: ints parsed, and for a string or optional field the
string as given.

The auto batch size for head training reads available host memory from
``/proc/meminfo`` ``MemAvailable``, the number psutil reports as
``virtual_memory().available`` on Linux. Only the fields that the port
reads are here: the JAX package's ``jax_compilation_cache_dir``,
``use_packed_feature_cache`` (the packed cache is not ported),
``extractor_*`` batch and bucket sizes, ``weights_location`` and
``coralnet_annotations_csv_pattern`` are not, and setting them does nothing
here.
"""

from __future__ import annotations

import dataclasses
import os
import typing
from contextlib import contextmanager
from pathlib import Path

# Feature-vector geometry (production contract).
FEATURE_DIM = 4096
_BYTES_PER_FLOAT = 8
_FEATURE_BYTES = FEATURE_DIM * _BYTES_PER_FLOAT
_MIN_BATCH_SIZE = 5000


def meminfo_bytes(field: str) -> int:
    """One ``/proc/meminfo`` field (e.g. "MemAvailable") in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            name, _, rest = line.partition(":")
            if name == field:
                return int(rest.split()[0]) * 1024
    raise KeyError(f"/proc/meminfo has no {field} field")


def training_batch_size(num_classes: int = 300) -> tuple[int, float]:
    """Batch size from currently available host memory; returns
    (batch_size, available_gb) for logging. Call after data prep so the
    reading sees what the OS actually has free. The per-point cost is the
    float64 feature row, one defensive full copy, and double-width
    activation buffers for the (500, 300, 100) head plus the output layer;
    20% headroom, floor 5000."""
    available_bytes = meminfo_bytes("MemAvailable")
    activation_units = 500 + 300 + 100 + num_classes
    bytes_per_point = (
        _FEATURE_BYTES  # row loaded from disk
        + _FEATURE_BYTES  # defensive C-contiguous copy
        + 2 * activation_units * _BYTES_PER_FLOAT  # fwd+bwd activations
    )
    usable = available_bytes * 0.80
    return (
        max(int(usable / bytes_per_point), _MIN_BATCH_SIZE),
        available_bytes / 1e9,
    )


def _read_env_file(path: str | Path = ".env") -> dict[str, str]:
    """Minimal KEY=VALUE .env parser ('#' comments, optional quotes)."""
    path = Path(path)
    if not path.is_file():
        return {}
    values: dict[str, str] = {}
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        value = value.strip().strip("'\"")
        values[key.strip()] = value
    return values


def _convert(name: str, annotation: str, value: typing.Any) -> typing.Any:
    """``value`` as the field's type (pydantic's lax conversion of a string)."""
    if not isinstance(value, str):
        return value
    base = annotation.replace(" | None", "").strip()
    if base == "str":
        return value
    if base == "int":
        try:
            return int(value.strip())
        except ValueError:
            raise ValueError(f"{name}: {value!r} is not a valid integer") from None
    raise TypeError(f"{name}: unsupported settings type {annotation!r}")


@dataclasses.dataclass
class Settings:
    """All knobs. Field names lowercase here, UPPERCASE in env/.env."""

    # -- ML inputs -----------------------------------------------------------
    coralnet_train_data_bucket: str = "coral-reef-training"
    mermaid_train_data_bucket: str = "coral-reef-training"
    # Store-relative pattern; placeholders filled via .format() when present
    # (overridable so tests can point the ETL at fixture files).
    mermaid_annotations_parquet_pattern: str = (
        "{mermaid_train_data_bucket}/mermaid/mermaid_confirmed_annotations.parquet"
    )

    # -- object store ----------------------------------------------------------
    # Root for the local-filesystem object store backend. Bucket names become
    # directories under this root. None -> a store must be injected.
    object_store_root: str | None = None

    # -- taxonomy ----------------------------------------------------------------
    # Directory of taxonomy fixture JSONs for offline runs; None -> live API.
    taxonomy_fixture_dir: str | None = None

    # -- training -----------------------------------------------------------------
    training_inputs_percent_missing_allowed: int = 0
    # Override for the auto batch size; None -> training_batch_size().
    batch_size: int | None = None
    feature_cache_dir: str | None = None
    download_max_workers: int = 50
    # Data-parallel head training over an N-device mesh; None = one device.
    # Not ported: the runner raises when it is set.
    train_mesh_devices: int | None = None

    # -- tracking ------------------------------------------------------------------
    # Local experiment-tracking root directory.
    tracking_dir: str | None = None
    default_experiment_name: str | None = None
    # When set, each training run mirrors itself (and the model registry)
    # into this bucket of the default object store (tracking/store_sync.py).
    tracking_sync_bucket: str | None = None

    def __setattr__(self, name: str, value: typing.Any) -> None:
        # Assignment is validated as pydantic's validate_assignment does.
        fields = type(self).__dataclass_fields__
        if name in fields:
            value = _convert(name, str(fields[name].type), value)
        object.__setattr__(self, name, value)

    @classmethod
    def field_names(cls) -> list[str]:
        return [f.name for f in dataclasses.fields(cls)]

    @classmethod
    def from_env(cls, env_file: str | Path = ".env") -> "Settings":
        file_values = _read_env_file(env_file)
        kwargs = {}
        for name in cls.field_names():
            env_name = name.upper()
            if env_name in os.environ:
                kwargs[name] = os.environ[env_name]
            elif env_name in file_values:
                kwargs[name] = file_values[env_name]
        return cls(**kwargs)


settings = Settings.from_env()


def reload_settings_from_env(env_file: str | Path = ".env") -> Settings:
    """Re-read the environment into the EXISTING settings object, in place,
    so every module that did ``from settings import settings`` sees the
    refreshed values."""
    fresh = Settings.from_env(env_file)
    for name in Settings.field_names():
        setattr(settings, name, getattr(fresh, name))
    return settings


def apply_settings_to_env() -> None:
    """Forward settings into the env vars other layers read. Explicit call,
    never an import side effect."""
    if settings.taxonomy_fixture_dir:
        os.environ["MERMAID_TAXONOMY_FIXTURE_DIR"] = settings.taxonomy_fixture_dir


@contextmanager
def override_settings(**overrides):
    """Temporarily replace settings fields, copy/restore."""
    saved = {name: getattr(settings, name) for name in overrides}
    try:
        for name, value in overrides.items():
            setattr(settings, name, value)
        yield settings
    finally:
        for name, value in saved.items():
            setattr(settings, name, value)
