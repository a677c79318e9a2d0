"""Backbone weight bundles: the pickle-free npz of a flax-layout variables
tree, with its ``EfficientNetConfig`` in a JSON sidecar.

The port's copy of the bundle I/O of ``mermaid_classifier_tpu/models/
convert.py`` (``variables_to_flat_arrays`` through ``load_backbone_bundle``),
on the port's ``EfficientNetConfig``. A bundle written by either package
loads in the other to the same arrays and config. The torch state_dict
conversion and the name remapping are not in this module.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np

from mermaid_classifier_tpu_torch.models.efficientnet import EfficientNetConfig


def variables_to_flat_arrays(variables: dict) -> dict[str, np.ndarray]:
    """Flatten a variables tree into 'collection/path/to/leaf' -> array,
    the on-disk layout of a bundle."""
    flat: dict[str, np.ndarray] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", variables)
    return flat


def flat_arrays_to_variables(flat: Mapping[str, np.ndarray]) -> dict:
    """Inverse of ``variables_to_flat_arrays``."""
    out: dict = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(arr)
    return out


def backbone_sidecar_path(npz_path: str) -> str:
    """The config sidecar written next to a bundle: ``weights.npz`` ->
    ``weights.config.json``."""
    base = npz_path[:-4] if npz_path.endswith(".npz") else npz_path
    return base + ".config.json"


def save_backbone_npz(
    path: str, variables: dict, config: EfficientNetConfig | None = None
) -> None:
    """Write backbone variables as a pickle-free npz bundle, and, when
    ``config`` is given, its ``to_dict()`` as the JSON sidecar: the padding
    and bn_eps decided at conversion time travel with the weights."""
    np.savez(path, **variables_to_flat_arrays(variables))
    if config is not None:
        with open(backbone_sidecar_path(str(path)), "w") as f:
            json.dump(config.to_dict(), f, indent=1)


def load_backbone_npz(path: str) -> dict:
    with np.load(path, allow_pickle=False) as archive:
        return flat_arrays_to_variables({k: archive[k] for k in archive.files})


def load_backbone_bundle(path: str) -> tuple[dict, EfficientNetConfig | None]:
    """``(variables, config)`` of an npz bundle; ``config`` is None when the
    bundle has no sidecar (callers fall back to their own config)."""
    variables = load_backbone_npz(path)
    sidecar = backbone_sidecar_path(str(path))
    config = None
    if os.path.isfile(sidecar):
        with open(sidecar) as f:
            config = EfficientNetConfig.from_dict(json.load(f))
    return variables, config
