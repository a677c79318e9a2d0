"""Backbone weights: a torch EfficientNet state_dict -> the flax-layout
variables tree, and the pickle-free npz bundle of that tree with its
``EfficientNetConfig`` in a JSON sidecar.

The port's own copy of ``mermaid_classifier_tpu/models/convert.py``, on the
port's ``EfficientNetConfig``. ``torch_state_dict_to_variables`` takes a
state_dict in the canonical naming (``models/remap.py`` maps torchvision and
lukemelas checkpoints onto it):

  stem.conv.weight, stem.bn.{weight,bias,running_mean,running_var}
  stage{i}_block{j}.expand.conv.weight, ...expand.bn.*        (when expand!=1)
  stage{i}_block{j}.depthwise.conv.weight, ...depthwise.bn.*
  stage{i}_block{j}.se.reduce.{weight,bias}
  stage{i}_block{j}.se.expand.{weight,bias}
  stage{i}_block{j}.project.conv.weight, ...project.bn.*
  head.conv.weight, head.bn.*
  feature_projection.{weight,bias}                            (when feature_dim!=head_channels)

and returns the numpy tree ``{"params", "batch_stats"}`` that the bundles
hold and ``load_jax_variables`` and ``fold_backbone`` read: conv weights
(out, in/groups, kh, kw) -> (kh, kw, in/groups, out), linear (out, in) ->
(in, out), BN weight/bias -> scale/bias and running stats -> mean/var.
Values are torch tensors (a tensor on the card is copied to the host) or
anything numpy reads. A bundle written by either package loads in the other
to the same arrays and config.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np
import torch

from mermaid_classifier_tpu_torch.models.efficientnet import EfficientNetConfig


class WeightConversionError(ValueError):
    """The state_dict is missing keys, or its shapes disagree with the
    target architecture: conversion fails loudly, never skips a layer."""


def _to_numpy(t: Any) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.asarray(t, dtype=np.float32)


class _Taker:
    """Hands out state_dict entries by key, checking shapes, and remembers
    which keys were taken."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd = dict(sd)
        self.used: set[str] = set()

    def take(self, key: str, expect_shape: tuple[int, ...] | None = None) -> np.ndarray:
        if key not in self.sd:
            raise WeightConversionError(f"state_dict is missing key {key!r}.")
        self.used.add(key)
        arr = _to_numpy(self.sd[key])
        if expect_shape is not None and tuple(arr.shape) != tuple(expect_shape):
            raise WeightConversionError(
                f"{key!r} has shape {tuple(arr.shape)}, expected {expect_shape}."
            )
        return arr

    def unused(self) -> list[str]:
        return sorted(set(self.sd) - self.used)


def _conv_kernel(taker: _Taker, key: str) -> np.ndarray:
    w = taker.take(key)
    if w.ndim != 4:
        raise WeightConversionError(f"{key!r} is not a 4-D conv weight.")
    return np.transpose(w, (2, 3, 1, 0))


def _conv_bn(taker: _Taker, prefix: str) -> tuple[dict, dict]:
    params = {
        "conv": {"kernel": _conv_kernel(taker, f"{prefix}.conv.weight")},
        "bn": {
            "scale": taker.take(f"{prefix}.bn.weight"),
            "bias": taker.take(f"{prefix}.bn.bias"),
        },
    }
    stats = {
        "bn": {
            "mean": taker.take(f"{prefix}.bn.running_mean"),
            "var": taker.take(f"{prefix}.bn.running_var"),
        }
    }
    return params, stats


def torch_state_dict_to_variables(
    state_dict: Mapping[str, Any],
    config: EfficientNetConfig | None = None,
    *,
    strict: bool = True,
) -> dict:
    """Convert a canonical-named state_dict into the variables tree
    ``{"params": ..., "batch_stats": ...}`` of ``config``'s backbone. With
    ``strict`` every key must be consumed (``num_batches_tracked`` aside)."""
    config = config or EfficientNetConfig()
    taker = _Taker(state_dict)
    params: dict = {}
    stats: dict = {}

    params["stem"], stats["stem"] = _conv_bn(taker, "stem")

    for stage_idx, (expand, _out_ch, repeats, _stride, _kernel) in enumerate(
        config.stages
    ):
        for block_idx in range(repeats):
            name = f"stage{stage_idx}_block{block_idx}"
            block_p: dict = {}
            block_s: dict = {}
            if expand != 1:
                block_p["expand"], block_s["expand"] = _conv_bn(taker, f"{name}.expand")
            block_p["depthwise"], block_s["depthwise"] = _conv_bn(
                taker, f"{name}.depthwise"
            )
            block_p["se"] = {
                "reduce": {
                    "kernel": _conv_kernel(taker, f"{name}.se.reduce.weight"),
                    "bias": taker.take(f"{name}.se.reduce.bias"),
                },
                "expand": {
                    "kernel": _conv_kernel(taker, f"{name}.se.expand.weight"),
                    "bias": taker.take(f"{name}.se.expand.bias"),
                },
            }
            block_p["project"], block_s["project"] = _conv_bn(taker, f"{name}.project")
            params[name] = block_p
            stats[name] = block_s

    params["head"], stats["head"] = _conv_bn(taker, "head")

    if config.feature_dim != config.head_channels:
        w = taker.take("feature_projection.weight")
        if w.shape != (config.feature_dim, config.head_channels):
            raise WeightConversionError(
                f"feature_projection.weight has shape {w.shape}, expected"
                f" {(config.feature_dim, config.head_channels)}."
            )
        params["feature_projection"] = {
            "kernel": np.transpose(w, (1, 0)),
            "bias": taker.take(
                "feature_projection.bias", (config.feature_dim,)
            ),
        }

    if strict:
        # num_batches_tracked is torch BN bookkeeping with no flax analog.
        leftover = [k for k in taker.unused()
                    if not k.endswith("num_batches_tracked")]
        if leftover:
            raise WeightConversionError(
                f"state_dict has {len(leftover)} unconsumed keys, e.g."
                f" {leftover[:5]} — name mapping is incomplete."
            )

    return {"params": params, "batch_stats": stats}


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
