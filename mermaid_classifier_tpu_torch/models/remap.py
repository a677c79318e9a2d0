"""State-dict name remapping: external EfficientNet checkpoints -> the
canonical naming models/convert.py consumes.

The port's own copy of ``mermaid_classifier_tpu/models/remap.py``, over the
port's ``EfficientNetConfig``: the same tables, the same canonical names,
the same dropped keys and the same errors.

The reference ships pretrained torch weights (``efficientnet.pt``,
reference: release_artifact.py:35, docs/feature_extraction_at_scale.md) and
the two namings seen in the wild for EfficientNet checkpoints are:

- **torchvision** (``torchvision.models.efficientnet_b0``):
  ``features.0.0.weight`` (stem conv), ``features.{s}.{b}.block.{k}...``
  with SE as ``fc1``/``fc2``, head at ``features.8``.
- **lukemelas / EfficientNet-PyTorch** (what pyspacer-lineage checkpoints
  use): ``_conv_stem.weight``, ``_blocks.{k}._expand_conv`` / ``_bn0`` /
  ``_depthwise_conv`` / ``_bn1`` / ``_se_reduce`` / ``_se_expand`` /
  ``_project_conv`` / ``_bn2``, head ``_conv_head`` + top-level ``_bn1``.

``remap_state_dict`` detects the scheme, produces the canonical dict plus
the full old->new table (for audit) and the list of dropped keys
(classifier heads, BN bookkeeping). Unknown keys are an error — a wrong
remap must fail loudly, never convert a half-mapped network.
"""

from __future__ import annotations

from typing import Any, Mapping

from mermaid_classifier_tpu_torch.models.efficientnet import EfficientNetConfig

_BN_SUFFIXES = ("weight", "bias", "running_mean", "running_var")


class RemapError(ValueError):
    """The checkpoint naming cannot be mapped onto this architecture."""


def strip_module_prefix(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """Drop a uniform 'module.' prefix (DataParallel checkpoints)."""
    keys = list(state_dict)
    if keys and all(k.startswith("module.") for k in keys):
        return {k[len("module."):]: v for k, v in state_dict.items()}
    return dict(state_dict)


def detect_naming_scheme(keys) -> str:
    """'canonical' | 'torchvision' | 'lukemelas' from key shapes."""
    key_set = set(keys)
    if any(k.startswith("stem.conv.") for k in key_set):
        return "canonical"
    if any(k.startswith("features.0.0.") for k in key_set):
        return "torchvision"
    if any(k.startswith("_conv_stem.") for k in key_set):
        return "lukemelas"
    raise RemapError(
        "unrecognized EfficientNet state_dict naming; expected canonical"
        " ('stem.conv.weight'), torchvision ('features.0.0.weight'), or"
        " lukemelas ('_conv_stem.weight') keys. First keys:"
        f" {sorted(key_set)[:5]}"
    )


def _torchvision_table(config: EfficientNetConfig) -> tuple[dict[str, str], list[str]]:
    """old->canonical for torchvision.models.efficientnet_b* naming."""
    table: dict[str, str] = {"features.0.0.weight": "stem.conv.weight"}
    for suffix in _BN_SUFFIXES:
        table[f"features.0.1.{suffix}"] = f"stem.bn.{suffix}"

    for stage_idx, (expand, _out, repeats, _stride, _kernel) in enumerate(
        config.stages
    ):
        tv_stage = stage_idx + 1
        for block_idx in range(repeats):
            src = f"features.{tv_stage}.{block_idx}.block"
            dst = f"stage{stage_idx}_block{block_idx}"
            # Sub-block order inside torchvision's MBConv Sequential shifts
            # by one when there is no expand conv.
            parts = (
                ["expand", "depthwise", "se", "project"]
                if expand != 1
                else ["depthwise", "se", "project"]
            )
            for k, part in enumerate(parts):
                if part == "se":
                    table[f"{src}.{k}.fc1.weight"] = f"{dst}.se.reduce.weight"
                    table[f"{src}.{k}.fc1.bias"] = f"{dst}.se.reduce.bias"
                    table[f"{src}.{k}.fc2.weight"] = f"{dst}.se.expand.weight"
                    table[f"{src}.{k}.fc2.bias"] = f"{dst}.se.expand.bias"
                else:
                    table[f"{src}.{k}.0.weight"] = f"{dst}.{part}.conv.weight"
                    for suffix in _BN_SUFFIXES:
                        table[f"{src}.{k}.1.{suffix}"] = f"{dst}.{part}.bn.{suffix}"

    tv_head = len(config.stages) + 1
    table[f"features.{tv_head}.0.weight"] = "head.conv.weight"
    for suffix in _BN_SUFFIXES:
        table[f"features.{tv_head}.1.{suffix}"] = f"head.bn.{suffix}"
    # torchvision's classifier head has no role in feature extraction.
    dropped_prefixes = ["classifier."]
    return table, dropped_prefixes


def _lukemelas_table(config: EfficientNetConfig) -> tuple[dict[str, str], list[str]]:
    """old->canonical for lukemelas EfficientNet-PyTorch naming."""
    table: dict[str, str] = {"_conv_stem.weight": "stem.conv.weight"}
    for suffix in _BN_SUFFIXES:
        table[f"_bn0.{suffix}"] = f"stem.bn.{suffix}"

    flat = 0
    for stage_idx, (expand, _out, repeats, _stride, _kernel) in enumerate(
        config.stages
    ):
        for block_idx in range(repeats):
            src = f"_blocks.{flat}"
            dst = f"stage{stage_idx}_block{block_idx}"
            flat += 1
            if expand != 1:
                table[f"{src}._expand_conv.weight"] = f"{dst}.expand.conv.weight"
                for suffix in _BN_SUFFIXES:
                    table[f"{src}._bn0.{suffix}"] = f"{dst}.expand.bn.{suffix}"
            table[f"{src}._depthwise_conv.weight"] = f"{dst}.depthwise.conv.weight"
            for suffix in _BN_SUFFIXES:
                table[f"{src}._bn1.{suffix}"] = f"{dst}.depthwise.bn.{suffix}"
            table[f"{src}._se_reduce.weight"] = f"{dst}.se.reduce.weight"
            table[f"{src}._se_reduce.bias"] = f"{dst}.se.reduce.bias"
            table[f"{src}._se_expand.weight"] = f"{dst}.se.expand.weight"
            table[f"{src}._se_expand.bias"] = f"{dst}.se.expand.bias"
            table[f"{src}._project_conv.weight"] = f"{dst}.project.conv.weight"
            for suffix in _BN_SUFFIXES:
                table[f"{src}._bn2.{suffix}"] = f"{dst}.project.bn.{suffix}"

    table["_conv_head.weight"] = "head.conv.weight"
    for suffix in _BN_SUFFIXES:
        table[f"_bn1.{suffix}"] = f"head.bn.{suffix}"
    # _fc is the ImageNet classifier UNLESS its out-dim equals feature_dim,
    # in which case it is the feature projection; resolved in remap below.
    dropped_prefixes = ["_fc."]
    return table, dropped_prefixes


def remap_state_dict(
    state_dict: Mapping[str, Any],
    config: EfficientNetConfig | None = None,
    scheme: str | None = None,
) -> tuple[dict[str, Any], dict[str, str], list[str]]:
    """Remap to canonical naming.

    Returns (canonical_state_dict, applied old->new table, dropped keys).
    Raises RemapError on unknown keys so a half-mapped checkpoint can never
    slip through to conversion.
    """
    config = config or EfficientNetConfig()
    sd = strip_module_prefix(state_dict)
    scheme = scheme or detect_naming_scheme(sd)

    if scheme == "canonical":
        return dict(sd), {k: k for k in sd}, []

    if scheme == "torchvision":
        table, dropped_prefixes = _torchvision_table(config)
        projection_source = None
    elif scheme == "lukemelas":
        table, dropped_prefixes = _lukemelas_table(config)
        projection_source = "_fc"
    else:
        raise RemapError(f"unknown scheme {scheme!r}")

    out: dict[str, Any] = {}
    applied: dict[str, str] = {}
    dropped: list[str] = []
    for key, value in sd.items():
        if key in table:
            out[table[key]] = value
            applied[key] = table[key]
        elif key.endswith("num_batches_tracked"):
            dropped.append(key)
        elif (
            projection_source is not None
            and key.startswith(projection_source + ".")
            and config.feature_dim != config.head_channels
            and getattr(
                sd.get(f"{projection_source}.weight"), "shape", (None,)
            )[0]
            == config.feature_dim
        ):
            # An _fc with feature_dim outputs IS the feature projection
            # (the reference's 4096-dim contract), not a classifier.
            new = key.replace(projection_source, "feature_projection", 1)
            out[new] = value
            applied[key] = new
        elif any(key.startswith(p) for p in dropped_prefixes):
            dropped.append(key)
        else:
            raise RemapError(
                f"{scheme} checkpoint key {key!r} has no mapping for this"
                f" architecture ({len(config.stages)} stages) — refusing a"
                " partial remap."
            )
    return out, applied, dropped
