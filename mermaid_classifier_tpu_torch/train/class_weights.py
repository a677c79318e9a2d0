"""Effective-number-of-samples class weighting (Cui et al. 2019).

The port's own copy of ``mermaid_classifier_tpu/train/class_weights.py``:

    E_n = (1 - beta^n) / (1 - beta),   w(class) ~ 1 / E_n(count)

with beta = 0.9999 and an optional max:min weight-ratio cap. Labels are
opaque BA+GF combo strings; the taxonomy plays no role here.
"""

from __future__ import annotations

import dataclasses

BETA: float = 0.9999


@dataclasses.dataclass
class SampleWeightingOptions:
    """Validated weighting configuration
    (reference: sample_weighting/options.py:8-40)."""

    enabled: bool = False
    weight_ratio_cap: float | None = None

    def __post_init__(self) -> None:
        if self.weight_ratio_cap is not None and self.weight_ratio_cap < 1.0:
            raise ValueError(
                f"weight_ratio_cap must be >= 1.0 or None, got"
                f" {self.weight_ratio_cap!r}"
            )

    def to_log_dict(self) -> dict[str, object]:
        return {
            "sample_weighting/enabled": self.enabled,
            "sample_weighting/strategy": "effective_number" if self.enabled else None,
            "sample_weighting/weight_ratio_cap": self.weight_ratio_cap,
        }


def compute_class_weights(
    class_counts: dict[str, int],
    options: SampleWeightingOptions,
) -> dict[str, float]:
    """Per-class loss weights; {} when disabled or no counts.

    Weights are strictly positive; with ``weight_ratio_cap`` set, weights
    above ``min_weight * cap`` are clamped to that ceiling
    (reference: effective_number.py:38-75).
    """
    if not options.enabled or not class_counts:
        return {}

    weights: dict[str, float] = {}
    for label, count in class_counts.items():
        n = max(int(count), 1)
        effective_n = (1.0 - BETA**n) / (1.0 - BETA)
        weights[label] = 1.0 / max(effective_n, 1e-12)

    for label, weight in weights.items():
        if weight <= 0:
            raise RuntimeError(
                f"Non-positive weight {weight!r} computed for class {label!r}."
            )

    cap = options.weight_ratio_cap
    if cap is not None and len(weights) >= 2:
        ceiling = min(weights.values()) * cap
        for label, weight in weights.items():
            if weight > ceiling:
                weights[label] = ceiling

    return weights
