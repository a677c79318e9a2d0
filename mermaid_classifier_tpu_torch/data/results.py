"""Typed result containers for training runs: the port's own copy of
``mermaid_classifier_tpu/data/results.py`` (``ValResults`` and
``TrainClassifierReturnMsg``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class ValResults:
    """Validation-set results: per-point scores plus gt/est class indices
    into ``classes``."""

    scores: list[float]
    gt: list[int]
    est: list[int]
    classes: list[Any]

    def __post_init__(self) -> None:
        if not (len(self.scores) == len(self.gt) == len(self.est)):
            raise ValueError(
                f"scores/gt/est must be the same length; got"
                f" {len(self.scores)}/{len(self.gt)}/{len(self.est)}."
            )
        n_classes = len(self.classes)
        for name, idx_list in (("gt", self.gt), ("est", self.est)):
            for i in idx_list:
                if not (0 <= i < n_classes):
                    raise ValueError(
                        f"{name} contains index {i} outside [0, {n_classes})."
                    )

    def to_dict(self) -> dict[str, Any]:
        return {
            "scores": self.scores,
            "gt": self.gt,
            "est": self.est,
            "classes": list(self.classes),
        }


@dataclass
class TrainClassifierReturnMsg:
    """Summary of a training run (reference analog: pyspacer
    TrainClassifierReturnMsg, trainer.py:286-291)."""

    acc: float
    pc_accs: list[float]
    ref_accs: list[float]
    runtime: float
    extra: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "acc": self.acc,
            "pc_accs": self.pc_accs,
            "ref_accs": self.ref_accs,
            "runtime": self.runtime,
            **self.extra,
        }
