"""Per-class subsampling: registry-dispatched pure allocators.

The port's own copy of ``mermaid_classifier_tpu/data/subsample.py``:

- ``stratified``: proportional to class frequency, capped at availability
  (never oversamples), floored at ``min_per_class``; rounding overshoot is
  trimmed from the largest classes deterministically, never below the floor;
  undershoot is accepted.
- ``balanced``: equal per-class budget ``total // n_classes``, capped at
  availability, floored at ``min_per_class``.

Allocators are pure count->target functions and carry no random state —
determinism lives in the apply step (ordered ROW_NUMBER partition over the
annotation primary key; see data/dataset.py), exactly the discipline the
reference adopted after its nondeterministic-LIMIT bug
(reference: options.py:110-115, dataset.py:287-310).

Class keys are (benthic_attribute_id, growth_form_id) string tuples.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

ClassKey = tuple[str, str]
ClassCounts = dict[ClassKey, int]
ClassTargets = dict[ClassKey, int]

SUBSAMPLE_STRATEGIES: tuple[str, ...] = ("stratified", "balanced")


@dataclasses.dataclass
class SubsampleOptions:
    """Validated subsample configuration (eager checks at construction;
    reference: subsample/options.py:43-103)."""

    strategy: str = "stratified"
    total_annotations: int | None = None
    min_per_class: int = 0

    def __post_init__(self) -> None:
        if self.strategy not in SUBSAMPLE_STRATEGIES:
            raise ValueError(
                f"strategy must be one of {SUBSAMPLE_STRATEGIES}, got {self.strategy!r}"
            )
        if self.total_annotations is not None and self.total_annotations <= 0:
            raise ValueError(
                f"total_annotations must be > 0 or None, got {self.total_annotations!r}"
            )
        if self.min_per_class < 0:
            raise ValueError(f"min_per_class must be >= 0, got {self.min_per_class!r}")
        if self.total_annotations is None:
            raise ValueError(
                f"strategy={self.strategy!r} requires total_annotations"
            )

    def to_log_dict(self) -> dict[str, object]:
        return {
            "subsample/enabled": True,
            "subsample/strategy": self.strategy,
            "subsample/total_annotations": self.total_annotations,
            "subsample/min_per_class": self.min_per_class,
        }


Allocator = Callable[[SubsampleOptions, ClassCounts], ClassTargets]


def _allocate_stratified(
    options: SubsampleOptions, class_counts: ClassCounts
) -> ClassTargets:
    budget = options.total_annotations
    assert budget is not None
    grand_total = sum(class_counts.values())
    if grand_total == 0:
        return dict.fromkeys(class_counts, 0)

    floor = options.min_per_class
    targets = {
        cls: max(floor, min(n, round(budget * n / grand_total)))
        for cls, n in class_counts.items()
    }

    # Trim rounding overshoot from the largest classes, deterministically
    # (count desc, then key), never below the floor. Residual overshoot is
    # accepted when every class is at its floor; undershoot is never grown.
    overshoot = sum(targets.values()) - budget
    if overshoot > 0:
        for cls in sorted(targets, key=lambda c: (-class_counts[c], c)):
            if overshoot <= 0:
                break
            cut = min(max(0, targets[cls] - floor), overshoot)
            targets[cls] -= cut
            overshoot -= cut
    return targets


def _allocate_balanced(
    options: SubsampleOptions, class_counts: ClassCounts
) -> ClassTargets:
    budget = options.total_annotations
    assert budget is not None
    n_classes = len(class_counts)
    per_class = budget // n_classes if n_classes else 0
    return {
        cls: max(options.min_per_class, min(n, per_class))
        for cls, n in class_counts.items()
    }


_ALLOCATORS: dict[str, Allocator] = {
    "stratified": _allocate_stratified,
    "balanced": _allocate_balanced,
}


def compute_per_class_targets(
    options: SubsampleOptions, class_counts: ClassCounts
) -> ClassTargets:
    """Dispatch to the registered allocator; the caller applies the targets
    with a deterministic ordered ROW_NUMBER selection."""
    if not class_counts:
        return {}
    if options.strategy not in _ALLOCATORS:
        raise ValueError(
            f"No allocator registered for strategy {options.strategy!r}."
            f" Registered: {sorted(_ALLOCATORS)!r}."
        )
    return _ALLOCATORS[options.strategy](options, class_counts)
