"""Metric-group registration and gating.

A metric module declares itself at definition site::

    @metric_group("cover", needs=("dataset",))
    def compute_cover(ctx: MetricsContext) -> GroupOutput: ...

``needs`` names MetricsContext fields that must be non-None for the group
to run; the coordinator asks :func:`runnable_groups` for the ordered
subset whose prerequisites are satisfied. Report ordering is pinned by
``REPORT_ORDER`` (the nine groups of the JAX package, in its order), not by
import order; groups registered beyond that list append after it in
registration order.

The port's own copy of ``mermaid_classifier_tpu/metrics/groups.py``, with
the same nine groups.
"""

from __future__ import annotations

import dataclasses
import typing

from mermaid_classifier_tpu_torch.metrics.context import MetricsContext
from mermaid_classifier_tpu_torch.metrics.outputs import GroupOutput

GroupFunc = typing.Callable[[MetricsContext], GroupOutput]


@dataclasses.dataclass(frozen=True)
class MetricGroup:
    name: str
    compute: GroupFunc
    needs: tuple[str, ...]

    def runnable(self, ctx: MetricsContext) -> bool:
        return all(getattr(ctx, field) is not None for field in self.needs)


_REGISTERED: dict[str, MetricGroup] = {}

# The report contract: sections appear in this sequence.
REPORT_ORDER = (
    "confusion_matrices",
    "precision_recall_f1",
    "balanced_accuracy_mcc",
    "taxonomic",
    "calibration",
    "cover",
    "per_source",
    "probability",
    "ranking",
)



def metric_group(name: str, needs: tuple[str, ...] = ()) -> typing.Callable:
    """Register ``fn`` as the metric group ``name``. ``needs`` lists the
    MetricsContext fields the group cannot run without."""

    def decorate(fn: GroupFunc) -> GroupFunc:
        if name in _REGISTERED:
            raise ValueError(f"metric group {name!r} is registered twice")
        unknown = [
            f for f in needs if f not in MetricsContext.__dataclass_fields__
        ]
        if unknown:
            raise ValueError(
                f"metric group {name!r} declares unknown context fields"
                f" {unknown}"
            )
        _REGISTERED[name] = MetricGroup(name=name, compute=fn, needs=tuple(needs))
        return fn

    return decorate


def _load_group_modules() -> None:
    # Registration is a definition-site side effect, so the group modules
    # must be imported before the registry is read. Done lazily here (not
    # at module top) because those modules import the decorator from us.
    from mermaid_classifier_tpu_torch.metrics import (  # noqa: F401
        calibration,
        classification,
        cover,
        per_source,
        probability,
        ranking,
        taxonomic,
    )


def all_groups() -> tuple[MetricGroup, ...]:
    """Every registered group, in report order (extras after, in
    registration order)."""
    _load_group_modules()
    missing = [n for n in REPORT_ORDER if n not in _REGISTERED]
    if missing:
        raise RuntimeError(
            f"REPORT_ORDER names unregistered metric groups: {missing}"
        )
    ordered = [_REGISTERED[n] for n in REPORT_ORDER]
    ordered += [g for n, g in _REGISTERED.items() if n not in REPORT_ORDER]
    return tuple(ordered)


def runnable_groups(ctx: MetricsContext) -> tuple[MetricGroup, ...]:
    """The ordered subset of groups whose ``needs`` the context satisfies."""
    return tuple(g for g in all_groups() if g.runnable(ctx))
