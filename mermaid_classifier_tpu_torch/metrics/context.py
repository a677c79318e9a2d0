"""The evaluation context every metric group reads from.

One ``MetricsContext`` is built per evaluation run and passed to every
group; each group reads only the fields it declared in its ``needs``
(see groups.py). The required core is the validation results plus the
two taxonomy libraries; everything else is optional and gates groups out
when absent. The port's own copy of
``mermaid_classifier_tpu/metrics/context.py``.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

from mermaid_classifier_tpu_torch.data.results import ValResults

if typing.TYPE_CHECKING:
    from mermaid_classifier_tpu_torch.common.taxonomy import (
        BenthicAttributeLibrary,
        GrowthFormLibrary,
    )
    from mermaid_classifier_tpu_torch.data.dataset import TrainingDataset


class MetricsContextError(Exception):
    """An invariant of the evaluation context does not hold."""


@dataclasses.dataclass
class MetricsContext:
    """Inputs for one evaluation run.

    Core (always present):
      val_results — indices-based predictions over ``classes``
      ba_library / gf_library — taxonomy lookups for naming and tree walks

    Optional (gate groups via ``needs``):
      dataset — the TrainingDataset, for cover / per-source breakdowns
      clf — the calibrated classifier, for streaming probabilities
      val_proba / val_gt_labels — full probability matrix, precomputed once
      ba_to_top / ba_paths — taxonomy caches the coordinator fills in
    """

    val_results: ValResults
    ba_library: "BenthicAttributeLibrary"
    gf_library: "GrowthFormLibrary"
    format_func: typing.Callable[[float], float] = float
    dataset: "TrainingDataset | None" = None
    clf: typing.Any = None
    val_proba: np.ndarray | None = None
    val_gt_labels: list | None = None
    ba_to_top: dict[str, str] | None = None
    ba_paths: dict[str, list[str]] | None = None

    # -- invariants ----------------------------------------------------------

    def validate(self) -> None:
        """Check every invariant; raise MetricsContextError on the first
        violation. Run once by the coordinator before any group executes."""
        self._require_predictions()
        self._require_indices_in_range()
        self._require_resolvable_classes()
        self._require_fitted_clf()

    def _require_predictions(self) -> None:
        if not self.val_results.gt or not self.val_results.est:
            raise MetricsContextError(
                "val_results carries no ground truth / estimates — metrics"
                " would all be vacuous"
            )

    def _require_indices_in_range(self) -> None:
        n = len(self.val_results.classes)
        used = set(self.val_results.gt) | set(self.val_results.est)
        bad = sorted(i for i in used if i < 0 or i >= n)
        if bad:
            raise MetricsContextError(
                f"Class index {bad[0]} out of range for {n} classes"
            )

    def _require_resolvable_classes(self) -> None:
        for bagf_id in self.val_results.classes:
            try:
                self.ba_library.bagf_id_to_name(bagf_id, self.gf_library)
            except Exception as exc:
                raise MetricsContextError(
                    f"Class ID {bagf_id!r} not found in ba_library: {exc}"
                ) from exc

    def _require_fitted_clf(self) -> None:
        if self.clf is None:
            return
        classes = getattr(self.clf, "classes_", None)
        if classes is None or len(classes) == 0:
            raise MetricsContextError(
                "clf was supplied but is unfitted (no classes_)"
            )
