"""MetricsCoordinator: run every runnable metric group and persist its
output through the experiment tracker.

The port's own copy of ``mermaid_classifier_tpu/metrics/coordinator.py``:
the same validation, shared taxonomy caches, probability precompute and
per-group exception isolation (a failing group logs a warning and the
others still run, so a missing scalar is the only sign of one); tables are
logged as CSV and mappings as JSON or YAML.

Figures are drawn here, at log time, from each group's ``Drawing``
(``Run.log_figure``). Where matplotlib does not import, every group still
logs its scalars and tables, and the run gets one param,
``figures_not_written``, naming each figure path it could not draw (comma
separated, in log order). No figure is skipped silently."""

from __future__ import annotations

import logging
import time

import numpy as np

from mermaid_classifier_tpu_torch.common.plots import matplotlib_importable
from mermaid_classifier_tpu_torch.metrics.context import (
    MetricsContext,
    MetricsContextError,
)
from mermaid_classifier_tpu_torch.metrics.groups import runnable_groups
from mermaid_classifier_tpu_torch.metrics.outputs import (
    FIGURE,
    MAPPING,
    TABLE,
    GroupOutput,
)
from mermaid_classifier_tpu_torch.metrics.taxonomy_index import (
    build_ba_paths,
    build_ba_to_top,
)
from mermaid_classifier_tpu_torch.tracking.local_tracker import Run

logger = logging.getLogger(__name__)

FIGURES_NOT_WRITTEN = "figures_not_written"


class MetricsCoordinator:
    """Validates the context, pre-computes shared inputs, runs every
    runnable group with per-group exception isolation, and logs outputs."""

    def __init__(self, ctx: MetricsContext, run: Run):
        self.ctx = ctx
        self.run = run
        # Per-group wall seconds from the last compute_and_log_all —
        # persisted as metrics_group_seconds.json so a slow metrics block
        # in a full-scale drive decomposes inside the tracked run (the
        # same self-explanation discipline as resident/* and
        # profiled_sections).
        self.group_seconds: dict[str, float] = {}
        # Figure paths of the last compute_and_log_all that matplotlib was
        # not there to draw.
        self.figures_not_written: list[str] = []
        self._can_draw = True

    def compute_and_log_all(self) -> None:
        try:
            self.ctx.validate()
        except MetricsContextError:
            logger.warning(
                "Metrics skipped: context validation failed", exc_info=True
            )
            return

        classes = list(self.ctx.val_results.classes)
        self.ctx.ba_to_top = build_ba_to_top(classes, self.ctx.ba_library)
        self.ctx.ba_paths = build_ba_paths(classes, self.ctx.ba_library)

        # Honor a caller-precomputed matrix (the runner's resident-gather
        # fast path); stream from disk only when nobody provided one.
        if (
            self.ctx.clf is not None
            and self.ctx.dataset is not None
            and self.ctx.val_proba is None
        ):
            self._precompute_probabilities()

        self.group_seconds = {}
        self.figures_not_written = []
        self._can_draw = matplotlib_importable()
        if not self._can_draw:
            logger.warning(
                "matplotlib does not import: metric figures are not drawn and"
                " are named in the %r param", FIGURES_NOT_WRITTEN
            )
        for group in runnable_groups(self.ctx):
            t0 = time.perf_counter()
            try:
                self._log_output(group.compute(self.ctx))
            except Exception:
                logger.warning("Metric group %r failed", group.name, exc_info=True)
            finally:
                elapsed = round(time.perf_counter() - t0, 3)
                self.group_seconds[group.name] = elapsed
                logger.debug("metric group %r: %.3fs", group.name, elapsed)
        if self.figures_not_written:
            self.run.log_param(
                FIGURES_NOT_WRITTEN, ", ".join(self.figures_not_written)
            )
        if self.group_seconds:
            # Same isolation as every other tracker write here: a timing
            # artifact must never abort a metrics stage that already
            # computed its groups.
            try:
                self.run.log_dict(
                    self.group_seconds, "metrics_group_seconds.json"
                )
            except Exception:
                logger.warning(
                    "Failed to log metrics_group_seconds", exc_info=True
                )

    def _precompute_probabilities(self) -> None:
        """Stream the val set through the classifier ONCE and share the
        probability matrix across groups. Failure just gates out the groups
        that need it."""
        try:
            assert self.ctx.dataset is not None
            all_proba = []
            all_gt: list = []
            for x, y in self.ctx.dataset.labels.val.load_data_in_batches(
                batch_size=5000
            ):
                all_proba.append(self.ctx.clf.predict_proba(x))
                all_gt.extend(y)
            self.ctx.val_proba = np.vstack(all_proba)
            self.ctx.val_gt_labels = all_gt
        except Exception:
            logger.warning(
                "Failed to pre-compute probability matrix; probability and"
                " ranking metrics will be skipped",
                exc_info=True,
            )

    def _log_output(self, out: GroupOutput) -> None:
        for name, value in out.scalars.items():
            # Run.log_metric skips NaN/Inf with a warning.
            self.run.log_metric(name, value)
        for artifact in out.artifacts:
            if artifact.kind == TABLE:
                path = artifact.path
                if not path.endswith(".csv"):
                    path += ".csv"
                self.run.log_dataframe(artifact.payload, path)
            elif artifact.kind == MAPPING:
                self.run.log_dict(artifact.payload, artifact.path)
            elif artifact.kind == FIGURE:
                if not self._can_draw:
                    self.figures_not_written.append(artifact.path)
                    continue
                self.run.log_figure(
                    artifact.payload.render(),
                    artifact.path,
                    **(artifact.save_kwargs or {}),
                )
            else:
                logger.warning(
                    "Unknown artifact kind %r at %r; skipped",
                    artifact.kind,
                    artifact.path,
                )
