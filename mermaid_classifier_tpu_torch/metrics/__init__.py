"""Post-training evaluation metrics: decorator-registered metric groups
plus a coordinator that runs them and logs to the experiment tracker.

The port of ``mermaid_classifier_tpu/metrics`` on numpy and scipy (no
sklearn or pandas; matplotlib only inside the figures' drawing functions):
the framework and all nine groups, with their numbers, tables and figures.
"""

from mermaid_classifier_tpu_torch.metrics.context import (  # noqa: F401
    MetricsContext,
    MetricsContextError,
)
from mermaid_classifier_tpu_torch.metrics.coordinator import (  # noqa: F401
    MetricsCoordinator,
)
from mermaid_classifier_tpu_torch.metrics.groups import (  # noqa: F401
    REPORT_ORDER,
    MetricGroup,
    all_groups,
    metric_group,
    runnable_groups,
)
from mermaid_classifier_tpu_torch.metrics.outputs import (  # noqa: F401
    Artifact,
    Drawing,
    GroupOutput,
)
