"""Post-training evaluation metrics: decorator-registered metric groups
plus a coordinator that runs them and logs to the experiment tracker.

The port of ``mermaid_classifier_tpu/metrics`` on numpy and scipy (no
sklearn, pandas or matplotlib): the framework and four of the nine groups
(``confusion_matrices``, ``precision_recall_f1``, ``balanced_accuracy_mcc``,
``probability``), with numbers and tables and no figures.
"""

from mermaid_classifier_tpu_torch.metrics.context import (  # noqa: F401
    MetricsContext,
    MetricsContextError,
)
from mermaid_classifier_tpu_torch.metrics.coordinator import (  # noqa: F401
    MetricsCoordinator,
)
from mermaid_classifier_tpu_torch.metrics.groups import (  # noqa: F401
    NOT_PORTED,
    REPORT_ORDER,
    MetricGroup,
    all_groups,
    metric_group,
    runnable_groups,
)
from mermaid_classifier_tpu_torch.metrics.outputs import (  # noqa: F401
    Artifact,
    GroupOutput,
)
