"""Experiment tracking: the local run-directory tracker and model registry,
on the on-disk layout of ``mermaid_classifier_tpu/tracking``, so either
package reads the other's runs and registered versions.
"""

from mermaid_classifier_tpu_torch.tracking.local_tracker import (  # noqa: F401
    LocalTracker,
    Run,
    get_default_tracker,
)
