"""Job orchestration: launcher configs, shard fan-out, pluggable backends.

The port's own copy of ``mermaid_classifier_tpu/jobs/``. The reference fans
extraction out as N independent SageMaker jobs with the object store as the
only shared state (reference: scripts/launch_processing.py, SURVEY.md §2.2
row 1, §5.8). This package keeps those semantics — round-robin shard
chunking, per-worker args, dry-run, poll-until-terminal, idempotent resume
through the store — behind a backend interface, with a local subprocess
backend so multi-worker runs work on one host (several workers may share
one CUDA card) and a Kubernetes backend that places GPU jobs. Standard
library only at import; PyYAML is imported when a run YAML is parsed.
"""

from mermaid_classifier_tpu_torch.jobs.backend import (  # noqa: F401
    DryRunBackend,
    JobBackend,
    JobStatus,
    LocalProcessBackend,
)
from mermaid_classifier_tpu_torch.jobs.launcher_config import (  # noqa: F401
    RunConfig,
    parse_run_config,
)
from mermaid_classifier_tpu_torch.jobs.launch import (  # noqa: F401
    build_processing_requests,
    chunk_items,
    launch_processing,
    launch_training,
    wait_for_completion,
)
