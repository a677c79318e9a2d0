"""Portable classifier artifact: the gated export and the serve-time loader
of the pickle-free ``model.npz`` + ``model.json`` artifact, in PyTorch.

Port of ``mermaid_classifier_tpu/inference``; reads the same artifacts the
JAX package writes. Modules here import only torch / numpy / stdlib.

- ``model.npz`` — numpy archive loaded with ``allow_pickle=False``:
  ``n_layers``, ``W{i}``/``b{i}`` per linear layer (W is (in, out) float32),
  and either ``cal_a``/``cal_b`` per-class Platt params or ``cal_t``, one
  temperature.
- ``model.json`` — manifest: schema_version / task / classes / input_dim /
  calibration / config / trained_with.
"""

SCHEMA_VERSION = 1
# The artifact's task name, the JAX package's: the two packages write and
# read one artifact format.
TASK_NAME = "mermaid_mlp_classifier_tpu"

# The torch major.minor on which the export parity gate was proven on the
# card. The head is plain torch, but cuBLAS kernels and their selection move
# between releases, so a torch upgrade must not pass silently: export
# refuses (TorchPinError) until parity is re-proven and this is updated.
PARITY_PROVEN_TORCH = "2.11"


class ParityError(Exception):
    """The exported artifact's scores diverge from the source model beyond
    the parity tolerance."""


class TorchPinError(Exception):
    """The installed torch differs from PARITY_PROVEN_TORCH, the version the
    export parity gate was proven on."""


class ManifestError(Exception):
    """model.json is incompatible with the params archive (schema version,
    calibration kind, class count or input_dim mismatch)."""


from mermaid_classifier_tpu_torch.inference.export import export_artifact  # noqa: E402
from mermaid_classifier_tpu_torch.inference.loader import (  # noqa: E402
    Predictor,
    load_predictor,
)

__all__ = [
    "SCHEMA_VERSION",
    "TASK_NAME",
    "PARITY_PROVEN_TORCH",
    "ParityError",
    "TorchPinError",
    "ManifestError",
    "export_artifact",
    "Predictor",
    "load_predictor",
]
