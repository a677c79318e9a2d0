"""Portable classifier artifact: the serve-time loader of the pickle-free
``model.npz`` + ``model.json`` artifact, in PyTorch.

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


class ParityError(Exception):
    """The exported artifact's scores diverge from the source model beyond
    the parity tolerance."""


class ManifestError(Exception):
    """model.json is incompatible with the params archive (schema version,
    calibration kind, class count or input_dim mismatch)."""


from mermaid_classifier_tpu_torch.inference.loader import (  # noqa: E402
    Predictor,
    load_predictor,
)

__all__ = [
    "SCHEMA_VERSION",
    "ParityError",
    "ManifestError",
    "Predictor",
    "load_predictor",
]
