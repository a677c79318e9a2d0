"""Writing the pickle-free params archive.

Port of ``save_head_npz`` from ``mermaid_classifier_tpu/inference/export.py``.
``export_artifact`` (fit -> 1e-6 parity gate -> manifest) needs a fitted
model and comes with the training lane.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mermaid_classifier_tpu_torch.inference.head import HeadParams


def save_head_npz(path: Path, params: HeadParams) -> None:
    """Write the params archive (``allow_pickle=False``-loadable)."""
    arrays: dict[str, np.ndarray] = {
        "n_layers": np.asarray(len(params.weights), dtype=np.int64),
    }
    if params.temperature is not None:
        arrays["cal_t"] = np.asarray(params.temperature, dtype=np.float64)
    else:
        arrays["cal_a"] = params.a
        arrays["cal_b"] = params.b
    for i, (w, v) in enumerate(zip(params.weights, params.biases)):
        arrays[f"W{i}"] = w
        arrays[f"b{i}"] = v
    np.savez(path, **arrays)
