"""export_artifact: serialize the calibrated head to a pickle-free npz,
parity-gate it against the source model, and write the manifest.

Port of ``mermaid_classifier_tpu/inference/export.py``. The artifact is the
one the JAX package writes, so either package's loader reads it; the
provenance pin tracks torch, which computes the shipped numbers here.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from mermaid_classifier_tpu_torch.inference import (
    PARITY_PROVEN_TORCH,
    SCHEMA_VERSION,
    TASK_NAME,
    ParityError,
    TorchPinError,
)
from mermaid_classifier_tpu_torch.inference.head import HeadParams, make_head_fn


def _head_params_from_model(model: Any) -> HeadParams:
    """Extract MLP weights + per-class Platt params (or the temperature)
    from a fitted calibrated classifier.

    The model exposes ``classes_``, an ``estimator`` with ``coefs_`` /
    ``intercepts_`` (coefs_[i] is (in, out)), and ``calibration_a_`` /
    ``calibration_b_`` in classes_ order, or ``temperature_``. Only the
    multiclass (K > 2) path is supported.
    """
    estimator = getattr(model, "estimator", None)
    if estimator is None:
        raise ValueError("model has no .estimator; expected a fitted CalibratedClassifier.")
    n_classes = len(model.classes_)
    if n_classes <= 2:
        raise ValueError(
            f"export only supports the multiclass (K > 2) path; got K={n_classes}."
        )
    est_classes = np.asarray(estimator.classes_)
    if not np.array_equal(est_classes, np.asarray(model.classes_)):
        raise ValueError(
            "estimator.classes_ does not match model.classes_; calibrator"
            " column alignment is only valid when they are identical."
        )
    weights = [np.asarray(w, dtype=np.float32) for w in estimator.coefs_]
    biases = [np.asarray(v, dtype=np.float32) for v in estimator.intercepts_]
    temperature = getattr(model, "temperature_", None)
    if temperature is not None:
        return HeadParams(weights, biases, temperature=float(temperature))
    a = np.asarray(model.calibration_a_, dtype=np.float32)
    b = np.asarray(model.calibration_b_, dtype=np.float32)
    if a.shape != (n_classes,) or b.shape != (n_classes,):
        raise ValueError(
            f"Expected {n_classes} per-class calibrators, got a.shape={a.shape},"
            f" b.shape={b.shape}."
        )
    return HeadParams(weights, biases, a, b)


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


def export_artifact(
    model: Any,
    output_dir: str | Path,
    reference_features: Any,
    *,
    config: dict[str, Any] | None = None,
    task: str = TASK_NAME,
    tol: float = 1e-6,
    enforce_torch_pin: bool = True,
) -> tuple[Path, dict[str, Any], float]:
    """Turn a fitted calibrated classifier into the on-disk serving artifact.

    Writes model.npz (params archive) + model.json (manifest) under
    ``output_dir`` and returns (model_npz_path, manifest_dict, max_abs_diff).
    Two gates stand between a fitted model and a shipped artifact: the torch
    version pin (TorchPinError when the installed major.minor is not
    PARITY_PROVEN_TORCH and enforce_torch_pin is True), and the numerical
    gate (ParityError when the serialized head and ``model.predict_proba``
    disagree by more than ``tol`` anywhere on the supplied feature batch).

    The head runs on the estimator's device. The batch is uploaded once and
    both forwards run the same torch ops on the whole of it, so the only
    intended gap is the model's float64 calibration on the host against the
    head's float32 one.
    """
    torch_mm = ".".join(torch.__version__.split(".")[:2])
    if enforce_torch_pin and torch_mm != PARITY_PROVEN_TORCH:
        raise TorchPinError(
            f"installed torch is {torch.__version__} (major.minor {torch_mm});"
            f" parity has only been proven on {PARITY_PROVEN_TORCH}. A torch"
            " upgrade can move the head's numerics, so exporting is blocked"
            " until parity is re-proven on the card and PARITY_PROVEN_TORCH"
            " is bumped."
        )

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    params = _head_params_from_model(model)
    device = torch.device(model.estimator.device)
    head_fn = make_head_fn(params, device)

    ref = torch.as_tensor(np.asarray(reference_features, dtype=np.float32)).to(device)
    expected = np.asarray(model.predict_proba(ref), dtype=np.float64)
    got = head_fn(ref)
    max_diff = float(np.max(np.abs(expected - got)))
    if max_diff > tol:
        raise ParityError(
            f"serialized head diverges from the source model by"
            f" max|Δ|={max_diff:.3e} (> tol {tol:.3e}) on the reference"
            " batch; artifact not written."
        )

    manifest = {
        "schema_version": SCHEMA_VERSION,
        "task": task,
        "classes": [str(c) for c in np.asarray(model.classes_).tolist()],
        "input_dim": params.input_dim,
        "calibration": params.calibration,
        "config": config if config is not None else {"patch_size": 224},
        "trained_with": {"torch": torch.__version__, "numpy": np.__version__},
    }

    model_npz = output_dir / "model.npz"
    save_head_npz(model_npz, params)
    (output_dir / "model.json").write_text(json.dumps(manifest, indent=2))

    return model_npz, manifest, max_diff
