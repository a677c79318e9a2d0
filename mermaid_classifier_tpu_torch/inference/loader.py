"""Serve-time loading of the shipped artifact.

Port of ``mermaid_classifier_tpu/inference/loader.py``. ``load_predictor``
reads model.npz and model.json, cross-checks them and probes the assembled
head on the given device before returning: schema version, calibration
kind, input_dim, a one-row zero probe, and the class count. Any violation
raises ManifestError before a Predictor exists.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from mermaid_classifier_tpu_torch.inference import SCHEMA_VERSION, ManifestError
from mermaid_classifier_tpu_torch.inference.head import HeadParams, make_head_fn


class Predictor:
    """The loaded serving head: feature rows in, calibrated per-class
    probabilities (float64 numpy) out."""

    def __init__(
        self,
        head_fn: Any,
        classes: list[str],
        input_dim: int,
        head_params: HeadParams | None = None,
    ) -> None:
        self._head_fn = head_fn
        self.classes = classes
        self.input_dim = input_dim
        self.head_params = head_params

    @property
    def classes_(self) -> list[str]:
        return self.classes

    def predict_proba(self, features: Any) -> np.ndarray:
        """(N, input_dim) features — a numpy array or a tensor on any
        device — -> (N, K) float64 probabilities."""
        shape = tuple(features.shape)
        if len(shape) != 2 or shape[1] != self.input_dim:
            raise ValueError(
                f"features must be a 2-D batch of width {self.input_dim};"
                f" got shape {shape}."
            )
        return self._head_fn(features)


def _load_head_params(model_npz_path: str | Path) -> HeadParams:
    with np.load(model_npz_path, allow_pickle=False) as archive:
        try:
            n_layers = int(archive["n_layers"])
            weights = [archive[f"W{i}"] for i in range(n_layers)]
            biases = [archive[f"b{i}"] for i in range(n_layers)]
            if "cal_t" in archive:
                temperature = float(archive["cal_t"])
                a = b = None
            else:
                temperature = None
                a = archive["cal_a"]
                b = archive["cal_b"]
        except KeyError as exc:
            raise ManifestError(f"model.npz is missing required array: {exc}") from exc
    try:
        return HeadParams(weights, biases, a, b, temperature=temperature)
    except ValueError as exc:
        raise ManifestError(f"model.npz contains inconsistent params: {exc}") from exc


def load_predictor(
    model_npz_path: str | Path,
    model_json_path: str | Path | None = None,
    *,
    device,
) -> Predictor:
    """Assemble a Predictor on ``device`` from model.npz + model.json (or
    one artifact directory holding both), gating hard on any inconsistency
    between the two."""
    if model_json_path is None:
        artifact_dir = Path(model_npz_path)
        if not artifact_dir.is_dir():
            raise ManifestError(
                f"load_predictor got a single argument {artifact_dir} that is"
                " not an artifact directory; pass (model.npz, model.json)"
                " paths or a directory containing both."
            )
        return load_predictor(
            artifact_dir / "model.npz", artifact_dir / "model.json",
            device=device,
        )
    device = torch.device(device)
    manifest = json.loads(Path(model_json_path).read_text())

    schema_version = manifest.get("schema_version")
    if schema_version != SCHEMA_VERSION:
        raise ManifestError(
            f"model.json declares schema_version={schema_version!r}; this"
            f" loader reads version {SCHEMA_VERSION} artifacts only."
        )

    classes = manifest["classes"]
    input_dim = int(manifest["input_dim"])
    params = _load_head_params(model_npz_path)

    declared_cal = manifest.get("calibration", "sigmoid")
    if declared_cal != params.calibration:
        raise ManifestError(
            f"model.json declares calibration={declared_cal!r} but model.npz"
            f" carries {params.calibration!r} parameters."
        )

    if params.input_dim != input_dim:
        raise ManifestError(
            f"params expect input_dim={params.input_dim} but model.json"
            f" declares {input_dim}."
        )
    head_fn = make_head_fn(params, device)
    try:
        probe = head_fn(np.zeros((1, input_dim), dtype=np.float32))
    except RuntimeError as exc:
        raise ManifestError(
            f"head cannot evaluate the input_dim={input_dim} probe batch"
            f" from model.json: {exc}"
        ) from exc

    if probe.shape[1] != len(classes):
        raise ManifestError(
            f"class-count mismatch: the head emits {probe.shape[1]}"
            f" probabilities per row, the manifest lists {len(classes)}"
            f" classes."
        )

    return Predictor(head_fn, list(classes), input_dim, head_params=params)
