"""Calibrated head: the calibrated predict_proba pipeline in float32 torch.

Port of ``mermaid_classifier_tpu/inference/head.py`` (multiclass, K > 2):

  logits = MLP(features)                    # Linear -> ReLU -> ... -> Linear
  p      = softmax(logits)
  sigmoid calibration:
    c_k   = sigmoid(-(a_k * p_k + b_k))     # per-class Platt sigmoid
    proba = c / c.sum(axis=1)               # uniform where the sum is 0
    proba = where(1 < proba <= 1+1e-5, 1.0) # overshoot clip
  temperature calibration:
    proba = softmax(log(p) * (1/T))         # via the log-probabilities

The matmuls are full float32 (``torch.matmul`` with TF32 off), matching the
JAX head's ``Precision.HIGHEST``.
"""

from __future__ import annotations

import numpy as np
import torch

_OVERSHOOT_EPS = 1e-5


class HeadParams:
    """Validated parameter bundle for the calibrated head.

    weights[i] is (in_dim, out_dim) float32 (x @ W + b). Calibration is
    per-class Platt (a, b), each (K,), or keyword-only ``temperature=T``.
    """

    def __init__(
        self,
        weights: list[np.ndarray],
        biases: list[np.ndarray],
        a: np.ndarray | None = None,
        b: np.ndarray | None = None,
        *,
        temperature: float | None = None,
    ) -> None:
        if temperature is not None:
            if a is not None or b is not None:
                raise ValueError(
                    "Pass either per-class (a, b) Platt parameters or a"
                    " scalar temperature, not both."
                )
            temperature = float(temperature)
            if not np.isfinite(temperature) or temperature <= 0.0:
                raise ValueError(
                    f"temperature must be a positive finite float, got"
                    f" {temperature!r}."
                )
        else:
            if a is None or b is None:
                raise ValueError(
                    "Calibration is required: pass (a, b) Platt parameters"
                    " or temperature=T."
                )
            a = np.asarray(a, dtype=np.float32)
            b = np.asarray(b, dtype=np.float32)
            if a.ndim != 1 or b.ndim != 1:
                raise ValueError(
                    f"Calibration parameters a and b must be 1-D arrays; got"
                    f" a.shape={a.shape}, b.shape={b.shape}."
                )
            if a.shape != b.shape:
                raise ValueError(
                    f"Calibration parameters a and b must have the same shape; got"
                    f" a.shape={a.shape}, b.shape={b.shape}."
                )
        if len(weights) != len(biases):
            raise ValueError(
                f"weights and biases must have the same length; got"
                f" {len(weights)} weights and {len(biases)} biases."
            )
        if len(weights) == 0:
            raise ValueError("weights must contain at least one layer.")
        self.weights = [np.asarray(w, dtype=np.float32) for w in weights]
        self.biases = [np.asarray(v, dtype=np.float32) for v in biases]
        for i, (w, v) in enumerate(zip(self.weights, self.biases)):
            if w.ndim != 2:
                raise ValueError(f"weights[{i}] must be 2-D, got shape {w.shape}.")
            if v.ndim != 1 or v.shape[0] != w.shape[1]:
                raise ValueError(
                    f"biases[{i}] shape {v.shape} does not match weights[{i}]"
                    f" output dim {w.shape[1]}."
                )
            if i > 0 and w.shape[0] != self.weights[i - 1].shape[1]:
                raise ValueError(
                    f"weights[{i}] input dim {w.shape[0]} does not chain from"
                    f" weights[{i - 1}] output dim {self.weights[i - 1].shape[1]}."
                )
        if a is not None and self.weights[-1].shape[1] != a.shape[0]:
            raise ValueError(
                f"final layer outputs {self.weights[-1].shape[1]} classes but"
                f" calibration has {a.shape[0]} entries."
            )
        self.a = a
        self.b = b
        self.temperature = temperature
        self.n_classes = int(self.weights[-1].shape[1])
        self.input_dim = int(self.weights[0].shape[0])

    @property
    def calibration(self) -> str:
        return "temperature" if self.temperature is not None else "sigmoid"

    def as_tensors(self, device) -> dict:
        """The parameters as float32 tensors on ``device``."""

        def t(arr):
            return torch.as_tensor(arr, dtype=torch.float32, device=device)

        tree = {
            "weights": [t(w) for w in self.weights],
            "biases": [t(v) for v in self.biases],
        }
        if self.temperature is not None:
            # The inverse as the JAX head ships it: f64 division, f32 cast.
            tree["inv_t"] = t(np.float32(1.0 / self.temperature))
        else:
            tree["a"] = t(self.a)
            tree["b"] = t(self.b)
        return tree


def mlp_logits(weights, biases, x: torch.Tensor) -> torch.Tensor:
    """Linear -> ReLU -> ... -> Linear, raw logits. The training classifier
    runs this same function, so the export gate compares identical ops."""
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = torch.matmul(x, w) + b
        if i < n - 1:
            x = torch.relu(x)
    return x


def head_apply(params: dict, features: torch.Tensor) -> torch.Tensor:
    """Calibrated-head forward: (N, D) float32 -> (N, K) float32."""
    if features.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the head needs"
            " full float32 matmuls"
        )
    p = torch.softmax(
        mlp_logits(params["weights"], params["biases"], features), dim=1)
    if "inv_t" in params:
        # p^(1/T) renormalized through the log-probabilities (not
        # softmax(logits / T), which amplifies the rounding of 1/T by the
        # logit magnitude). log(0) = -inf maps back to exactly 0.
        return torch.softmax(torch.log(p) * params["inv_t"], dim=1)
    c = torch.sigmoid(-(params["a"] * p + params["b"]))
    denom = c.sum(dim=1, keepdim=True)
    nonzero = denom != 0
    safe_denom = torch.where(nonzero, denom, torch.ones_like(denom))
    uniform = torch.full_like(c, 1.0 / float(c.shape[1]))
    proba = torch.where(nonzero, c / safe_denom, uniform)
    return torch.where(
        (proba > 1.0) & (proba <= 1.0 + _OVERSHOOT_EPS),
        torch.ones_like(proba),
        proba,
    )


def make_head_fn(params: HeadParams, device):
    """Bind params on ``device``; returns a (N, D) float32 array or tensor
    -> (N, K) float64 ndarray callable."""
    tensors = params.as_tensors(device)
    device = torch.device(device)

    def run(features) -> np.ndarray:
        x = torch.as_tensor(features, dtype=torch.float32).to(device)
        with torch.inference_mode():
            out = head_apply(tensors, x)
        return out.cpu().numpy().astype(np.float64)

    return run
