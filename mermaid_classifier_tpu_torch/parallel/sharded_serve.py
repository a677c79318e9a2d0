"""Batch-sharded serving: the calibrated head over a device mesh.

Port of ``mermaid_classifier_tpu/parallel/sharded_serve.py``. The head's
parameters are replicated on every rank; each rank runs ``head_apply`` on
its contiguous slice of the batch and one all-gather rebuilds the batch, so
every rank returns the whole ``(N, K)`` float64 result. The per-row math is
the single-device ``head_apply``'s.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mermaid_classifier_tpu_torch.inference.head import HeadParams, head_apply
from mermaid_classifier_tpu_torch.ops.fused_mbconv import full_f32
from mermaid_classifier_tpu_torch.parallel.mesh import Mesh


class ShardedHeadFn:
    """``features (N, D) -> probabilities (N, K) float64`` over ``mesh``:
    ``device_call`` is the device half (this rank's rows in, the gathered
    float32 batch out), ``__call__`` adds the checks and the host copies."""

    def __init__(self, mesh: Mesh, params: HeadParams) -> None:
        self.mesh = mesh
        self.tensors = params.as_tensors(mesh.device)
        self.input_dim = params.input_dim

    def device_call(self, local: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), full_f32():
            return self.mesh.all_gather_rows(head_apply(self.tensors, local))

    def __call__(self, features) -> np.ndarray:
        features = torch.as_tensor(features, dtype=torch.float32)
        if features.ndim != 2 or features.shape[1] != self.input_dim:
            raise ValueError(
                f"features must be (N, {self.input_dim});"
                f" got {tuple(features.shape)}."
            )
        n_total = self.mesh.size
        if features.shape[0] % n_total != 0:
            raise ValueError(
                f"batch size {features.shape[0]} is not divisible by the"
                f" {n_total}-device mesh; pad to a multiple first."
            )
        share = features.shape[0] // n_total
        start = self.mesh.rank * share
        out = self.device_call(features[start:start + share].to(self.mesh.device))
        return out.cpu().numpy().astype(np.float64)


def make_sharded_head_fn(mesh: Mesh, params: HeadParams) -> ShardedHeadFn:
    """Build ``features (N, D) -> probabilities (N, K) float64`` with the
    batch sharded over the whole mesh and the head replicated.

    N must divide by the mesh size; the serve-shape packer upstream pads
    batches to fixed sizes, so callers already control N.
    """
    return ShardedHeadFn(mesh, params)


def load_sharded_predictor(artifact: str | Path, mesh: Mesh):
    """A ``Predictor`` whose head runs batch-sharded over ``mesh``.

    Every loader gate runs first (the single-device ``load_predictor`` on
    this rank's device is the validation authority: schema, probe, class
    count); then its parsed ``head_params`` are re-wrapped in the mesh
    head. Any batch size works: rows pad with zeros up to the mesh-size
    multiple and the pad rows are dropped before returning."""
    from mermaid_classifier_tpu_torch.inference.loader import (
        Predictor,
        load_predictor,
    )

    base = load_predictor(artifact, device=mesh.device)
    run = make_sharded_head_fn(mesh, base.head_params)
    n_devices = mesh.size

    def head_fn(features) -> np.ndarray:
        features = torch.as_tensor(features, dtype=torch.float32).cpu()
        pad = -len(features) % n_devices
        if pad:
            features = torch.cat(
                [features, features.new_zeros((pad, features.shape[1]))])
        out = run(features)
        return out[: len(out) - pad] if pad else out

    return Predictor(head_fn, base.classes, base.input_dim,
                     head_params=base.head_params)
