"""Data-parallel feature extraction over a device mesh.

Port of ``mermaid_classifier_tpu/parallel/sharded_extract.py``. Extraction
is embarrassingly parallel: the backbone is replicated on every rank, each
rank runs its contiguous slice of the batch through it, and one
``all_gather_into_tensor`` rebuilds the batch in rank order, so every rank
returns the whole ``(N, D)`` result (the SPMD counterpart of XLA splitting
a batch sharded ``P(("data", "model"))``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from mermaid_classifier_tpu_torch.models.efficientnet import EfficientNetConfig
from mermaid_classifier_tpu_torch.parallel.mesh import Mesh


class ShardedFeatureFn:
    """``patches (N, ps, ps, 3) -> features (N, D)`` over ``mesh``.

    ``forward`` is the replicated per-rank trunk. ``local`` runs it on this
    rank's rows only and ``gather`` stacks every rank's rows; the extractor
    uses the two halves to crop only its own share of an image's points."""

    def __init__(self, mesh: Mesh, forward: Callable[[torch.Tensor], torch.Tensor],
                 weights: Any = None):
        self.mesh = mesh
        self.forward = forward
        # The folded weights on the rank's device (None for "module").
        self.weights = weights

    def check_batch(self, n: int) -> None:
        if n % self.mesh.size != 0:
            raise ValueError(
                f"batch size {n} is not divisible by the"
                f" {self.mesh.size}-device mesh; pad to a multiple first."
            )

    def gather(self, local_features: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_gather_rows(local_features.to(torch.float32))

    def __call__(self, patches: torch.Tensor) -> torch.Tensor:
        n = patches.shape[0]
        self.check_batch(n)
        share = n // self.mesh.size
        start = self.mesh.rank * share
        local = patches[start:start + share].to(self.mesh.device)
        with torch.inference_mode():
            return self.gather(self.forward(local))


def make_sharded_feature_fn(
    mesh: Mesh,
    variables: Any,
    config: EfficientNetConfig | None = None,
    *,
    backbone_impl: str = "folded",
    prefolded: Any = None,
) -> ShardedFeatureFn:
    """Build ``patches (N, ps, ps, 3) -> features (N, D)`` with the batch
    sharded over every rank of ``mesh`` and the backbone replicated.

    The per-rank forward follows ``backbone_impl``: ``"folded"`` (the
    BN-folded trunk in plain PyTorch blocks; the fold is
    batch-independent, so sharding the batch composes with it unchanged)
    or ``"module"`` (the ``nn.Module`` forward, the parity reference and
    the counterpart of the JAX ``"flax"``). ``prefolded`` lets a caller
    that already folded the bundle skip a second host-side fold.

    N must be divisible by the mesh size (the extractor's fixed
    ``backbone_batch`` chunks guarantee it).
    """
    from mermaid_classifier_tpu_torch.models.extractor import _module_forward
    from mermaid_classifier_tpu_torch.ops import fused_mbconv

    config = config or EfficientNetConfig()
    if backbone_impl == "folded":
        folded = prefolded if prefolded is not None else fused_mbconv.fold_backbone(
            variables, config)
        weights = fused_mbconv.to_device(folded, mesh.device)

        def forward(patches: torch.Tensor) -> torch.Tensor:
            return fused_mbconv.apply_folded(weights, config, patches)
    elif backbone_impl == "module":
        weights = None
        forward = _module_forward(variables, config, mesh.device)
    else:
        raise ValueError(
            f"backbone_impl must be folded|module for the sharded forward,"
            f" got {backbone_impl!r}"
        )
    return ShardedFeatureFn(mesh, forward, weights)
