"""FeatureExtractor: decoded image + annotated points -> feature vectors.

Port of ``mermaid_classifier_tpu/models/extractor.py``. The weights are held
on one device, given explicitly (``device="cuda"`` or ``"cpu"``; there is no
"cuda if available"). Per image:

1. the raw image is uploaded once, with no padded copy: the ps//2 zero pad
   is folded into the crop;
2. the point list is padded to a multiple of ``point_bucket`` by duplicating
   point 0, and every patch is cropped and normalized on the device by the
   crop kernel (``ops/patch_crop.py``, ``pad = ps // 2``: zeros outside the
   image) in the trunk's compute dtype; the padding points are trimmed;
3. the trunk runs over chunks of ``backbone_batch`` patches, a Python loop
   (PyTorch runs eagerly, so the last chunk keeps its own size).

``backbone_impl`` picks the trunk: ``"fused"`` (default: folded weights, the
fused-MBConv kernel for every fusable block), ``"folded"`` (folded weights,
plain PyTorch blocks) or ``"module"`` (the ``nn.Module`` forward, the
counterpart of the JAX package's ``"flax"``). The JAX default "folded" was a
TPU measurement; the port's default is the path that runs its kernels.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any

import numpy as np
import torch

from mermaid_classifier_tpu_torch.models.efficientnet import (
    EfficientNetBackbone,
    EfficientNetConfig,
    compute_dtype,
    init_backbone_params,
    load_jax_variables,
)
from mermaid_classifier_tpu_torch.ops import fused_mbconv
from mermaid_classifier_tpu_torch.ops.patch_crop import extract_patches
from mermaid_classifier_tpu_torch.ops.patch_ops import channel_scale_bias

BACKBONE_IMPLS = ("module", "folded", "fused")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class DeviceNumericsError(RuntimeError):
    """The configured backbone diverges from the f32 CPU reference beyond
    the cosine-similarity gate."""


def _resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is"
            " False"
        )
    return device


def _module_forward(variables, config: EfficientNetConfig, device):
    dtype = compute_dtype(config)
    module = EfficientNetBackbone(config)
    load_jax_variables(module, variables)
    module = module.to(device=device, dtype=dtype).eval()

    def forward(patches: torch.Tensor) -> torch.Tensor:
        with fused_mbconv.full_f32():
            return module(patches)

    return forward


class FeatureExtractor:
    """Cached-backbone batched point-feature extractor."""

    def __init__(
        self,
        variables: Any,
        config: EfficientNetConfig | None = None,
        *,
        device,
        backbone_batch: int = 128,
        point_bucket: int = 32,
        image_bucket: int = 256,
        backbone_impl: str = "fused",
    ) -> None:
        self.config = config or EfficientNetConfig()
        self.device = _resolve_device(device)
        self.variables = variables
        self.backbone_batch = int(backbone_batch)
        self.point_bucket = int(point_bucket)
        self.image_bucket = int(image_bucket)
        if backbone_impl not in BACKBONE_IMPLS:
            raise ValueError(
                f"backbone_impl must be module|folded|fused, got {backbone_impl!r}"
            )
        self.backbone_impl = backbone_impl
        self.dtype = compute_dtype(self.config)
        if backbone_impl == "module":
            self._forward = _module_forward(variables, self.config, self.device)
        else:
            weights = fused_mbconv.to_device(
                fused_mbconv.fold_backbone(variables, self.config), self.device
            )
            run_fused = backbone_impl == "fused"
            cfg = self.config

            def forward(patches: torch.Tensor) -> torch.Tensor:
                return fused_mbconv.apply_folded(
                    weights, cfg, patches, fused=run_fused
                )

            self._forward = forward
        self._scale, self._bias = channel_scale_bias(
            self.config.mean_rgb, self.config.std_rgb
        )

    @property
    def feature_dim(self) -> int:
        return self.config.feature_dim

    # -- patch gathering ----------------------------------------------------

    def _prepare_image(self, image: np.ndarray) -> np.ndarray:
        """Centered zero pad (ps//2 each side) + bottom/right pad to the
        size bucket, host-side: the JAX extractor's padded frame, kept to
        hold the bucketing to it. No extraction path calls it: the crop
        folds the pad in and reads the raw image."""
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"image must be (H, W, 3), got {image.shape}")
        ps = self.config.patch_size
        half = ps // 2
        h, w, _ = image.shape
        hp = _round_up(h + 2 * half, self.image_bucket)
        wp = _round_up(w + 2 * half, self.image_bucket)
        out = np.zeros((hp, wp, 3), dtype=np.uint8)
        out[half : half + h, half : half + w] = image
        return out

    def _validate_rowcols(self, image: np.ndarray, rowcols) -> np.ndarray:
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"image must be (H, W, 3), got {image.shape}")
        rowcols = np.asarray(rowcols, dtype=np.int32)
        if rowcols.ndim != 2 or rowcols.shape[1] != 2:
            raise ValueError(f"rowcols must be (P, 2), got {rowcols.shape}")
        if rowcols.shape[0]:
            h, w, _ = image.shape
            if (rowcols < 0).any() or (rowcols[:, 0] >= h).any() or (
                rowcols[:, 1] >= w
            ).any():
                raise ValueError(
                    "rowcols contains points outside the image"
                    f" (image is {h}x{w})."
                )
        return rowcols

    @staticmethod
    def _pad_starts(rowcols: np.ndarray, multiple: int) -> np.ndarray:
        """Pad the point list up to ``multiple`` by duplicating point 0.
        With the centered ps//2 pad, a point's crop starts at its own
        (row, col) in the padded image."""
        n = rowcols.shape[0]
        starts = np.zeros((_round_up(n, multiple), 2), dtype=np.int32)
        starts[:n] = rowcols
        starts[n:] = rowcols[0]
        return starts

    def _upload(self, image: np.ndarray) -> torch.Tensor:
        """The raw (H, W, 3) uint8 image on the device: one host-to-device
        copy, and a host copy only when the image is not contiguous
        uint8."""
        return torch.from_numpy(
            np.ascontiguousarray(image, dtype=np.uint8)).to(self.device)

    def _crop(self, image: torch.Tensor, rowcols: np.ndarray) -> torch.Tensor:
        """Raw device image + validated, non-empty (P, 2) points -> the
        (P, ps, ps, 3) patches, cropped with the ps//2 pad folded in."""
        ps = self.config.patch_size
        starts = self._pad_starts(rowcols, self.point_bucket)
        patches = extract_patches(
            image, starts, ps, self._scale, self._bias, out_dtype=self.dtype,
            pad=ps // 2,
        )
        return patches[: rowcols.shape[0]]

    def extract_patches(self, image: np.ndarray, rowcols) -> torch.Tensor:
        """(H, W, 3) uint8 + (P, 2) points -> (P, ps, ps, 3) normalized
        patches on the device, in the trunk's compute dtype."""
        rowcols = self._validate_rowcols(image, rowcols)
        if rowcols.shape[0] == 0:
            ps = self.config.patch_size
            return torch.zeros((0, ps, ps, 3), dtype=self.dtype,
                               device=self.device)
        return self._crop(self._upload(image), rowcols)

    # -- backbone -----------------------------------------------------------

    def features_for_patches_device(self, patches: torch.Tensor) -> torch.Tensor:
        """(P, ps, ps, 3) -> (P, D) float32 on the device, in chunks of
        ``backbone_batch`` patches."""
        n = patches.shape[0]
        if n == 0:
            return torch.zeros((0, self.feature_dim), device=self.device)
        bb = self.backbone_batch
        with torch.inference_mode():
            outs = [self._forward(patches[i : i + bb]) for i in range(0, n, bb)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def features_for_patches(self, patches: torch.Tensor) -> np.ndarray:
        return self.features_for_patches_device(patches).cpu().numpy()

    def extract_features_device(self, image: np.ndarray, rowcols) -> torch.Tensor:
        """Per-image features as a (P, D) device tensor (no host readback)."""
        return self.features_for_patches_device(
            self.extract_patches(image, rowcols)
        )

    def extract_features(self, image: np.ndarray, rowcols) -> np.ndarray:
        """The per-image entry point: decoded image + points -> (P, D)
        float32 features on the host."""
        return self.extract_features_device(image, rowcols).cpu().numpy()

    def extract_features_many(
        self, items: list[tuple[np.ndarray, np.ndarray]]
    ) -> list[np.ndarray]:
        """Pack every image's patches into one backbone pass, split per
        image (the trunk has no cross-patch coupling, so the numbers are
        those of per-image extraction)."""
        if not items:
            return []
        batches = [self.extract_patches(image, rc) for image, rc in items]
        counts = [b.shape[0] for b in batches]
        features = self.features_for_patches(torch.cat(batches))
        out = []
        offset = 0
        for count in counts:
            out.append(features[offset : offset + count])
            offset += count
        return out

    # -- numerics self-check ------------------------------------------------

    def verify_device_numerics(
        self, n_patches: int = 8, min_cosine: float = 0.999, seed: int = 0
    ) -> float:
        """Run seeded random patches through the backbone as configured
        (device, impl, compute dtype) and through the f32 ``nn.Module``
        forward on the CPU; raise DeviceNumericsError below ``min_cosine``.
        Returns the worst per-patch cosine."""
        ps = self.config.patch_size
        rng = np.random.default_rng(seed)
        patches = rng.random((n_patches, ps, ps, 3)).astype(np.float32)
        with torch.inference_mode():
            got = self._forward(
                torch.from_numpy(patches).to(self.device)
            ).float().cpu().numpy()
            reference = _module_forward(
                self.variables, replace(self.config, compute_dtype="float32"),
                torch.device("cpu"),
            )
            want = reference(torch.from_numpy(patches)).numpy()
        num = np.sum(got.astype(np.float64) * want, axis=1)
        denom = np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1)
        worst = float(np.min(num / np.maximum(denom, 1e-12)))
        if not worst >= min_cosine:
            raise DeviceNumericsError(
                f"device backbone features diverge from the f32 CPU"
                f" reference: min cosine {worst:.6f} < {min_cosine}."
            )
        return worst


def build_extractor(
    weights: Any | None = None,
    config: EfficientNetConfig | None = None,
    seed: int = 0,
    *,
    device,
    **kwargs: Any,
) -> FeatureExtractor:
    """An extractor from a flax-layout weights bundle (numpy) or, when None,
    the seeded weights of ``init_backbone_params(seed)``."""
    config = config or EfficientNetConfig()
    if weights is None:
        weights = init_backbone_params(seed, config)
    return FeatureExtractor(weights, config, device=device, **kwargs)
