"""Point-patch extraction helpers and the plain crop + normalize.

Port of ``mermaid_classifier_tpu/ops/patch_ops.py``. Crops are taken from
the image zero-padded by patch_size//2 on every side, so every crop is in
bounds and starts at the point's own (row, col) in the padded image; the
crop takes that padding as ``pad`` and reads the raw image, so no padded
copy is needed. Each patch is then ``x * scale + bias`` per channel, with
scale = 1/(255*std) and bias = -mean/std (uint8 in, float32 affine,
``out_dtype`` out).

``extract_patches_plain`` is the plain PyTorch version of the contract; the
CUDA kernel that the extractor runs on the card is ``ops/patch_crop.py``.

Crop contract: patch[i, j] = image[r - ps//2 + i, c - ps//2 + j], zeros
outside the image.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def channel_scale_bias(
    mean_rgb: tuple[float, float, float],
    std_rgb: tuple[float, float, float],
) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel affine folding /255 and (x-mean)/std into x*scale+bias."""
    mean = np.asarray(mean_rgb, dtype=np.float32)
    std = np.asarray(std_rgb, dtype=np.float32)
    scale = (1.0 / (255.0 * std)).astype(np.float32)
    bias = (-mean / std).astype(np.float32)
    return scale, bias


def pad_image(image: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Zero-pad (H, W, 3) by patch_size//2 on each spatial side."""
    half = patch_size // 2
    return F.pad(image, (0, 0, half, half, half, half))


def rowcols_to_starts(rowcols, patch_size: int) -> torch.Tensor:
    """Point centers in the original image -> top-left offsets in the padded
    image. With pad = ps//2 the centered crop starting at r - ps//2 in the
    original lands exactly at r in the padded image."""
    del patch_size  # the identity holds for any ps given pad = ps//2
    return torch.as_tensor(np.asarray(rowcols), dtype=torch.int32)


def extract_patches_plain(
    image: torch.Tensor,
    starts: torch.Tensor,
    patch_size: int,
    scale: torch.Tensor,
    bias: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
    pad: int = 0,
) -> torch.Tensor:
    """Gather + normalize with advanced indexing.

    image: (H, W, 3) uint8; starts: (P, 2) int32 on the same device, the
    top-left corners in the image zero-padded by ``pad`` on each side;
    scale, bias: (3,) float32. Patch p is
    ``image[r - pad + i, c - pad + j]`` with zeros outside the image.
    Returns (P, ps, ps, 3) in ``out_dtype``; the affine is one f32 multiply
    then one f32 add, also on the zeros.
    """
    if pad:
        image = F.pad(image, (0, 0, pad, pad, pad, pad))
    offs = torch.arange(patch_size, device=image.device)
    starts = starts.to(device=image.device, dtype=torch.long)
    rows = starts[:, 0, None] + offs  # (P, ps)
    cols = starts[:, 1, None] + offs
    patches = image[rows[:, :, None], cols[:, None, :]]  # (P, ps, ps, 3)
    return (patches.float() * scale + bias).to(out_dtype)
