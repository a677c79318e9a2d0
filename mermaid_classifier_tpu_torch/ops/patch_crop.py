"""Patch crop + normalize: the CUDA kernel's wrapper.

Replaces the Pallas kernel ``extract_patches_pallas``
(``mermaid_classifier_tpu/experiments/pallas_crop.py:72``), which was the
extractor's gather under ``use_pallas=True``. In the port it is the gather
itself. The kernel is ``csrc/patch_crop.cu``; its note says what bounds it
(device memory: P*ps*ps*3 bytes read, 4 or 2 times that written) and how it
is laid out. Its plain version is ``patch_ops.extract_patches_plain``.

``extract_patches`` takes the plain version only for a CPU image; for a CUDA
image it launches the kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from mermaid_classifier_tpu_torch import _build
from mermaid_classifier_tpu_torch.ops.patch_ops import extract_patches_plain

launches = 0

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _validate_starts(starts, hp: int, wp: int, patch_size: int) -> np.ndarray:
    """(P, 2) host int32 starts with every crop inside the (hp, wp) image."""
    starts = np.asarray(starts)
    if starts.ndim != 2 or starts.shape[1] != 2:
        raise ValueError(f"starts must be (P, 2), got {starts.shape}")
    starts = starts.astype(np.int32)
    if starts.shape[0] and (
        (starts < 0).any()
        or (starts[:, 0] > hp - patch_size).any()
        or (starts[:, 1] > wp - patch_size).any()
    ):
        raise ValueError(
            f"a {patch_size}x{patch_size} crop at one of the starts leaves"
            f" the {hp}x{wp} padded image"
        )
    return starts


def extract_patches(
    padded_image: torch.Tensor,
    starts,
    patch_size: int,
    scale: np.ndarray,
    bias: np.ndarray,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Crop + normalize: (Hp, Wp, 3) uint8 + (P, 2) host starts ->
    (P, ps, ps, 3) ``out_dtype`` on the image's device.

    scale, bias: the (3,) float32 per-channel affine (``channel_scale_bias``).
    """
    global launches
    if padded_image.dtype != torch.uint8 or padded_image.ndim != 3 or (
        padded_image.shape[2] != 3
    ):
        raise ValueError(
            f"padded image must be (Hp, Wp, 3) uint8, got"
            f" {tuple(padded_image.shape)} {padded_image.dtype}"
        )
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    hp, wp, _ = padded_image.shape
    starts = _validate_starts(starts, hp, wp, patch_size)
    scale = np.asarray(scale, np.float32).reshape(3)
    bias = np.asarray(bias, np.float32).reshape(3)
    device = padded_image.device
    if device.type == "cpu":
        return extract_patches_plain(
            padded_image, torch.from_numpy(starts), patch_size,
            torch.from_numpy(scale), torch.from_numpy(bias), out_dtype,
        )
    if device.type != "cuda":
        raise ValueError(f"extract_patches runs on cpu or cuda, not {device}")
    n = starts.shape[0]
    out = torch.empty((n, patch_size, patch_size, 3), dtype=out_dtype,
                      device=device)
    if n == 0:
        return out
    image = padded_image.contiguous()
    starts_dev = torch.from_numpy(starts).to(device)
    lib = _build.load()
    err = lib.mct_patch_crop(
        image.data_ptr(), wp, starts_dev.data_ptr(), n, patch_size,
        *(float(v) for v in scale), *(float(v) for v in bias),
        out.data_ptr(), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "patch_crop")
    launches += 1
    return out
