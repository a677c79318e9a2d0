"""Patch crop + normalize: the CUDA kernel's wrapper.

Replaces the Pallas kernel ``extract_patches_pallas``
(``mermaid_classifier_tpu/experiments/pallas_crop.py:72``), which was the
extractor's gather under ``use_pallas=True``. In the port it is the gather
itself. The kernel is ``csrc/patch_crop.cu``; its note says what bounds it
(device memory: the patches written, 4 or 2 bytes per output, and the
in-image bytes they cover read) and how it is laid out. Its plain version
is ``patch_ops.extract_patches_plain``.

The crop reads the image as if zero-padded by ``pad`` on each side: patch
p is ``image[r - pad + i, c - pad + j]``, zeros outside the image. The
extractor passes the raw image with ``pad = ps // 2``; ``pad = 0`` crops a
caller's padded image as it is.

``extract_patches`` takes the plain version only for a CPU image; for a CUDA
image it launches the kernel or raises. ``launch`` is the crop alone, for
callers that hold device starts and an output. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import numpy as np
import torch

from mermaid_classifier_tpu_torch import _build
from mermaid_classifier_tpu_torch.ops.patch_ops import extract_patches_plain

launches = 0

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _validate_starts(starts, h: int, w: int, patch_size: int,
                     pad: int) -> np.ndarray:
    """(P, 2) host int32 starts with every crop inside the (h, w) image
    padded by ``pad`` on each side."""
    starts = np.asarray(starts)
    if starts.ndim != 2 or starts.shape[1] != 2:
        raise ValueError(f"starts must be (P, 2), got {starts.shape}")
    starts = starts.astype(np.int32)
    hp, wp = h + 2 * pad, w + 2 * pad
    if starts.shape[0] and (
        (starts < 0).any()
        or (starts[:, 0] > hp - patch_size).any()
        or (starts[:, 1] > wp - patch_size).any()
    ):
        raise ValueError(
            f"a {patch_size}x{patch_size} crop at one of the starts leaves"
            f" the {h}x{w} image padded by {pad} ({hp}x{wp})"
        )
    return starts


def extract_patches(
    image: torch.Tensor,
    starts,
    patch_size: int,
    scale: np.ndarray,
    bias: np.ndarray,
    out_dtype: torch.dtype = torch.float32,
    pad: int = 0,
) -> torch.Tensor:
    """Crop + normalize: (H, W, 3) uint8 + (P, 2) host starts in the image
    padded by ``pad`` -> (P, ps, ps, 3) ``out_dtype`` on the image's device.

    scale, bias: the (3,) float32 per-channel affine (``channel_scale_bias``).
    """
    if image.dtype != torch.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(
            f"image must be (H, W, 3) uint8, got {tuple(image.shape)}"
            f" {image.dtype}"
        )
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if pad < 0:
        raise ValueError(f"pad must be >= 0, got {pad}")
    h, w, _ = image.shape
    starts = _validate_starts(starts, h, w, patch_size, pad)
    scale = np.asarray(scale, np.float32).reshape(3)
    bias = np.asarray(bias, np.float32).reshape(3)
    device = image.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"extract_patches runs on cpu or cuda, not {device}")
    n = starts.shape[0]
    out = torch.empty((n, patch_size, patch_size, 3), dtype=out_dtype,
                      device=device)
    if n == 0:
        return out
    starts_dev = torch.from_numpy(starts)
    if device.type == "cuda":
        starts_dev = starts_dev.pin_memory().to(device, non_blocking=True)
    return launch(image.contiguous(), starts_dev, out,
                  (*map(float, scale), *map(float, bias)), pad)


def launch(image: torch.Tensor, starts: torch.Tensor, out: torch.Tensor,
           affine, pad: int = 0) -> torch.Tensor:
    """The crop alone, into ``out``: no validation and no copies.

    image: contiguous (H, W, 3) uint8; starts: contiguous (P, 2) int32 on
    the image's device, every crop inside the image padded by ``pad``; out:
    (P, ps, ps, 3) float32 or bfloat16 on that device; affine: the six
    floats (scale[0..2], bias[0..2]). A CUDA image launches the kernel, a
    CPU image runs the plain version. Returns ``out``.
    """
    global launches
    n, ps = out.shape[0], out.shape[1]
    if image.device.type == "cpu":
        scale, bias = torch.tensor(affine[:3]), torch.tensor(affine[3:])
        return out.copy_(extract_patches_plain(image, starts, ps, scale, bias,
                                               out.dtype, pad))
    h, w, _ = image.shape
    err = _build.load().mct_patch_crop(
        image.data_ptr(), h, w, starts.data_ptr(), n, ps, pad, *affine,
        out.data_ptr(), int(out.dtype == torch.bfloat16),
        torch.cuda.current_stream(image.device).cuda_stream,
    )
    _build.check(err, "patch_crop")
    launches += 1
    return out
