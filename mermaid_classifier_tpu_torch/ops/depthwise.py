"""Stride-1 SAME k×k depthwise conv + bias: the CUDA kernel's wrapper.

Port of ``mermaid_classifier_tpu/ops/depthwise.py``. The kernel is
``csrc/depthwise.cu``; its note says what bounds it (device memory) and how
it is tiled. ``depthwise_conv_reference`` is its plain PyTorch version with
the same rounding: an f32 accumulator that starts at the bias, taps added in
dy-major, dx-minor order, one cast to x.dtype at the end.

``depthwise_conv`` takes the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel or raises. ``launches`` counts kernel launches.

The TPU kernel's ``block_b`` and ``interpret`` arguments and its padding of
the channels to the 128-lane tile are layout concerns of its VMEM blocks and
are not carried over: a Hopper block stages its own tile of rows and 32
channels, ragged channel groups masked. The accumulator is f32 only; a bf16
``acc_dtype`` raises (it would be a new precision option behind the cosine
gate).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mermaid_classifier_tpu_torch import _build

launches = 0

# Shared memory one block should take (two blocks fit one SM's 227 KB), and
# the most one block may take, for a map too wide for one row otherwise.
_SMEM_BUDGET = 96 * 1024
_SMEM_MAX = 227 * 1024
_TC = 32  # csrc/depthwise.cu kTC: channels per block

_ACTS = (torch.float32, torch.bfloat16)


def _smem_floats(rows: int, w: int, k: int) -> int:
    """csrc/depthwise.cu smem_floats."""
    p = (k - 1) // 2
    return (rows + 2 * p) * (w + 2 * p) * _TC + k * k * _TC


def rows_per_tile(h: int, w: int, k: int) -> int:
    """Output rows per block: the most (up to 16) whose staged tile and taps
    fit the shared-memory budget, else the most that fit the hardware."""
    for budget in (_SMEM_BUDGET, _SMEM_MAX):
        for rows in range(min(h, 16), 0, -1):
            if 4 * _smem_floats(rows, w, k) <= budget:
                return rows
    raise ValueError(
        f"a {w}-wide map does not fit the depthwise kernel's row tile at k={k}"
    )


def depthwise_conv_reference(x: torch.Tensor, w_dw: torch.Tensor,
                             b_dw: torch.Tensor, *, kernel: int = 5) -> torch.Tensor:
    """Plain PyTorch version: (N, H, W, C) -> (N, H, W, C) in x.dtype."""
    n, h, w, c = x.shape
    k = kernel
    p = (k - 1) // 2
    xp = F.pad(x.float(), (0, 0, p, p, p, p))  # zero pad H and W of NHWC
    acc = torch.zeros((n, h, w, c), dtype=torch.float32, device=x.device) + b_dw
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[:, dy:dy + h, dx:dx + w, :] * w_dw[dy, dx]
    return acc.to(x.dtype)


def depthwise_conv(
    x: torch.Tensor,
    w_dw: torch.Tensor,
    b_dw: torch.Tensor,
    *,
    kernel: int = 5,
    acc_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Stride-1 SAME depthwise conv + bias.

    x: (N, H, W, C) float32 or bfloat16; w_dw: (k, k, C) per-channel taps;
    b_dw: (C,). On a CUDA tensor the weights must be contiguous float32
    tensors on x's device. Returns (N, H, W, C) in x.dtype, accumulated in
    f32.
    """
    global launches
    k = kernel
    if k < 1 or k % 2 == 0:
        raise ValueError(f"kernel must be odd (SAME taps are symmetric), got {k}")
    if acc_dtype != torch.float32:
        raise ValueError(f"acc_dtype must be float32, got {acc_dtype}")
    if x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    n, h, w, c = x.shape
    if tuple(w_dw.shape) != (k, k, c):
        raise ValueError(f"w_dw {tuple(w_dw.shape)} != {(k, k, c)}")
    if tuple(b_dw.shape) != (c,):
        raise ValueError(f"b_dw {tuple(b_dw.shape)} != {(c,)}")
    if x.dtype not in _ACTS:
        raise ValueError(f"activations must be float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return depthwise_conv_reference(x, w_dw, b_dw, kernel=k)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv runs on cpu or cuda, not {x.device}")
    for t in (w_dw, b_dw):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "depthwise weights and bias must be contiguous float32"
                " tensors on the activations' device"
            )
    x = x.contiguous()
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _build.load()
    err = lib.mct_depthwise(
        x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
        n, h, w, c, k, w_dw.data_ptr(), b_dw.data_ptr(),
        rows_per_tile(h, w, k),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "depthwise_conv")
    launches += 1
    return out
