"""Stride-1 SAME k×k depthwise conv + bias: the CUDA kernel's wrapper.

Port of ``mermaid_classifier_tpu/ops/depthwise.py``. The kernel is
``csrc/depthwise.cu``; its note gives the bound (device memory, and the
bit-exact arithmetic ceiling) and the design: the maps walked as one stack
of rows, one block per (32 channels, band of the stack) that walks its band
in strips through a ring of staged rows, 16-byte ``cp.async`` staging
overlapped with the arithmetic, taps in registers, 8 outputs per thread. ``depthwise_conv_reference`` is its plain
PyTorch version with the same rounding: an f32 accumulator that starts at
the bias, taps added in dy-major, dx-minor order, one cast to x.dtype at
the end.

``tile_plan`` is the kernel's plan for a call: the band and strip heights
(from the shared-memory formula, which ``_smem_bytes`` mirrors and a card
test holds to the kernel's own) and the staging instance — 16-byte copies
when x is 16-byte aligned and C is a multiple of the vector width (4 f32,
8 bf16), else scalar loads. Both instances compute the same bits.

``depthwise_conv`` takes the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel or raises. ``launches`` counts kernel launches.

The TPU kernel's ``block_b`` and ``interpret`` arguments and its padding of
the channels to the 128-lane tile are layout concerns of its VMEM blocks and
are not carried over; ragged channel groups are masked. The accumulator is
f32 only; a bf16 ``acc_dtype`` raises (it would be a new precision option
behind the cosine gate).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from mermaid_classifier_tpu_torch import _build

launches = 0

# Shared memory one block should take (three blocks fit one SM's 227 KB),
# and the most one block may take, for a map too wide for one row otherwise.
_SMEM_BUDGET = 64 * 1024
_SMEM_MAX = 227 * 1024
_TC = 32  # csrc/depthwise.cu kTC: channels per block
_R = 8  # csrc/depthwise.cu kR: adjacent outputs of a row per thread
# Blocks the band split aims for (about 8 per SM of the H100's 132), the
# fewest stack rows a band may have, and the most rows a strip may have.
_TARGET_BLOCKS = 1024
_MIN_BAND = 8
_STRIP_MAX = 8

_ACTS = (torch.float32, torch.bfloat16)


class TilePlan(NamedTuple):
    """How the kernel cuts one call: ``band`` rows of the stack per block,
    walked in strips of ``strip`` rows (``strip >= band``: one strip),
    staged with 16-byte copies when ``vector_loads``, else with scalar
    loads."""

    band: int
    strip: int
    vector_loads: bool


def _smem_bytes(band: int, strip: int, w: int, k: int, item: int) -> int:
    """csrc/depthwise.cu smem_bytes: the ring of staged rows, each the map
    padded to a multiple of ``_R`` plus the halo, ``_TC`` channels of
    ``item`` bytes."""
    ring = (band if strip >= band else 2 * strip) + k - 1
    cols = -(-w // _R) * _R + k - 1
    return ring * cols * _TC * item


def _band_rows(n: int, h: int, c: int, k: int) -> int:
    """Rows of the stack each block takes. The kernel walks the n maps as
    one stack of n * (h + k - 1) - (k - 1) output rows (each map followed
    by k - 1 rows that produce nothing), cut into as many bands as it takes
    for the grid to reach ``_TARGET_BLOCKS``, none under ``_MIN_BAND``
    rows."""
    rows = n * (h + k - 1) - (k - 1)
    bands = -(-_TARGET_BLOCKS // -(-c // _TC))
    return max(min(rows, _MIN_BAND), -(-rows // bands))


def tile_plan(n: int, h: int, w: int, c: int, k: int, dtype: torch.dtype,
              data_ptr: int) -> TilePlan:
    """The band, the strip and the staging instance for an (n, h, w, c)
    input at ``data_ptr``: the whole band as one strip if it fits the
    shared-memory budget, else the tallest strip (up to ``_STRIP_MAX``) whose
    ring fits it, else the same within the hardware limit."""
    item = 2 if dtype == torch.bfloat16 else 4
    vector = data_ptr % 16 == 0 and c % (16 // item) == 0
    band = _band_rows(n, h, c, k)
    for budget in (_SMEM_BUDGET, _SMEM_MAX):
        for strip in (band, *range(min(band - 1, _STRIP_MAX), 0, -1)):
            if _smem_bytes(band, strip, w, k, item) <= budget:
                return TilePlan(band, strip, vector)
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
    plan = tile_plan(n, h, w, c, k, x.dtype, x.data_ptr())
    lib = _build.load()
    err = lib.mct_depthwise(
        x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
        int(plan.vector_loads), n, h, w, c, k, w_dw.data_ptr(),
        b_dw.data_ptr(), plan.band, plan.strip,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "depthwise_conv")
    launches += 1
    return out
