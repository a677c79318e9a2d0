"""BN-folded EfficientNet trunk and the fused-MBConv CUDA kernel's wrapper.

Port of ``mermaid_classifier_tpu/ops/fused_mbconv.py``:

- ``fold_backbone`` folds every BatchNorm into its conv host-side (numpy, the
  same dict as the JAX function): w' = w * gamma/sqrt(var+eps),
  b' = beta - mean * gamma/sqrt(var+eps). ``quantize_folded`` turns every
  ``(w, b)`` entry into the int8 triple ``(w_q, scale, b)`` (the same numpy
  code as the JAX function). ``to_device`` turns either bundle into tensors
  on one device, once (int8 weights stay int8); ``_wb`` unpacks an entry,
  dequantizing a triple.
- ``apply_folded`` (and its ``_prefix`` / ``_suffix`` halves) is the folded
  forward over NHWC activations in the config's compute dtype. Stem,
  stride-2 blocks and head are plain PyTorch (cuDNN/cuBLAS on the card, run
  with TF32 off). The schedule options route blocks as the JAX function
  does: ``fused=True`` sends every ``fusable`` block through
  ``fused_mbconv``; in the other blocks ``dw_pallas_kernels`` sends the
  stride-1 depthwise convs of those sizes to the depthwise kernel
  (``ops/depthwise.py``), ``dw_taps_kernels`` sends convs of those sizes to
  the plain tap sum ``_dw_taps``, and the rest go to cuDNN;
  ``stem_im2col`` runs the stem as ``_stem_im2col``.
- ``fused_mbconv`` runs one stride-1 block: the kernel in
  ``csrc/fused_mbconv.cu`` for a CUDA tensor, the plain version
  ``fused_mbconv_reference`` for a CPU tensor. ``launches`` counts kernel
  launch groups (one per call: expand+depthwise, SE, project), and
  ``sliced_launches`` those whose pass 1 streams Cin in slices through a
  cp.async ring
  (``tile_plan``: the blocks whose whole-Cin tile overflows the
  shared-memory budget, B4 and wider). The kernel
  is split at the squeeze-excite mean; its two 1x1 products run on the
  tensor cores (``mma.sync``: bf16 operands for bf16 activations, split
  TF32 for f32), so what bounds it is the depthwise taps on the CUDA cores,
  the shared-memory staging and the f32 round trip of the depthwise output
  through device memory (the source's note counts the bound). Each lane
  holds its depthwise taps in registers for k 3 and 5 and reads them
  through L1 for any other odd k. For bf16 activations the kernel rounds
  the expand and project weights to bf16 once, and the plain version does
  the same.

The TPU kernel's ``dw_layout`` and ``acc_dtype`` options are schedule knobs
of its VMEM layout; the port carries the f32-accumulator semantics only.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from mermaid_classifier_tpu_torch import _build
from mermaid_classifier_tpu_torch.models.efficientnet import (
    EfficientNetConfig,
    compute_dtype,
    conv_padding,
    pad_nchw,
)
from mermaid_classifier_tpu_torch.ops.depthwise import depthwise_conv

launches = 0
sliced_launches = 0

# Shared memory one pass-1 block may take: two blocks fit one SM's 227 KB
# (csrc/fused_mbconv.cu kPass1SmemBudget; the card tests hold this copy and
# ``_pass1_smem_floats`` against the kernel's own).
_PASS1_SMEM_BUDGET = 110 * 1024
_KTC, _KZS, _KWARPS = 32, 33, 8  # csrc/fused_mbconv.cu kTC, kZs, kWarps
# The sliced pass 1: input channels per slice, the staged positions a tile
# may hold and the slices in its cp.async ring (csrc/fused_mbconv.cu kKC,
# kSlicedPositions, kStages).
_KKC, _SLICED_POSITIONS, _KSTAGES = 32, 512, 2


# ---------------------------------------------------------------------------
# BN folding
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockMeta:
    """Static shape/topology facts for one MBConv block."""

    in_channels: int
    mid_channels: int
    out_channels: int
    kernel: int
    stride: int
    has_expand: bool
    residual: bool
    # Spatial extent of the block INPUT for a patch-sized image.
    h: int
    w: int


def fusable(meta: BlockMeta) -> bool:
    """Blocks the fused kernel takes (the JAX rule, kept so both packages
    route the same blocks): stride 1, with an expansion, map <= 56."""
    return meta.stride == 1 and meta.has_expand and meta.h <= 56


def _fold(conv_kernel, bn_scale, bn_bias, bn_mean, bn_var, eps):
    """Fold BatchNorm(running stats) into the preceding conv's weights."""
    g = np.asarray(bn_scale) / np.sqrt(np.asarray(bn_var) + eps)
    w = np.asarray(conv_kernel) * g  # broadcast over the out-channel dim
    b = np.asarray(bn_bias) - np.asarray(bn_mean) * g
    return w.astype(np.float32), b.astype(np.float32)


def block_metas(config: EfficientNetConfig) -> list[BlockMeta]:
    """Per-block static metadata in execution order."""
    metas: list[BlockMeta] = []
    in_ch = config.stem_channels
    h = config.patch_size // 2  # after the stride-2 stem
    for expand, out_ch, repeats, stride, kernel in config.stages:
        for block_idx in range(repeats):
            s = stride if block_idx == 0 else 1
            metas.append(BlockMeta(
                in_channels=in_ch,
                mid_channels=in_ch * expand,
                out_channels=out_ch,
                kernel=kernel,
                stride=s,
                has_expand=expand != 1,
                residual=(s == 1 and in_ch == out_ch),
                h=h,
                w=h,
            ))
            if s == 2:
                h = -(-h // 2)  # stride-2 convs emit ceil(h/2)
            in_ch = out_ch
    return metas


def _block_name(config: EfficientNetConfig, flat_idx: int) -> str:
    i = 0
    for stage_idx, (_, _, repeats, _, _) in enumerate(config.stages):
        for block_idx in range(repeats):
            if i == flat_idx:
                return f"stage{stage_idx}_block{block_idx}"
            i += 1
    raise IndexError(flat_idx)


def fold_backbone(variables: Any, config: EfficientNetConfig) -> dict:
    """Fold every BatchNorm of a flax-layout variables bundle (numpy) into
    its conv; returns numpy float32 weights keyed as ``apply_folded``
    consumes them (after ``to_device``)."""
    eps = config.bn_eps
    params, stats = variables["params"], variables["batch_stats"]

    def fold_cba(p, s):
        return _fold(
            p["conv"]["kernel"], p["bn"]["scale"], p["bn"]["bias"],
            s["bn"]["mean"], s["bn"]["var"], eps,
        )

    folded: dict[str, Any] = {"stem": fold_cba(params["stem"], stats["stem"])}
    blocks = []
    for i, meta in enumerate(block_metas(config)):
        name = _block_name(config, i)
        p, s = params[name], stats[name]
        blk: dict[str, Any] = {"meta": meta}
        if meta.has_expand:
            blk["expand"] = fold_cba(p["expand"], s["expand"])
        w_dw, b_dw = fold_cba(p["depthwise"], s["depthwise"])
        blk["depthwise"] = (w_dw[:, :, 0, :], b_dw)  # (k, k, Cmid) taps
        for key, part in (("se_reduce", "reduce"), ("se_expand", "expand")):
            blk[key] = (
                np.asarray(p["se"][part]["kernel"])[0, 0].astype(np.float32),
                np.asarray(p["se"][part]["bias"]).astype(np.float32),
            )
        blk["project"] = fold_cba(p["project"], s["project"])
        blocks.append(blk)
    folded["blocks"] = blocks
    folded["head"] = fold_cba(params["head"], stats["head"])
    if "feature_projection" in params:
        fp = params["feature_projection"]
        folded["proj"] = (
            np.asarray(fp["kernel"]).astype(np.float32),
            np.asarray(fp["bias"]).astype(np.float32),
        )
    else:
        folded["proj"] = None
    return folded


def _quantize_wb(entry):
    """(w, b) -> (w_int8, scale_f32, b): symmetric per-output-channel
    int8 over the trailing (output) axis; bias stays float32."""
    w, b = entry
    w = np.asarray(w, np.float32)
    absmax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)), keepdims=True)
    scale = (absmax / 127.0).astype(np.float32)
    scale = np.where(scale == 0.0, 1.0, scale)
    w_q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return w_q, scale, np.asarray(b, np.float32)


def quantize_folded(folded: dict) -> dict:
    """int8-weight variant of a numpy folded bundle: every conv / SE /
    projection weight stored int8 with per-output-channel scales and
    dequantized at use. A reduced-precision path, held to the 0.999-cosine
    gate like bf16."""
    out: dict[str, Any] = {
        "stem": _quantize_wb(folded["stem"]),
        "head": _quantize_wb(folded["head"]),
        "proj": (
            _quantize_wb(folded["proj"]) if folded["proj"] is not None
            else None
        ),
    }
    blocks = []
    for blk in folded["blocks"]:
        q: dict[str, Any] = {"meta": blk["meta"]}
        for name in ("expand", "depthwise", "se_reduce", "se_expand",
                     "project"):
            if name in blk:
                q[name] = _quantize_wb(blk[name])
        blocks.append(q)
    out["blocks"] = blocks
    return out


def _wb(entry, dtype):
    """Unpack a folded entry on the device to (w in ``dtype``, b float32);
    an int8 triple is dequantized as w_q * per-channel scale in f32, then
    cast once to ``dtype``."""
    if len(entry) == 3:
        w_q, scale, b = entry
        return (w_q.float() * scale).to(dtype), b
    w, b = entry
    return w.to(dtype), b


def to_device(folded: dict, device) -> dict:
    """A numpy folded bundle (``fold_backbone`` or ``quantize_folded``) as
    contiguous tensors on ``device``: int8 weights stay int8, everything
    else is float32 (same nesting; metas kept)."""

    def wb(entry):
        return tuple(
            torch.as_tensor(
                np.ascontiguousarray(a), device=device,
                dtype=torch.int8 if a.dtype == np.int8 else torch.float32,
            )
            for a in entry
        )

    out: dict[str, Any] = {
        "stem": wb(folded["stem"]),
        "head": wb(folded["head"]),
        "proj": wb(folded["proj"]) if folded["proj"] is not None else None,
    }
    out["blocks"] = [
        {key: (val if key == "meta" else wb(val)) for key, val in blk.items()}
        for blk in folded["blocks"]
    ]
    return out


# ---------------------------------------------------------------------------
# Fused block: plain version and kernel wrapper
# ---------------------------------------------------------------------------


def _fused_weights(blk: dict) -> list[torch.Tensor]:
    """The fused kernel's ten weight and bias tensors in its argument
    order, float32 (int8 entries dequantized): expand (Cin, Cmid), taps
    (k, k, Cmid), SE reduce / expand, project (Cmid, Cout), each followed by
    its bias."""
    out = []
    for key in ("expand", "depthwise", "se_reduce", "se_expand", "project"):
        w, b = _wb(blk[key], torch.float32)
        out += [w[0, 0] if key in ("expand", "project") else w, b]
    return out


def fused_mbconv_reference(x: torch.Tensor, blk: dict) -> torch.Tensor:
    """Plain PyTorch version of the fused block (stride 1, with an
    expansion), with the kernel's rounding sites: the expand and project
    weights rounded to x.dtype; expand + SiLU in f32 then cast to x.dtype;
    depthwise as an f32 tap sum over the zero-padded
    expanded map; SE in f32; m cast to x.dtype; project in f32; residual
    added in f32; cast. (P, H, W, Cin) -> (P, H, W, Cout) in x.dtype."""
    meta: BlockMeta = blk["meta"]
    act = x.dtype
    n, h, w, _ = x.shape
    k = meta.kernel
    p = (k - 1) // 2
    xf = x.float()
    wexp, bexp, wdw, bdw, w1, b1, w2, b2, wproj, bproj = _fused_weights(blk)
    # The kernel's tensor-core operands: bf16 activations take the 1x1
    # weights rounded to bf16 (a no-op round trip for f32).
    wexp, wproj = wexp.to(act).float(), wproj.to(act).float()
    z = F.silu(torch.matmul(xf, wexp) + bexp).to(act).float()
    zp = F.pad(z, (0, 0, p, p, p, p))  # zero pad H and W of NHWC
    acc = torch.zeros_like(z) + bdw
    for dy in range(k):
        for dx in range(k):
            acc = acc + zp[:, dy:dy + h, dx:dx + w, :] * wdw[dy, dx]
    d = F.silu(acc)
    s = d.mean(dim=(1, 2))
    r = F.silu(torch.matmul(s, w1) + b1)
    e = torch.sigmoid(torch.matmul(r, w2) + b2)
    m = (d * e[:, None, None, :]).to(act).float()
    y = torch.matmul(m, wproj) + bproj
    if meta.residual:
        y = y + xf
    return y.to(act)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _a_stride(cin: int, bf16: bool) -> int:
    """csrc/fused_mbconv.cu a_stride: the staged input's row stride, the
    least >= Cin that is 8 mod 16 (bf16) or 4 mod 8 (f32)."""
    return _round_up(cin - 8, 16) + 8 if bf16 else _round_up(cin - 4, 8) + 4


def _pass1_smem_floats(rows: int, w: int, cin: int, k: int, bf16: bool,
                       sliced: bool = False) -> int:
    """csrc/fused_mbconv.cu pass1_smem_floats: the staged input and expand
    weights (whole: all Cin channels in f32 and the weights' K padded to 16;
    sliced: ``_KSTAGES`` ring stages, each a ``_KKC``-channel slice in the
    activation type and its ``_KKC`` f32 weight rows; weight rows of stride
    b_stride), the padded expanded map and the partial-sum reduction."""
    p = (k - 1) // 2
    zrows = rows + 2 * p
    b_stride = _KTC + (4 if bf16 else 8)
    if sliced:
        item = 2 if bf16 else 4
        staged = _KSTAGES * (zrows * w * _a_stride(_KKC, bf16) * item // 4
                             + _KKC * b_stride)
    else:
        staged = zrows * w * _a_stride(cin, bf16) + _round_up(cin, 16) * b_stride
    return staged + zrows * (w + 2 * p) * _KZS + _KWARPS * _KTC


@dataclass(frozen=True)
class TilePlan:
    """Pass 1's tile: output rows per tile, and whether it streams Cin in
    slices of ``_KKC`` channels."""

    rows: int
    sliced: bool = False


def _tile_fits(rows: int, meta: BlockMeta, bf16: bool, sliced: bool) -> bool:
    # The sliced ring copies 16-byte vectors: 8 bf16 or 4 f32 channels.
    if sliced and (meta.kernel not in (3, 5)
                   or meta.in_channels % (8 if bf16 else 4)
                   or (rows + meta.kernel - 1) * meta.w > _SLICED_POSITIONS):
        return False
    return 4 * _pass1_smem_floats(rows, meta.w, meta.in_channels, meta.kernel,
                                  bf16, sliced) <= _PASS1_SMEM_BUDGET


def tile_plan(meta: BlockMeta, dtype: torch.dtype) -> TilePlan:
    """Pass 1's tile for activations of ``dtype``: the most output rows (up
    to 16) whose staged input of all Cin channels, expanded map and weights
    fit the shared-memory budget; where no row count fits, the most rows of
    the sliced tile (Cin in slices, at most ``_SLICED_POSITIONS`` staged
    positions; built for k 3 and 5 and Cin a multiple of the 16-byte
    vector only)."""
    bf16 = dtype == torch.bfloat16
    for sliced in (False, True):
        for rows in range(min(meta.h, 16), 0, -1):
            if _tile_fits(rows, meta, bf16, sliced):
                return TilePlan(rows, sliced)
    raise ValueError(f"block {meta} does not fit the fused kernel's tiles")


def fused_mbconv(x: torch.Tensor, blk: dict) -> torch.Tensor:
    """Run one stride-1 MBConv block (folded weights as tensors on x's
    device; int8 triples are dequantized to contiguous f32 before the
    launch). x: (P, H, W, Cin) float32 or bfloat16; returns (P, H, W, Cout)
    in x.dtype. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel on ``tile_plan``'s tile or raises."""
    global launches, sliced_launches
    meta: BlockMeta = blk["meta"]
    if meta.stride != 1:
        raise ValueError("fused_mbconv handles stride-1 blocks only")
    if not meta.has_expand:
        raise ValueError("fused_mbconv handles blocks with an expansion only")
    n, h, w, cin = x.shape
    if (h, w, cin) != (meta.h, meta.w, meta.in_channels):
        raise ValueError(
            f"input {tuple(x.shape)} does not match block meta {meta}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"activations must be float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return fused_mbconv_reference(x, blk)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv runs on cpu or cuda, not {x.device}")

    cmid, cout, k = meta.mid_channels, meta.out_channels, meta.kernel
    if k < 1 or k % 2 == 0:
        raise ValueError(f"the fused kernel takes an odd depthwise k, got {k}")
    tensors = _fused_weights(blk)
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "folded weights must be contiguous float32 tensors on the"
                " activations' device (ops.fused_mbconv.to_device)"
            )
    cse = blk["se_reduce"][0].shape[1]
    plan = tile_plan(meta, x.dtype)
    n_tiles = -(-h // plan.rows)
    x = x.contiguous()
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    d = torch.empty((n, h, w, cmid), dtype=torch.float32, device=x.device)
    partial = torch.empty((n, n_tiles, cmid), dtype=torch.float32,
                          device=x.device)
    e = torch.empty((n, cmid), dtype=torch.float32, device=x.device)
    lib = _build.load()
    err = lib.mct_fused_mbconv(
        x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
        n, h, w, cin, cmid, cout, cse, k, int(meta.residual),
        *(t.data_ptr() for t in tensors),
        d.data_ptr(), partial.data_ptr(), e.data_ptr(), plan.rows,
        int(plan.sliced), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "fused_mbconv")
    launches += 1
    sliced_launches += plan.sliced
    return out


# ---------------------------------------------------------------------------
# Folded forward (plain PyTorch around the kernels)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def full_f32():
    """cuDNN convs and cuBLAS matmuls in full float32 (no TF32): the f32
    trunk must match the CPU reference, and TF32 keeps ~3 digits."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _conv1x1(x, w, b, dtype):
    """1x1 conv over NHWC as a matmul over channels, emitting ``dtype``."""
    return torch.matmul(x, w.to(dtype)) + b.to(dtype)


def _conv_nhwc(x, w_oihw, stride, pads, groups, dtype):
    """k x k conv of an NHWC map (run as channels_last NCHW), explicit pads."""
    y = F.conv2d(
        pad_nchw(x.permute(0, 3, 1, 2), pads), w_oihw.to(dtype),
        stride=stride, groups=groups,
    )
    return y.permute(0, 2, 3, 1)


def _dw_taps(z, w_dw, b_dw, kernel, stride, acc_dtype=torch.float32,
             pads=None):
    """Depthwise conv as an explicit tap sum: k^2 (optionally strided)
    slices of the zero-padded input, each scaled by its per-channel tap
    weight, added to an ``acc_dtype`` accumulator that starts at the bias
    (the JAX ``_dw_taps``, stride 2 included). Returns the accumulator in
    ``acc_dtype``."""
    n, h, w, c = z.shape
    if pads is None:
        p = (kernel - 1) // 2
        pads = ((p, p), (p, p))
    s = stride
    (top, bottom), (left, right) = pads
    zp = F.pad(z, (0, 0, left, right, top, bottom))
    h_out = (h - 1) // s + 1
    w_out = (w - 1) // s + 1
    acc = torch.zeros((n, h_out, w_out, c), dtype=acc_dtype,
                      device=z.device) + b_dw.to(acc_dtype)
    for dy in range(kernel):
        for dx in range(kernel):
            tap = zp[:, dy:dy + (h_out - 1) * s + 1:s,
                     dx:dx + (w_out - 1) * s + 1:s, :]
            acc = acc + tap.to(acc_dtype) * w_dw[dy, dx].to(acc_dtype)
    return acc


def _stem_im2col(x, w, b, dtype):
    """The stem (3->C, k3, s2, symmetric pad 1) as explicit im2col: 9
    strided slices concatenated into 27 channels, then one 1x1 matmul,
    bias and SiLU (the JAX ``_stem_im2col``)."""
    n, h = x.shape[:2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    h_out = h // 2
    cols = [
        xp[:, dy:dy + 2 * h_out - 1:2, dx:dx + 2 * h_out - 1:2, :]
        for dy in range(3)
        for dx in range(3)
    ]
    z = torch.cat(cols, dim=-1)  # (N, H/2, W/2, 27)
    wmat = w.reshape(27, -1)  # (ky, kx, cin) row order == the taps'
    return F.silu(_conv1x1(z, wmat, b, dtype)).to(dtype)


def _block_plain(x, blk, dtype, padding_mode: str = "symmetric", *,
                 dw_taps_kernels: tuple = (), dw_pallas_kernels: tuple = ()):
    """One MBConv block with folded weights, plain PyTorch ops around the
    depthwise conv, activations materialized in ``dtype`` (the JAX
    ``_block_xla``).

    The depthwise conv goes, in this order of precedence: to the depthwise
    kernel (``ops/depthwise.py``) when ``meta.kernel`` is in
    ``dw_pallas_kernels`` and the block has stride 1 (it returns ``dtype``,
    bias added in f32 inside); to the tap sum ``_dw_taps`` when the kernel
    size is in ``dw_taps_kernels`` (an f32 accumulator, so SiLU runs in f32
    before the cast); else to cuDNN, with the bias added in ``dtype`` after
    the conv.
    """
    meta: BlockMeta = blk["meta"]
    inp = x
    if meta.has_expand:
        w, b = _wb(blk["expand"], torch.float32)
        z = F.silu(_conv1x1(x, w[0, 0], b, dtype)).to(dtype)
    else:
        z = x
    w_dw, b_dw = _wb(blk["depthwise"], torch.float32)
    k = meta.kernel
    pads = conv_padding(k, meta.stride, z.shape[1], z.shape[2], padding_mode)
    if k in dw_pallas_kernels and meta.stride == 1:
        # Stride-1 odd-k SAME pads are symmetric in both padding modes.
        z = depthwise_conv(z, w_dw, b_dw, kernel=k)
    elif k in dw_taps_kernels:
        z = _dw_taps(z, w_dw, b_dw, k, meta.stride, pads=pads)
    else:
        z = _conv_nhwc(
            z, w_dw.permute(2, 0, 1).unsqueeze(1), meta.stride, pads,
            meta.mid_channels, dtype,
        ) + b_dw.to(dtype)
    z = F.silu(z).to(dtype)
    s = z.float().mean(dim=(1, 2))
    w1, b1 = _wb(blk["se_reduce"], torch.float32)
    w2, b2 = _wb(blk["se_expand"], torch.float32)
    r = F.silu(torch.matmul(s, w1) + b1)
    e = torch.sigmoid(torch.matmul(r, w2) + b2)
    z = (z * e[:, None, None, :].to(dtype)).to(dtype)
    w, b = _wb(blk["project"], torch.float32)
    y = _conv1x1(z, w[0, 0], b, dtype).to(dtype)
    if meta.residual:
        y = y + inp
    return y


def _run_block(x, blk, dtype, *, fused: bool, padding_mode: str,
               dw_taps_kernels: tuple = (), dw_pallas_kernels: tuple = ()):
    """One block under the schedule options (shared by the full forward and
    the prefix/suffix seam)."""
    if fused and fusable(blk["meta"]):
        # Stride-1 odd-k SAME padding is symmetric in both padding modes,
        # so the kernel's (p, p) taps hold for either config.padding.
        return fused_mbconv(x, blk)
    return _block_plain(x, blk, dtype, padding_mode,
                        dw_taps_kernels=dw_taps_kernels,
                        dw_pallas_kernels=dw_pallas_kernels)


def apply_folded_prefix(folded, config, x, n_blocks, *, fused=False,
                        dw_taps_kernels=(), dw_pallas_kernels=(),
                        stem_im2col=False):
    """Stem + the first ``n_blocks`` MBConv blocks of the folded trunk.
    ``stem_im2col`` takes effect for an even input size and symmetric
    padding (its slices bake in a (1, 1) pad), as in the JAX function."""
    dtype = compute_dtype(config)
    mode = config.padding
    with full_f32():
        x = x.to(dtype)
        w, b = _wb(folded["stem"], torch.float32)
        if (stem_im2col and config.stages and x.shape[1] % 2 == 0
                and mode == "symmetric"):
            x = _stem_im2col(x, w, b, dtype)
        else:
            pads = conv_padding(3, 2, x.shape[1], x.shape[2], mode)
            x = _conv_nhwc(x, w.permute(3, 2, 0, 1), 2, pads, 1, dtype)
            x = F.silu(x + b.to(dtype)).to(dtype)
        for blk in folded["blocks"][:n_blocks]:
            x = _run_block(x, blk, dtype, fused=fused, padding_mode=mode,
                           dw_taps_kernels=dw_taps_kernels,
                           dw_pallas_kernels=dw_pallas_kernels)
    return x


def apply_folded_suffix(folded, config, x, n_blocks, *, fused=False,
                        dw_taps_kernels=(), dw_pallas_kernels=()):
    """MBConv blocks ``n_blocks:`` + head + pool + projection -> (N, D) f32."""
    dtype = compute_dtype(config)
    with full_f32():
        x = x.to(dtype)
        for blk in folded["blocks"][n_blocks:]:
            x = _run_block(x, blk, dtype, fused=fused,
                           padding_mode=config.padding,
                           dw_taps_kernels=dw_taps_kernels,
                           dw_pallas_kernels=dw_pallas_kernels)
        w, b = _wb(folded["head"], torch.float32)
        x = F.silu(_conv1x1(x, w[0, 0], b, dtype)).to(dtype)
        x = x.float().mean(dim=(1, 2))
        if folded["proj"] is not None:
            w, b = _wb(folded["proj"], torch.float32)
            x = torch.matmul(x, w) + b
    return x


def apply_folded(folded, config, x, *, fused=False, dw_taps_kernels=(),
                 dw_pallas_kernels=(), stem_im2col=False):
    """Full folded forward: (N, ps, ps, 3) -> (N, feature_dim) float32,
    under the schedule options of ``apply_folded_prefix`` / ``_suffix``."""
    opts = dict(fused=fused, dw_taps_kernels=dw_taps_kernels,
                dw_pallas_kernels=dw_pallas_kernels)
    x = apply_folded_prefix(folded, config, x, 0, stem_im2col=stem_im2col,
                            **opts)
    return apply_folded_suffix(folded, config, x, 0, **opts)
