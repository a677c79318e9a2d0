"""BN-folded EfficientNet trunk and the fused-MBConv CUDA kernel's wrapper.

Port of ``mermaid_classifier_tpu/ops/fused_mbconv.py``:

- ``fold_backbone`` folds every BatchNorm into its conv host-side (numpy, the
  same dict as the JAX function): w' = w * gamma/sqrt(var+eps),
  b' = beta - mean * gamma/sqrt(var+eps). ``to_device`` turns that bundle
  into tensors on one device, once.
- ``apply_folded`` (and its ``_prefix`` / ``_suffix`` halves) is the folded
  forward over NHWC activations in the config's compute dtype. Stem,
  stride-2 blocks and head are plain PyTorch (cuDNN/cuBLAS on the card, run
  with TF32 off). With ``fused=True`` every ``fusable`` block goes through
  ``fused_mbconv`` instead of ``_block_plain``.
- ``fused_mbconv`` runs one stride-1 block: the kernel in
  ``csrc/fused_mbconv.cu`` for a CUDA tensor (its note says what bounds it
  and how it is split at the squeeze-excite mean), the plain version
  ``fused_mbconv_reference`` for a CPU tensor. ``launches`` counts kernel
  launch groups (one per call: expand+depthwise, SE, project).

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

launches = 0

# Shared memory one pass-1 block may take: two blocks fit one SM's 227 KB.
_PASS1_SMEM_BUDGET = 110 * 1024
_KTC, _KWARPS = 32, 8  # csrc/fused_mbconv.cu kTC, kWarps


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


def to_device(folded: dict, device) -> dict:
    """The numpy folded bundle as contiguous float32 tensors on ``device``
    (same nesting; metas kept)."""

    def wb(entry):
        return tuple(
            torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                            device=device)
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


def fused_mbconv_reference(x: torch.Tensor, blk: dict) -> torch.Tensor:
    """Plain PyTorch version of the fused block (stride 1, with an
    expansion), with the kernel's rounding sites: expand + SiLU in f32 then
    cast to x.dtype; depthwise as an f32 tap sum over the zero-padded
    expanded map; SE in f32; m cast to x.dtype; project in f32; residual
    added in f32; cast. (P, H, W, Cin) -> (P, H, W, Cout) in x.dtype."""
    meta: BlockMeta = blk["meta"]
    act = x.dtype
    n, h, w, _ = x.shape
    k = meta.kernel
    p = (k - 1) // 2
    xf = x.float()
    wexp, bexp = blk["expand"]
    z = F.silu(torch.matmul(xf, wexp[0, 0]) + bexp).to(act).float()
    zp = F.pad(z, (0, 0, p, p, p, p))  # zero pad H and W of NHWC
    wdw, bdw = blk["depthwise"]
    acc = torch.zeros_like(z) + bdw
    for dy in range(k):
        for dx in range(k):
            acc = acc + zp[:, dy:dy + h, dx:dx + w, :] * wdw[dy, dx]
    d = F.silu(acc)
    s = d.mean(dim=(1, 2))
    w1, b1 = blk["se_reduce"]
    w2, b2 = blk["se_expand"]
    r = F.silu(torch.matmul(s, w1) + b1)
    e = torch.sigmoid(torch.matmul(r, w2) + b2)
    m = (d * e[:, None, None, :]).to(act).float()
    wproj, bproj = blk["project"]
    y = torch.matmul(m, wproj[0, 0]) + bproj
    if meta.residual:
        y = y + xf
    return y.to(act)


def _pass1_smem_floats(rows: int, w: int, cin: int, k: int) -> int:
    """csrc/fused_mbconv.cu pass1_smem_floats."""
    p = (k - 1) // 2
    zrows = rows + 2 * p
    return (zrows * w * cin + cin * _KTC + zrows * (w + 2 * p) * _KTC
            + k * k * _KTC + _KWARPS * _KTC)


def rows_per_tile(meta: BlockMeta) -> int:
    """Output rows per pass-1 tile: the most (up to 16) whose staged input,
    expanded map and weights fit the shared-memory budget."""
    for rows in range(min(meta.h, 16), 0, -1):
        if 4 * _pass1_smem_floats(rows, meta.w, meta.in_channels,
                                  meta.kernel) <= _PASS1_SMEM_BUDGET:
            return rows
    raise ValueError(f"block {meta} does not fit the fused kernel's tiles")


def fused_mbconv(x: torch.Tensor, blk: dict) -> torch.Tensor:
    """Run one stride-1 MBConv block (folded weights as tensors on x's
    device). x: (P, H, W, Cin) float32 or bfloat16; returns (P, H, W, Cout)
    in x.dtype. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    global launches
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
    tensors = [
        blk["expand"][0][0, 0], blk["expand"][1], *blk["depthwise"],
        *blk["se_reduce"], *blk["se_expand"], blk["project"][0][0, 0],
        blk["project"][1],
    ]
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "folded weights must be contiguous float32 tensors on the"
                " activations' device (ops.fused_mbconv.to_device)"
            )
    cse = blk["se_reduce"][0].shape[1]
    rows = rows_per_tile(meta)
    n_tiles = -(-h // rows)
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
        d.data_ptr(), partial.data_ptr(), e.data_ptr(), rows,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "fused_mbconv")
    launches += 1
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


def _block_plain(x, blk, dtype, padding_mode: str = "symmetric"):
    """One MBConv block with folded weights, plain PyTorch ops, activations
    materialized in ``dtype`` (the JAX ``_block_xla``)."""
    meta: BlockMeta = blk["meta"]
    inp = x
    if meta.has_expand:
        w, b = blk["expand"]
        z = F.silu(_conv1x1(x, w[0, 0], b, dtype)).to(dtype)
    else:
        z = x
    w_dw, b_dw = blk["depthwise"]
    k = meta.kernel
    pads = conv_padding(k, meta.stride, z.shape[1], z.shape[2], padding_mode)
    z = _conv_nhwc(
        z, w_dw.permute(2, 0, 1).unsqueeze(1), meta.stride, pads,
        meta.mid_channels, dtype,
    ) + b_dw.to(dtype)
    z = F.silu(z).to(dtype)
    s = z.float().mean(dim=(1, 2))
    w1, b1 = blk["se_reduce"]
    w2, b2 = blk["se_expand"]
    r = F.silu(torch.matmul(s, w1) + b1)
    e = torch.sigmoid(torch.matmul(r, w2) + b2)
    z = (z * e[:, None, None, :].to(dtype)).to(dtype)
    w, b = blk["project"]
    y = _conv1x1(z, w[0, 0], b, dtype).to(dtype)
    if meta.residual:
        y = y + inp
    return y


def _run_block(x, blk, dtype, *, fused: bool, padding_mode: str):
    if fused and fusable(blk["meta"]):
        # Stride-1 odd-k SAME padding is symmetric in both padding modes,
        # so the kernel's (p, p) taps hold for either config.padding.
        return fused_mbconv(x, blk)
    return _block_plain(x, blk, dtype, padding_mode)


def apply_folded_prefix(folded, config, x, n_blocks, *, fused=False):
    """Stem + the first ``n_blocks`` MBConv blocks of the folded trunk."""
    dtype = compute_dtype(config)
    with full_f32():
        x = x.to(dtype)
        w, b = folded["stem"]
        pads = conv_padding(3, 2, x.shape[1], x.shape[2], config.padding)
        x = _conv_nhwc(x, w.permute(3, 2, 0, 1), 2, pads, 1, dtype)
        x = F.silu(x + b.to(dtype)).to(dtype)
        for blk in folded["blocks"][:n_blocks]:
            x = _run_block(x, blk, dtype, fused=fused,
                           padding_mode=config.padding)
    return x


def apply_folded_suffix(folded, config, x, n_blocks, *, fused=False):
    """MBConv blocks ``n_blocks:`` + head + pool + projection -> (N, D) f32."""
    dtype = compute_dtype(config)
    with full_f32():
        x = x.to(dtype)
        for blk in folded["blocks"][n_blocks:]:
            x = _run_block(x, blk, dtype, fused=fused,
                           padding_mode=config.padding)
        w, b = folded["head"]
        x = F.silu(_conv1x1(x, w[0, 0], b, dtype)).to(dtype)
        x = x.float().mean(dim=(1, 2))
        if folded["proj"] is not None:
            w, b = folded["proj"]
            x = torch.matmul(x, w) + b
    return x


def apply_folded(folded, config, x, *, fused=False):
    """Full folded forward: (N, ps, ps, 3) -> (N, feature_dim) float32.
    ``fused=True`` sends every fusable block through ``fused_mbconv``."""
    x = apply_folded_prefix(folded, config, x, 0, fused=fused)
    return apply_folded_suffix(folded, config, x, 0, fused=fused)
