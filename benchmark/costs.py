"""The benchmark's own count of the work each launch does, and the H100's
published peaks it is held against.

Every count here comes from shapes alone, so it reads the same work
whatever schedule or kernel computes it:

- every input byte is read once, every output byte written once, and the
  weights are read once per launch; a kernel's own scratch is never
  counted;
- FLOPs are two per multiply-add; tensor-core FLOPs (the 1x1 convs, the
  dense layers) run at the activation dtype's tensor-core peak, the rest
  (depthwise taps, squeeze-excite, the crop's affine) at the f32 peak;
- a launch's bound is the longest of bytes over the memory bandwidth,
  tensor-core FLOPs over their peak and other FLOPs over the f32 peak.

The trunk's geometry walk is a copy kept under the benchmark, so a change
to the program cannot move the yardstick.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {
    "bfloat16": 989e12,   # tensor cores, bf16 operands
    "tf32": 495e12,       # tensor cores, f32 operands rounded to TF32
    "float32": 67e12,     # CUDA cores, f32
}
ACT_BYTES = {"bfloat16": 2, "float32": 4}
# The tensor-core peak a 1x1 product with activations of this dtype can
# reach at most: f32 activations go through TF32 (split or not).
TC_PEAK = {"bfloat16": PEAK_FLOPS["bfloat16"], "float32": PEAK_FLOPS["tf32"]}


@dataclass(frozen=True)
class Work:
    """One launch's (or a sum of launches') bytes and FLOPs."""

    bytes: float
    tc_flops: float
    other_flops: float
    dtype: str

    def bound_s(self) -> float:
        """The least time the card could take: the longest unit's."""
        return max(self.bytes / HBM_BYTES_PER_S,
                   self.tc_flops / TC_PEAK[self.dtype],
                   self.other_flops / PEAK_FLOPS["float32"])


@dataclass(frozen=True)
class Block:
    """One MBConv block's geometry for a patch-sized input."""

    in_channels: int
    mid_channels: int
    out_channels: int
    se_channels: int
    kernel: int
    stride: int
    h: int  # input height (= width)

    @property
    def has_expand(self) -> bool:
        return self.mid_channels != self.in_channels

    @property
    def out_h(self) -> int:
        return -(-self.h // self.stride)

    @property
    def fusable(self) -> bool:
        """What the fused-MBConv route takes: stride 1, an expansion, a
        map of at most 56."""
        return self.stride == 1 and self.has_expand and self.h <= 56


def blocks(backbone: dict) -> list[Block]:
    """The trunk's MBConv blocks in order, from a configuration file's
    ``backbone`` sizes."""
    out = []
    in_ch = backbone["stem_channels"]
    h = -(-backbone["patch_size"] // 2)  # the stride-2 stem
    for expand, out_ch, repeats, stride, kernel in backbone["stages"]:
        for i in range(repeats):
            s = stride if i == 0 else 1
            out.append(Block(in_ch, in_ch * expand, out_ch,
                             max(1, int(in_ch * backbone["se_ratio"])),
                             kernel, s, h))
            h = -(-h // s)
            in_ch = out_ch
    return out


def fused_block_work(n: int, blk: Block, dtype: str) -> Work:
    """A stride-1 block with an expansion over ``n`` patches: expand 1x1,
    k x k depthwise, squeeze-excite, project 1x1, residual."""
    if blk.stride != 1:
        raise ValueError("the fused count is for stride-1 blocks")
    hw = blk.h * blk.h
    cin, cmid, cout, cse, k = (blk.in_channels, blk.mid_channels,
                               blk.out_channels, blk.se_channels, blk.kernel)
    act = ACT_BYTES[dtype]
    weights = 4 * (cin * cmid + cmid + k * k * cmid + cmid
                   + cmid * cse + cse + cse * cmid + cmid + cmid * cout + cout)
    return Work(
        bytes=n * hw * (cin + cout) * act + weights,
        tc_flops=2.0 * n * hw * (cin * cmid + cmid * cout),
        other_flops=2.0 * n * (hw * cmid * k * k + 2 * cmid * cse),
        dtype=dtype,
    )


def covered_pixels(h: int, w: int, rowcols: np.ndarray, ps: int) -> int:
    """Pixels of an (h, w) image that the ps x ps patches centred (with
    the ps//2 offset) on ``rowcols`` cover, each counted once."""
    half = ps // 2
    diff = np.zeros((h + 1, w + 1), np.int32)
    for r, c in np.asarray(rowcols, np.int64).reshape(-1, 2):
        r0, c0 = max(r - half, 0), max(c - half, 0)
        r1, c1 = min(r - half + ps, h), min(c - half + ps, w)
        if r0 < r1 and c0 < c1:
            diff[r0, c0] += 1
            diff[r0, c1] -= 1
            diff[r1, c0] -= 1
            diff[r1, c1] += 1
    cover = diff.cumsum(0).cumsum(1)[:h, :w]
    return int(np.count_nonzero(cover))


def crop_work(h: int, w: int, rowcols: np.ndarray, ps: int, dtype: str) -> Work:
    """One image's crop and normalise: the covered pixels read once (at
    most the image), the points read, the patches written, one
    multiply-add per output element."""
    n = len(rowcols)
    read = min(3 * covered_pixels(h, w, rowcols, ps), 3 * h * w) + 8 * n
    written = n * ps * ps * 3 * ACT_BYTES[dtype]
    return Work(bytes=read + written, tc_flops=0.0,
                other_flops=2.0 * n * ps * ps * 3, dtype=dtype)


def trunk_flops_per_patch(backbone: dict) -> float:
    """FLOPs of one patch through the whole trunk: stem, every block
    (expand, depthwise, both SE layers, project), head, projection."""
    s = -(-backbone["patch_size"] // 2)
    stem = backbone["stem_channels"]
    flops = 2 * s * s * 27 * stem
    last = stem
    for blk in blocks(backbone):
        if blk.has_expand:
            flops += 2 * blk.h * blk.h * blk.in_channels * blk.mid_channels
        s = blk.out_h
        flops += 2 * s * s * blk.mid_channels * (blk.kernel ** 2 + blk.out_channels)
        flops += 4 * blk.mid_channels * blk.se_channels
        last = blk.out_channels
    flops += 2 * s * s * last * backbone["head_channels"]
    if backbone["feature_dim"] != backbone["head_channels"]:
        flops += 2 * backbone["head_channels"] * backbone["feature_dim"]
    return float(flops)


def mlp_matmul_params(layers: list[int]) -> int:
    """Weights of the dense layers: what one sample's forward multiplies."""
    return sum(a * b for a, b in zip(layers[:-1], layers[1:]))


def train_flops_per_sample(layers: list[int]) -> float:
    """Forward and backward of one sample: 6 FLOPs per matmul weight."""
    return 6.0 * mlp_matmul_params(layers)
