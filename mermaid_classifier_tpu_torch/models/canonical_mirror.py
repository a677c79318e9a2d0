"""A plain torch EfficientNet with the canonical state_dict names: the
independent side of the backbone diff (``scripts/diff_backbone.py``).

The port's own copy of the JAX package's test mirror
(``tests/parity/torch_efficientnet_ref.py``), built over the port's
``EfficientNetConfig``. It takes NCHW input and names its parameters as
``models/convert.py`` consumes them, so a remapped checkpoint loads into it
as is. Its forward is written apart from ``models/efficientnet.py``'s: it
pads inside ``nn.Conv2d`` for symmetric padding and computes the TF-SAME
pads itself, so the diff compares two executions, not one code path with
itself.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mermaid_classifier_tpu_torch.models.efficientnet import (
    BN_EPS,
    EfficientNetConfig,
)


def _tf_same_pads(kernel: int, stride: int, size: int) -> tuple[int, int]:
    """TensorFlow SAME along one dim: (lo, hi) with the odd pixel at hi."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class MirrorConvBNAct(nn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride=1, groups=1, act=True,
                 padding_mode="symmetric", bn_eps=BN_EPS):
        super().__init__()
        self.tf_same = padding_mode == "tf_same"
        self.kernel = kernel
        self.stride = stride
        self.conv = nn.Conv2d(
            in_ch,
            out_ch,
            kernel,
            stride=stride,
            padding=0 if self.tf_same else (kernel - 1) // 2,
            groups=groups,
            bias=False,
        )
        self.bn = nn.BatchNorm2d(out_ch, eps=bn_eps)
        self.act = act

    def forward(self, x):
        if self.tf_same:
            top, bottom = _tf_same_pads(self.kernel, self.stride, x.shape[2])
            left, right = _tf_same_pads(self.kernel, self.stride, x.shape[3])
            x = F.pad(x, (left, right, top, bottom))
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class MirrorSqueezeExcite(nn.Module):
    def __init__(self, channels, se_channels):
        super().__init__()
        self.reduce = nn.Conv2d(channels, se_channels, 1, bias=True)
        self.expand = nn.Conv2d(se_channels, channels, 1, bias=True)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = F.silu(self.reduce(s))
        return x * torch.sigmoid(self.expand(s))


class MirrorMBConv(nn.Module):
    def __init__(self, in_ch, out_ch, expand_ratio, kernel, stride, se_ratio,
                 padding_mode="symmetric", bn_eps=BN_EPS):
        super().__init__()
        mid = in_ch * expand_ratio
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self.expand = MirrorConvBNAct(in_ch, mid, 1, bn_eps=bn_eps)
        self.depthwise = MirrorConvBNAct(
            mid, mid, kernel, stride=stride, groups=mid,
            padding_mode=padding_mode, bn_eps=bn_eps,
        )
        self.se = MirrorSqueezeExcite(mid, max(1, int(in_ch * se_ratio)))
        self.project = MirrorConvBNAct(mid, out_ch, 1, act=False, bn_eps=bn_eps)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        inp = x
        if self.has_expand:
            x = self.expand(x)
        x = self.depthwise(x)
        x = self.se(x)
        x = self.project(x)
        if self.residual:
            x = x + inp
        return x


class CanonicalMirror(nn.Module):
    """NCHW EfficientNet with the canonical parameter names:
    (N, 3, H, W) -> (N, feature_dim)."""

    def __init__(self, config: EfficientNetConfig | None = None):
        super().__init__()
        cfg = config or EfficientNetConfig()
        self.config = cfg
        self.stem = MirrorConvBNAct(
            3, cfg.stem_channels, 3, stride=2,
            padding_mode=cfg.padding, bn_eps=cfg.bn_eps,
        )
        in_ch = cfg.stem_channels
        for stage_idx, (expand, out_ch, repeats, stride, kernel) in enumerate(
            cfg.stages
        ):
            for block_idx in range(repeats):
                block = MirrorMBConv(
                    in_ch,
                    out_ch,
                    expand,
                    kernel,
                    stride if block_idx == 0 else 1,
                    cfg.se_ratio,
                    padding_mode=cfg.padding,
                    bn_eps=cfg.bn_eps,
                )
                self.add_module(f"stage{stage_idx}_block{block_idx}", block)
                in_ch = out_ch
        self.head = MirrorConvBNAct(in_ch, cfg.head_channels, 1,
                                    bn_eps=cfg.bn_eps)
        if cfg.feature_dim != cfg.head_channels:
            self.feature_projection = nn.Linear(cfg.head_channels, cfg.feature_dim)

    def forward(self, x):
        x = self.stem(x)
        cfg = self.config
        for stage_idx, (_, _, repeats, _, _) in enumerate(cfg.stages):
            for block_idx in range(repeats):
                x = getattr(self, f"stage{stage_idx}_block{block_idx}")(x)
        x = self.head(x)
        x = x.mean((2, 3))
        if cfg.feature_dim != cfg.head_channels:
            x = self.feature_projection(x)
        return x


def randomize_bn_stats(model: nn.Module, seed: int = 0) -> None:
    """Give the BN layers non-trivial running statistics, so a conversion
    diff exercises the mean and variance mapping."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            with torch.no_grad():
                mod.running_mean.copy_(
                    torch.randn(mod.running_mean.shape, generator=gen) * 0.1
                )
                mod.running_var.copy_(
                    torch.rand(mod.running_var.shape, generator=gen) * 0.5 + 0.75
                )
