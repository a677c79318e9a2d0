"""EfficientNet-B0 feature backbone in PyTorch.

Port of ``mermaid_classifier_tpu/models/efficientnet.py``. The config, the
padding rules and the seeded initializer are carried over exactly, so a
weights bundle (the flax ``{"params", "batch_stats"}`` variables as numpy
arrays) means the same network in both packages:

- ``EfficientNetConfig`` has the same fields, ``to_dict`` and ``from_dict``.
- ``init_backbone_params`` builds the flax-layout variables in numpy (HWIO
  conv kernels, (in, out) dense kernels) with the same per-path seeds, so the
  port needs no jax to make the same seeded weights.
- ``EfficientNetBackbone`` is the ``nn.Module`` forward (the counterpart of
  the flax module, ``backbone_impl="module"`` in the extractor). It takes
  NHWC like the flax module and runs NCHW inside; ``load_jax_variables``
  carries a flax-layout bundle into it.

Padding: ``conv_padding`` gives explicit (lo, hi) pads, applied with
``F.pad``, because "tf_same" is asymmetric for stride-2 convs at even sizes
and ``nn.Conv2d`` padding is symmetric.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (expand_ratio, channels, repeats, stride, kernel_size) per stage — B0.
B0_STAGES: tuple[tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

BN_EPS = 1e-3


@dataclass(frozen=True)
class EfficientNetConfig:
    stem_channels: int = 32
    stages: tuple[tuple[int, int, int, int, int], ...] = B0_STAGES
    head_channels: int = 1280
    se_ratio: float = 0.25
    # Trunk compute dtype ("float32" or "bfloat16"); parameters stay f32 and
    # the final pool + projection compute in f32 either way.
    compute_dtype: str = "float32"
    feature_dim: int = 4096
    mean_rgb: tuple[float, float, float] = (0.485, 0.456, 0.406)
    std_rgb: tuple[float, float, float] = (0.229, 0.224, 0.225)
    patch_size: int = 224
    padding: str = "symmetric"
    bn_eps: float = BN_EPS

    def to_dict(self) -> dict:
        return {
            "stem_channels": self.stem_channels,
            "stages": [list(s) for s in self.stages],
            "head_channels": self.head_channels,
            "se_ratio": self.se_ratio,
            "feature_dim": self.feature_dim,
            "mean_rgb": list(self.mean_rgb),
            "std_rgb": list(self.std_rgb),
            "patch_size": self.patch_size,
            "compute_dtype": self.compute_dtype,
            "padding": self.padding,
            "bn_eps": self.bn_eps,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EfficientNetConfig":
        """Config from a (possibly partial) dict; absent fields take the
        defaults, unknown keys raise (a typo must not silently change
        numerics)."""
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(
                f"unknown EfficientNetConfig fields: {sorted(unknown)}"
            )
        kwargs = dict(d)
        if "stages" in kwargs:
            kwargs["stages"] = tuple(tuple(s) for s in kwargs["stages"])
        for key in ("mean_rgb", "std_rgb"):
            if key in kwargs:
                kwargs[key] = tuple(kwargs[key])
        return cls(**kwargs)


def compute_dtype(config: EfficientNetConfig) -> torch.dtype:
    """The trunk's torch dtype for ``config.compute_dtype``."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if config.compute_dtype not in dtypes:
        raise ValueError(
            f"compute_dtype must be float32 or bfloat16, got"
            f" {config.compute_dtype!r}"
        )
    return dtypes[config.compute_dtype]


def _round_filters(channels: int, width_mult: float) -> int:
    if width_mult == 1.0:
        return channels
    scaled = channels * width_mult
    new = max(8, int(scaled + 4) // 8 * 8)
    if new < 0.9 * scaled:
        new += 8
    return new


def _round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


# (width_mult, depth_mult, resolution) per variant.
VARIANT_COEFFS: dict[str, tuple[float, float, int]] = {
    "b0": (1.0, 1.0, 224),
    "b1": (1.0, 1.1, 240),
    "b2": (1.1, 1.2, 260),
    "b3": (1.2, 1.4, 300),
    "b4": (1.4, 1.8, 380),
    "b5": (1.6, 2.2, 456),
    "b6": (1.8, 2.6, 528),
    "b7": (2.0, 3.1, 600),
}


def variant_config(
    variant: str = "b0",
    *,
    feature_dim: int = 4096,
    compute_dtype: str = "float32",
) -> EfficientNetConfig:
    """EfficientNetConfig for a compound-scaled variant (b0..b7)."""
    key = variant.lower().removeprefix("efficientnet").lstrip("-_")
    if key not in VARIANT_COEFFS:
        raise ValueError(
            f"unknown EfficientNet variant {variant!r};"
            f" supported: {sorted(VARIANT_COEFFS)}"
        )
    w, d, res = VARIANT_COEFFS[key]
    stages = tuple(
        (
            expand,
            _round_filters(out_ch, w),
            _round_repeats(repeats, d),
            stride,
            kernel,
        )
        for expand, out_ch, repeats, stride, kernel in B0_STAGES
    )
    return EfficientNetConfig(
        stem_channels=_round_filters(32, w),
        stages=stages,
        head_channels=_round_filters(1280, w),
        feature_dim=feature_dim,
        patch_size=res,
        compute_dtype=compute_dtype,
    )


def conv_padding(
    kernel: int, stride: int, in_h: int, in_w: int, mode: str = "symmetric"
) -> Sequence[tuple[int, int]]:
    """Per-dim (lo, hi) spatial padding for a conv.

    "symmetric": p=(k-1)//2 on both sides. "tf_same": TensorFlow SAME —
    total = max((ceil(in/s)-1)*s + k - in, 0), lo = total//2, hi = rest, so
    stride-2 convs at even sizes pad more on the bottom/right. Both modes
    emit ceil(in/stride) outputs.
    """
    if mode == "symmetric":
        p = (kernel - 1) // 2
        return ((p, p), (p, p))
    if mode == "tf_same":
        pads = []
        for size in (in_h, in_w):
            out = -(-size // stride)
            total = max((out - 1) * stride + kernel - size, 0)
            lo = total // 2
            pads.append((lo, total - lo))
        return tuple(pads)
    raise ValueError(
        f"unknown padding mode {mode!r}; expected 'symmetric' or 'tf_same'"
    )


def pad_nchw(x: torch.Tensor, pads: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Apply conv_padding's ((top, bottom), (left, right)) to an NCHW map."""
    (top, bottom), (left, right) = pads
    return F.pad(x, (left, right, top, bottom))


# ---------------------------------------------------------------------------
# Seeded initializer (numpy, flax layout)
# ---------------------------------------------------------------------------


def _variable_shapes(config: EfficientNetConfig) -> dict:
    """The flax variables' nested layout with leaf shapes, built from the
    config: what ``jax.eval_shape(EfficientNetBackbone.init)`` returns."""

    def cba(cin, cout, k, groups=1):
        return (
            {"conv": {"kernel": (k, k, cin // groups, cout)},
             "bn": {"scale": (cout,), "bias": (cout,)}},
            {"bn": {"mean": (cout,), "var": (cout,)}},
        )

    params: dict = {}
    stats: dict = {}
    params["stem"], stats["stem"] = cba(3, config.stem_channels, 3)
    in_ch = config.stem_channels
    for stage_idx, (expand, out_ch, repeats, _stride, kernel) in enumerate(
        config.stages
    ):
        for block_idx in range(repeats):
            mid = in_ch * expand
            se = max(1, int(in_ch * config.se_ratio))
            p: dict = {}
            s: dict = {}
            if expand != 1:
                p["expand"], s["expand"] = cba(in_ch, mid, 1)
            p["depthwise"], s["depthwise"] = cba(mid, mid, kernel, groups=mid)
            p["se"] = {
                "reduce": {"kernel": (1, 1, mid, se), "bias": (se,)},
                "expand": {"kernel": (1, 1, se, mid), "bias": (mid,)},
            }
            p["project"], s["project"] = cba(mid, out_ch, 1)
            name = f"stage{stage_idx}_block{block_idx}"
            params[name], stats[name] = p, s
            in_ch = out_ch
    params["head"], stats["head"] = cba(in_ch, config.head_channels, 1)
    if config.feature_dim != config.head_channels:
        params["feature_projection"] = {
            "kernel": (config.head_channels, config.feature_dim),
            "bias": (config.feature_dim,),
        }
    return {"batch_stats": stats, "params": params}


def init_backbone_params(seed: int, config: EfficientNetConfig | None = None) -> dict:
    """Seeded flax-layout variables as nested dicts of numpy float32.

    The same values as the JAX package's ``init_backbone_params`` for the
    same integer seed: every leaf is seeded by the crc32 of its flax path
    string (``"['params']['stem']['conv']['kernel']"``) xor the seed;
    kernels get fan-in-scaled normals, biases and BN means zeros, BN scales
    and variances ones.
    """
    config = config or EfficientNetConfig()
    seed = int(seed)

    def materialize(path: str, shape):
        if isinstance(shape, dict):
            return {
                key: materialize(f"{path}['{key}']", sub)
                for key, sub in shape.items()
            }
        terminal = path.rsplit("'", 2)[-2]
        if terminal in ("bias", "mean"):
            return np.zeros(shape, np.float32)
        if terminal in ("scale", "var"):
            return np.ones(shape, np.float32)
        rng = np.random.default_rng(
            (zlib.crc32(path.encode()) ^ (seed & 0xFFFFFFFF)) & 0xFFFFFFFF
        )
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        std = float(np.sqrt(1.0 / max(fan_in, 1)))
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return materialize("", _variable_shapes(config))


# ---------------------------------------------------------------------------
# nn.Module forward (the f32 reference)
# ---------------------------------------------------------------------------


class ConvBNAct(nn.Module):
    """Conv (explicit pad) -> BatchNorm(running stats) -> optional SiLU."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, groups=1, act=True,
                 padding_mode="symmetric", bn_eps=BN_EPS):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        self.padding_mode = padding_mode
        self.conv = nn.Conv2d(
            in_ch, out_ch, kernel, stride=stride, padding=0, groups=groups,
            bias=False,
        )
        self.bn = nn.BatchNorm2d(out_ch, eps=bn_eps)
        self.act = act

    def forward(self, x):
        pads = conv_padding(
            self.kernel, self.stride, x.shape[2], x.shape[3], self.padding_mode
        )
        x = self.bn(self.conv(pad_nchw(x, pads)))
        return F.silu(x) if self.act else x


class SqueezeExcite(nn.Module):
    def __init__(self, channels, se_channels):
        super().__init__()
        self.reduce = nn.Conv2d(channels, se_channels, 1, bias=True)
        self.expand = nn.Conv2d(se_channels, channels, 1, bias=True)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = F.silu(self.reduce(s))
        return x * torch.sigmoid(self.expand(s))


class MBConv(nn.Module):
    def __init__(self, in_ch, out_ch, expand_ratio, kernel, stride, se_ratio,
                 padding_mode="symmetric", bn_eps=BN_EPS):
        super().__init__()
        mid = in_ch * expand_ratio
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self.expand = ConvBNAct(in_ch, mid, 1, bn_eps=bn_eps)
        self.depthwise = ConvBNAct(
            mid, mid, kernel, stride=stride, groups=mid,
            padding_mode=padding_mode, bn_eps=bn_eps,
        )
        self.se = SqueezeExcite(mid, max(1, int(in_ch * se_ratio)))
        self.project = ConvBNAct(mid, out_ch, 1, act=False, bn_eps=bn_eps)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        inp = x
        if self.has_expand:
            x = self.expand(x)
        x = self.project(self.se(self.depthwise(x)))
        return x + inp if self.residual else x


class EfficientNetBackbone(nn.Module):
    """Stem -> MBConv stages -> head conv -> global mean -> projection.

    Input is a normalized (N, H, W, 3) batch (NHWC, like the flax module);
    output is (N, feature_dim) float32. The trunk runs in the parameters'
    dtype; pool and projection run in float32.
    """

    def __init__(self, config: EfficientNetConfig | None = None):
        super().__init__()
        cfg = config or EfficientNetConfig()
        self.config = cfg
        self.stem = ConvBNAct(
            3, cfg.stem_channels, 3, stride=2,
            padding_mode=cfg.padding, bn_eps=cfg.bn_eps,
        )
        in_ch = cfg.stem_channels
        self.block_names: list[str] = []
        for stage_idx, (expand, out_ch, repeats, stride, kernel) in enumerate(
            cfg.stages
        ):
            for block_idx in range(repeats):
                name = f"stage{stage_idx}_block{block_idx}"
                self.add_module(name, MBConv(
                    in_ch, out_ch, expand, kernel,
                    stride if block_idx == 0 else 1, cfg.se_ratio,
                    padding_mode=cfg.padding, bn_eps=cfg.bn_eps,
                ))
                self.block_names.append(name)
                in_ch = out_ch
        self.head = ConvBNAct(in_ch, cfg.head_channels, 1, bn_eps=cfg.bn_eps)
        if cfg.feature_dim != cfg.head_channels:
            self.feature_projection = nn.Linear(
                cfg.head_channels, cfg.feature_dim
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.stem.conv.weight.dtype
        x = x.to(dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW (channels_last)
        x = self.stem(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.head(x)
        x = x.float().mean((2, 3))
        if hasattr(self, "feature_projection"):
            proj = self.feature_projection
            x = F.linear(x, proj.weight.float(), proj.bias.float())
        return x


def _hwio_to_oihw(kernel: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)
    ))


def load_jax_variables(module: EfficientNetBackbone, variables: dict) -> None:
    """Copy a flax-layout variables bundle (numpy) into ``module``.

    Conv kernels HWIO -> OIHW (depthwise (k, k, 1, C) -> (C, 1, k, k)),
    dense (in, out) -> (out, in), BN scale/bias -> weight/bias and
    mean/var -> running stats. Every parameter and buffer of the module
    must be covered, and every leaf of the bundle consumed.
    """
    params, stats = variables["params"], variables["batch_stats"]
    state: dict[str, torch.Tensor] = {}

    def put_cba(prefix, p, s):
        state[f"{prefix}.conv.weight"] = _hwio_to_oihw(p["conv"]["kernel"])
        state[f"{prefix}.bn.weight"] = torch.from_numpy(np.asarray(p["bn"]["scale"], np.float32))
        state[f"{prefix}.bn.bias"] = torch.from_numpy(np.asarray(p["bn"]["bias"], np.float32))
        state[f"{prefix}.bn.running_mean"] = torch.from_numpy(np.asarray(s["bn"]["mean"], np.float32))
        state[f"{prefix}.bn.running_var"] = torch.from_numpy(np.asarray(s["bn"]["var"], np.float32))

    put_cba("stem", params["stem"], stats["stem"])
    for name in module.block_names:
        p, s = params[name], stats[name]
        for part in ("expand", "depthwise", "project"):
            if part in p:
                put_cba(f"{name}.{part}", p[part], s[part])
        for part in ("reduce", "expand"):
            state[f"{name}.se.{part}.weight"] = _hwio_to_oihw(p["se"][part]["kernel"])
            state[f"{name}.se.{part}.bias"] = torch.from_numpy(
                np.asarray(p["se"][part]["bias"], np.float32)
            )
    put_cba("head", params["head"], stats["head"])
    if "feature_projection" in params:
        fp = params["feature_projection"]
        state["feature_projection.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(fp["kernel"], np.float32).T)
        )
        state["feature_projection.bias"] = torch.from_numpy(
            np.asarray(fp["bias"], np.float32)
        )
    own = {k for k in module.state_dict() if not k.endswith("num_batches_tracked")}
    if own != set(state):
        raise ValueError(
            "variables do not match the module: missing"
            f" {sorted(own - set(state))[:5]}, unexpected"
            f" {sorted(set(state) - own)[:5]}"
        )
    module.load_state_dict(state, strict=False)
