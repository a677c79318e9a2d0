"""Plain PyTorch reference of the bulk path: the crop and a frozen
EfficientNet forward, in float32 with TF32 off.

It reads the weights in the flax variables layout the benchmark makes
(``benchmark/weights.py``: HWIO conv kernels, (in, out) dense kernels,
BatchNorm scale, bias, mean and variance) and the sizes of a configuration
file's ``backbone``. It folds each BatchNorm into its conv itself (per
call, so ``calibrate`` can set the statistics first) and runs NCHW
``conv2d`` layers with symmetric padding, as Tan & Le (2019) describe
the network: stem, MBConv blocks (expand, depthwise, squeeze-excite,
project, residual), head, global mean, and the 4096-wide projection.

``precision="fp8"`` is the control: every conv and dense layer takes its
input and its folded weights rounded to float8 e4m3 with a per-tensor
scale (amax / 448), accumulating in f32, the step below the bf16 that the
configurations state.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import no_tf32

FP8_MAX = 448.0




def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with a per-tensor scale, back in f32."""
    amax = t.abs().max()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def crop(image: np.ndarray, rowcols: np.ndarray, ps: int, mean, std) -> torch.Tensor:
    """(P, ps, ps, 3) float32 patches centred (offset ps//2) on each
    (row, col) of an (H, W, 3) uint8 image, zeros outside it, then
    (x / 255 - mean) / std."""
    half = ps // 2
    padded = np.zeros((image.shape[0] + ps, image.shape[1] + ps, 3), np.uint8)
    padded[half:half + image.shape[0], half:half + image.shape[1]] = image
    out = np.stack([padded[r:r + ps, c:c + ps] for r, c in rowcols])
    x = torch.from_numpy(out).to(torch.float32)
    mean = torch.tensor(mean, dtype=torch.float32)
    std = torch.tensor(std, dtype=torch.float32)
    return (x / 255.0 - mean) / std


class EfficientNet:
    """The frozen forward on one device. ``variables`` is the flax-layout
    bundle of numpy arrays; ``backbone`` a configuration file's sizes.

    ``calibrate(patches)`` is how the benchmark makes its weights
    trained-like: it sets every BatchNorm's running mean and variance to
    the batch statistics of its conv's output over ``patches``, layer by
    layer, writing them into ``variables``, so each BN normalises its
    channels as in a trained network."""

    def __init__(self, variables: dict, backbone: dict, device,
                 precision: str = "float32"):
        if backbone.get("padding", "symmetric") != "symmetric":
            raise ValueError("the reference implements symmetric padding")
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision must be float32 or fp8, got {precision!r}")
        self.device = torch.device(device)
        self.fp8 = precision == "fp8"
        self.eps = float(backbone["bn_eps"])
        params, stats = variables["params"], variables["batch_stats"]

        def conv(p, s):
            return {"kernel": torch.from_numpy(np.ascontiguousarray(
                np.asarray(p["conv"]["kernel"], np.float32).transpose(3, 2, 0, 1))
            ).to(self.device), "bn": p["bn"], "stats": s["bn"]}

        def dense(p):
            w = np.asarray(p["kernel"], np.float32)
            w = torch.from_numpy(np.ascontiguousarray(w.reshape(-1, w.shape[-1]).T))
            return (self._w(w), self._w(torch.from_numpy(np.asarray(p["bias"], np.float32))))

        self.stem = conv(params["stem"], variables["batch_stats"]["stem"])
        self.blocks = []
        for si, (expand, _out, repeats, stride, kernel) in enumerate(backbone["stages"]):
            for bi in range(repeats):
                name = f"stage{si}_block{bi}"
                p, s = params[name], stats[name]
                self.blocks.append({
                    "expand": conv(p["expand"], s["expand"]) if "expand" in p else None,
                    "depthwise": conv(p["depthwise"], s["depthwise"]),
                    "se_reduce": dense(p["se"]["reduce"]),
                    "se_expand": dense(p["se"]["expand"]),
                    "project": conv(p["project"], s["project"]),
                    "stride": stride if bi == 0 else 1,
                })
        self.head = conv(params["head"], stats["head"])
        self.proj = (dense(params["feature_projection"])
                     if "feature_projection" in params else None)
        self._calibrating = False

    def _w(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.device, torch.float32)
        return fp8_round(t) if self.fp8 else t

    def _x(self, t: torch.Tensor) -> torch.Tensor:
        return fp8_round(t) if self.fp8 else t

    def _conv(self, x, entry, stride=1, groups=1):
        """conv then BatchNorm with running statistics, as one folded conv
        (the BN scale into the kernel, the rest into a bias)."""
        w = entry["kernel"]
        pad = (w.shape[-1] - 1) // 2
        bn, st = entry["bn"], entry["stats"]
        if self._calibrating:
            y = F.conv2d(x, w, stride=stride, padding=pad, groups=groups)
            st["mean"] = y.mean((0, 2, 3)).cpu().numpy().astype(np.float32)
            st["var"] = y.var((0, 2, 3), unbiased=False).cpu().numpy().astype(np.float32)
        g = (np.asarray(bn["scale"], np.float32)
             / np.sqrt(np.asarray(st["var"], np.float32) + self.eps))
        b = np.asarray(bn["bias"], np.float32) - np.asarray(st["mean"], np.float32) * g
        g = torch.from_numpy(g).to(self.device)
        folded = self._w(w * g[:, None, None, None])
        return F.conv2d(self._x(x), folded, self._w(torch.from_numpy(b)), stride=stride,
                        padding=pad, groups=groups)

    def _dense(self, x, wb):
        w, b = wb
        return F.linear(self._x(x), w, b)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        """(N, ps, ps, 3) f32 normalised patches -> (N, feature_dim) f32."""
        with no_tf32(), torch.no_grad():
            x = patches.to(self.device, torch.float32).permute(0, 3, 1, 2)
            x = F.silu(self._conv(x, self.stem, stride=2))
            for blk in self.blocks:
                inp = x
                if blk["expand"] is not None:
                    x = F.silu(self._conv(x, blk["expand"]))
                x = F.silu(self._conv(x, blk["depthwise"], stride=blk["stride"],
                                      groups=x.shape[1]))
                s = F.silu(self._dense(x.mean((2, 3)), blk["se_reduce"]))
                x = x * torch.sigmoid(self._dense(s, blk["se_expand"]))[:, :, None, None]
                x = self._conv(x, blk["project"])
                if blk["stride"] == 1 and x.shape == inp.shape:
                    x = x + inp
            x = F.silu(self._conv(x, self.head)).mean((2, 3))
            if self.proj is not None:
                x = self._dense(x, self.proj)
            return x

    def features(self, patches: torch.Tensor, block: int = 256) -> torch.Tensor:
        """``forward`` in blocks of ``block`` patches, on the host."""
        return torch.cat([self.forward(patches[i:i + block]).cpu()
                          for i in range(0, len(patches), block)])

    def calibrate(self, patches: torch.Tensor) -> None:
        self._calibrating = True
        try:
            self.forward(patches)
        finally:
            self._calibrating = False
