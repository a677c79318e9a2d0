"""Weights and training rows made from ``--seed`` by the benchmark itself.

Each is drawn on the device by a ``torch.Generator`` in one call, then
cut into leaves: the program and the reference get the same numbers, and
neither made them.

Backbone weights are laid out as the flax variables bundle that the
extractor takes (``{"params", "batch_stats"}``: HWIO conv kernels,
(in, out) dense kernels), with sizes from a configuration file's
``backbone``. The ``init`` section of the file scales them: kernels are
normal with standard deviation ``gain / sqrt(fan_in)``, BatchNorm scales
``bn_gain * (1 + bn_spread * z)`` and biases ``bias_spread * z`` (the
feature projection's bias zero). Then, as training
would leave them, every BatchNorm's running statistics are set to those
of its conv's output over ``calib_patches`` patches of a smooth-field
image drawn from the seed (``reference.EfficientNet.calibrate``), so each
layer's activations are normalised and the features neither vanish nor
blow up, whatever the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def variable_shapes(backbone: dict) -> dict:
    """{"params": ..., "batch_stats": ...} as nested dicts of leaf shapes."""

    def cba(cin, cout, k, groups=1):
        return ({"conv": {"kernel": (k, k, cin // groups, cout)},
                 "bn": {"scale": (cout,), "bias": (cout,)}},
                {"bn": {"mean": (cout,), "var": (cout,)}})

    params, stats = {}, {}
    params["stem"], stats["stem"] = cba(3, backbone["stem_channels"], 3)
    in_ch = backbone["stem_channels"]
    for si, (expand, out_ch, repeats, _stride, kernel) in enumerate(backbone["stages"]):
        for bi in range(repeats):
            mid = in_ch * expand
            se = max(1, int(in_ch * backbone["se_ratio"]))
            p, s = {}, {}
            if expand != 1:
                p["expand"], s["expand"] = cba(in_ch, mid, 1)
            p["depthwise"], s["depthwise"] = cba(mid, mid, kernel, groups=mid)
            p["se"] = {"reduce": {"kernel": (1, 1, mid, se), "bias": (se,)},
                       "expand": {"kernel": (1, 1, se, mid), "bias": (mid,)}}
            p["project"], s["project"] = cba(mid, out_ch, 1)
            params[f"stage{si}_block{bi}"], stats[f"stage{si}_block{bi}"] = p, s
            in_ch = out_ch
    params["head"], stats["head"] = cba(in_ch, backbone["head_channels"], 1)
    if backbone["feature_dim"] != backbone["head_channels"]:
        params["feature_projection"] = {
            "kernel": (backbone["head_channels"], backbone["feature_dim"]),
            "bias": (backbone["feature_dim"],)}
    return {"params": params, "batch_stats": stats}


def _leaves(tree, path=()):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return gen


def backbone_variables(backbone: dict, init: dict, seed: int, device) -> dict:
    """The seeded, calibrated backbone bundle (numpy float32 leaves)."""
    leaves = list(_leaves(variable_shapes(backbone)))
    sizes = [math.prod(shape) for _, shape in leaves]
    flat = torch.randn(sum(sizes), generator=generator(seed, device),
                       device=device).cpu().numpy()
    out: dict = {}
    offset = 0
    for (path, shape), size in zip(leaves, sizes):
        z = flat[offset:offset + size].reshape(shape)
        offset += size
        kind = path[-1]
        if kind == "kernel":
            fan_in = math.prod(shape[:-1])
            gain = init["dense_gain"] if len(shape) == 2 else init["conv_gain"]
            leaf = z * (gain / math.sqrt(fan_in))
        elif kind == "scale":
            leaf = init["bn_gain"] * (1.0 + init["bn_spread"] * z)
        elif kind == "var":
            leaf = 1.0 + init["bn_spread"] * np.abs(z)
        elif path[1] == "feature_projection":
            # Zero: the pooled head features are small beside any drawn
            # bias, which would then be most of every feature row.
            leaf = np.zeros_like(z)
        else:  # bias, mean
            leaf = init["bias_spread"] * z
        _put(out, path, leaf.astype(np.float32))
    calibrate(out, backbone, init, seed, device)
    return out


def calibrate(variables: dict, backbone: dict, init: dict, seed: int, device) -> None:
    """Set the bundle's BatchNorm statistics from ``calib_patches`` patches
    of one smooth-field image drawn from the seed (deterministic cuDNN)."""
    from benchmark.corpus import smooth_field
    from benchmark.reference.efficientnet import EfficientNet, crop

    ps = backbone["patch_size"]
    rng = np.random.default_rng([int(seed), 0xCA1B])
    image = smooth_field(rng, 2 * ps, 2 * ps)
    n = int(init["calib_patches"])
    rowcols = rng.integers(0, 2 * ps, size=(n, 2))
    patches = crop(image, rowcols, ps, backbone["mean_rgb"], backbone["std_rgb"])
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        EfficientNet(variables, backbone, device).calibrate(patches)
    finally:
        torch.backends.cudnn.deterministic = saved


def xavier_head(layers: list[int], seed: int, device) -> tuple[list, list]:
    """Glorot-uniform weights (in, out) and zero biases of an MLP, the
    trainer's ``init="reference"`` distribution, as numpy float32."""
    gen = generator(seed ^ 0x5EED_4EAD, device)
    sizes = [a * b for a, b in zip(layers[:-1], layers[1:])]
    flat = torch.rand(sum(sizes), generator=gen, device=device).cpu().numpy()
    weights, offset = [], 0
    for (fan_in, fan_out), size in zip(zip(layers[:-1], layers[1:]), sizes):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        u = flat[offset:offset + size].reshape(fan_in, fan_out)
        weights.append(((2.0 * u - 1.0) * limit).astype(np.float32))
        offset += size
    biases = [np.zeros(n, np.float32) for n in layers[1:]]
    return weights, biases


def int8_rows(n: int, dim: int, seed: int, device) -> tuple[torch.Tensor, np.ndarray]:
    """``n`` rows of ``dim`` int8 features as ``MermaidTrainer`` stores them
    (per-row absmax / 127 scales: among 4,096 uniform draws every row
    reaches +-127), drawn on the device and returned as a CPU tensor,
    with their f32 scales."""
    gen = generator(seed ^ 0x1A7E_5EED, device)
    q = torch.randint(-127, 128, (n, dim), generator=gen, device=device,
                      dtype=torch.int8)
    scale = (0.5 + torch.rand(n, generator=gen, device=device)) / 127.0
    return q.cpu(), scale.cpu().numpy().astype(np.float32)
