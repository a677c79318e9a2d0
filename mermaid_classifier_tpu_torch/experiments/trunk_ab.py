"""Full-trunk A/B harness for backbone schedule experiments.

Port of ``mermaid_classifier_tpu/experiments/trunk_ab.py``. A schedule is
timed as the whole chunked extraction trunk (crop + forward per chunk, a
chained scalar carry on the device, one readback per repeat, the median of
the repeats), because a schedule that wins as a single op may lose in
context.

    python -m mermaid_classifier_tpu_torch.experiments.trunk_ab \\
        --schedules folded folded+dwp5 folded+dwp3+dwp5 --numerics-gate

Schedule names: ``flax`` (the port's ``nn.Module`` forward, under the JAX
harness's name), ``folded``, and ``+`` mods on folded: ``+w8`` (int8
weights, ``quantize_folded``), ``+dwp3`` / ``+dwp5`` (the depthwise CUDA
kernel for the stride-1 k3 / k5 convs, ``ops/depthwise.py``), ``+taps5``
(the plain tap-sum k5 depthwise), ``+im2col`` (im2col stem), ``+fused``
(the fused-MBConv CUDA kernel for every fusable block). ``folded+splitN``
runs the stem and the first N blocks per chunk and the rest over all
chunks at once. Devices are explicit (``--device``, default ``cuda``, which
raises where there is no card). Results print as a table; nothing is
persisted.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mermaid_classifier_tpu_torch.models.efficientnet import (
    EfficientNetBackbone,
    EfficientNetConfig,
    compute_dtype,
    init_backbone_params,
    load_jax_variables,
)
from mermaid_classifier_tpu_torch.models.extractor import _resolve_device
from mermaid_classifier_tpu_torch.ops import fused_mbconv as fm
from mermaid_classifier_tpu_torch.ops.patch_ops import (
    channel_scale_bias,
    extract_patches_plain,
)


def _folded_options(schedule: str) -> tuple[dict, bool]:
    """``apply_folded`` keyword arguments and the int8 flag of a folded
    schedule name; unknown names raise ValueError."""
    base, _, rest = schedule.partition("+")
    if base != "folded":
        raise ValueError(f"unknown schedule base {base!r}")
    kwargs: dict = {}
    quantize_w8 = False
    for mod in rest.split("+") if rest else []:
        if mod == "w8":
            quantize_w8 = True
        elif mod in ("dwp5", "dwp3"):
            # Append, so '+dwp3+dwp5' routes both sizes in either order.
            kwargs["dw_pallas_kernels"] = kwargs.get(
                "dw_pallas_kernels", ()) + (int(mod[-1]),)
        elif mod == "taps5":
            kwargs["dw_taps_kernels"] = (5,)
        elif mod == "im2col":
            kwargs["stem_im2col"] = True
        elif mod == "fused":
            kwargs["fused"] = True
        else:
            raise ValueError(f"unknown schedule mod {mod!r}")
    return kwargs, quantize_w8


def build_forward(schedule: str, model, variables, config, *, device):
    """(fwd, weights) for a schedule name; ``fwd(weights, patches)`` maps
    (N, ps, ps, 3) patches to (N, feature_dim) float32 features.

    model: the ``EfficientNetBackbone`` that ``flax`` runs (``variables``
    are loaded into it); the folded schedules fold ``variables`` instead.
    Unknown names raise ValueError.
    """
    if schedule == "flax":
        device = _resolve_device(device)
        load_jax_variables(model, variables)
        module = model.to(device=device, dtype=compute_dtype(config)).eval()

        def fwd_module(weights, patches):
            with fm.full_f32():
                return weights(patches)

        return fwd_module, module

    kwargs, quantize_w8 = _folded_options(schedule)
    device = _resolve_device(device)
    bundle = fm.fold_backbone(variables, config)
    if quantize_w8:
        bundle = fm.quantize_folded(bundle)
    folded = fm.to_device(bundle, device)

    def fwd(weights, patches):
        return fm.apply_folded(weights, config, patches, **kwargs)

    return fwd, folded


def parse_split(schedule: str) -> tuple[str, int | None]:
    """'folded+splitN' -> ('folded', N); any other name -> (name, None)."""
    if "+split" not in schedule:
        return schedule, None
    base, _, tail = schedule.rpartition("+split")
    try:
        split = int(tail)
    except ValueError:
        raise ValueError(
            f"bad schedule {schedule!r}: '+split' must end the schedule with"
            " a block count, e.g. 'folded+split8' (it does not compose with"
            " other mods)."
        ) from None
    if base != "folded":
        raise ValueError(
            f"bad schedule {schedule!r}: '+splitN' composes with the plain"
            " 'folded' base only (no other mods)."
        )
    return base, split


def split_forward(weights, config, chunks, split: int) -> torch.Tensor:
    """The two-phase schedule: stem + blocks ``:split`` per chunk, then
    blocks ``split:`` + head over every chunk's mid tensor at once.
    Returns (sum of chunk sizes, feature_dim) float32."""
    mids = [fm.apply_folded_prefix(weights, config, c, split) for c in chunks]
    return fm.apply_folded_suffix(weights, config, torch.cat(mids), split)


def _test_image(rng, image_size: int, half: int) -> np.ndarray:
    padded = np.zeros((image_size + 2 * half, image_size + 2 * half, 3),
                      np.uint8)
    padded[half:-half, half:-half] = rng.integers(
        0, 256, (image_size, image_size, 3), dtype=np.uint8)
    return padded


def time_trunk(fwd, weights, config, *, device, points=1024, chunk=128,
               iters=6, warmup=2, repeats=3, image_size=1536, split=None):
    """Patch-features/s of the chunked trunk: median over ``repeats`` of
    ``points * iters`` patches over the host clock, each repeat ending in one
    readback of a scalar carried through every chunk; returns
    (median, runs).

    Each chunk is cropped with the plain crop (``extract_patches_plain``,
    as the JAX harness crops with XLA) and run through ``fwd``; with
    ``split=k`` it runs ``split_forward`` at k over the step's chunks
    instead.
    """
    device = _resolve_device(device)
    ps = config.patch_size
    rng = np.random.default_rng(0)
    padded = torch.from_numpy(_test_image(rng, image_size, ps // 2)).to(device)
    scale, bias = (torch.from_numpy(a).to(device)
                   for a in channel_scale_bias(config.mean_rgb, config.std_rgb))
    dtype = compute_dtype(config)
    n_chunks = points // chunk
    if n_chunks < 1:
        raise ValueError(f"points ({points}) must be at least chunk ({chunk})")
    starts = [
        torch.from_numpy(rng.integers(0, image_size, (n_chunks, chunk, 2))
                         .astype(np.int32)).to(device)
        for _ in range(warmup + iters)
    ]

    def crop(starts):
        return extract_patches_plain(padded, starts, ps, scale, bias, dtype)

    def step(prev, starts3):
        if split is None:
            for starts in starts3:
                prev = prev + fwd(weights, crop(starts)).sum()
            return prev
        chunks = [crop(starts) for starts in starts3]
        return prev + split_forward(weights, config, chunks, split).sum()

    with torch.inference_mode():
        acc = torch.zeros((), device=device)
        for i in range(warmup):
            acc = step(acc, starts[i])
        float(acc)
        runs = []
        for _ in range(repeats):
            acc = torch.zeros((), device=device)
            t0 = time.perf_counter()
            for i in range(iters):
                acc = step(acc, starts[warmup + i])
            float(acc)
            runs.append(points * iters / (time.perf_counter() - t0))
    return float(np.median(runs)), runs


def gate_cosine(fwd_ref, w_ref, fwd, weights, config, *, device, chunk=128):
    """Min per-patch feature cosine of ``fwd`` against the reference
    schedule on one chunk of random patches, on the device: the
    reduced-precision gate (pass line 0.999)."""
    device = _resolve_device(device)
    ps = config.patch_size
    rng = np.random.default_rng(7)
    padded = torch.from_numpy(_test_image(rng, 512, ps // 2)).to(device)
    starts = torch.from_numpy(
        rng.integers(0, 512, (chunk, 2)).astype(np.int32)).to(device)
    scale, bias = (torch.from_numpy(a).to(device)
                   for a in channel_scale_bias(config.mean_rgb, config.std_rgb))
    patches = extract_patches_plain(padded, starts, ps, scale, bias,
                                    compute_dtype(config))
    with torch.inference_mode():
        ref = fwd_ref(w_ref, patches).double().cpu().numpy()
        cand = fwd(weights, patches).double().cpu().numpy()
    num = np.sum(ref * cand, axis=1)
    den = np.linalg.norm(ref, axis=1) * np.linalg.norm(cand, axis=1)
    return float(np.min(num / np.maximum(den, 1e-12)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--schedules", nargs="+",
                        default=["folded", "folded+dwp5"])
    parser.add_argument("--points", type=int, default=1024)
    parser.add_argument("--chunk", type=int, default=128)
    parser.add_argument("--iters", type=int, default=6)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' raises where there is no"
                        " card (default cuda)")
    parser.add_argument("--numerics-gate", action="store_true",
                        help="also check every non-first schedule's"
                        " features against the first schedule on the device"
                        " (min per-patch cosine, 0.999 pass line)")
    args = parser.parse_args(argv)

    device = _resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name})")
    config = EfficientNetConfig(compute_dtype=args.dtype)
    variables = init_backbone_params(0, config)
    # Every name is checked before anything runs.
    schedules = [(s, *parse_split(s)) for s in args.schedules]
    for _, base, _ in schedules:
        if base != "flax":
            _folded_options(base)

    results = []
    gate_ref = None  # (fwd, weights) of the first schedule
    for schedule, base, split in schedules:
        fwd, weights = build_forward(base, EfficientNetBackbone(config),
                                     variables, config, device=device)
        if args.numerics_gate and split is None:
            if gate_ref is None:
                gate_ref = (fwd, weights)
            else:
                cos = gate_cosine(gate_ref[0], gate_ref[1], fwd, weights,
                                  config, device=device, chunk=args.chunk)
                verdict = "PASS" if cos >= 0.999 else "FAIL"
                print(f"{schedule:24s} numerics gate vs"
                      f" {args.schedules[0]}: min cosine {cos:.6f}"
                      f" [{verdict}]", flush=True)
        t0 = time.perf_counter()
        pps, runs = time_trunk(
            fwd, weights, config, device=device, points=args.points,
            chunk=args.chunk, iters=args.iters, repeats=args.repeats,
            split=split,
        )
        us = 1e6 / pps
        print(f"{schedule:24s} {us:7.1f} us/patch {pps:10,.0f} p/s"
              f"  runs={[f'{r:,.0f}' for r in runs]}"
              f"  (wall {time.perf_counter() - t0:.0f}s incl. warm-up)",
              flush=True)
        results.append((schedule, pps))
    best = max(results, key=lambda r: r[1])
    print(f"best: {best[0]} at {best[1]:,.0f} p/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
