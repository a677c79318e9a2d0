#!/usr/bin/env python3
"""Drive the PyTorch port's serve path, its head-training lane, its
trainer and its full-trunk A/B harness on one CUDA card and check them.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (PATH or /usr/local/cuda/bin) and
``nvidia-smi``; it imports only the port (``mermaid_classifier_tpu_torch``),
torch, numpy and (through the port's calibration) scipy, and exits non-zero
at the first failed phase.

Phases, one output line each:

1. build  — compile every kernel of ``mermaid_classifier_tpu_torch/csrc``.
2. crop   — the crop kernel against its plain version on the card (1536x2048
   image, 25, 32 and 128 points with the corners, f32 and bf16): bitwise
   equal on the raw image at pad ps//2 (the extractor's route) and on the
   host-padded image at pad 0, and the two routes equal to each other.
3. fused  — the fused-MBConv kernel against its plain version for each of the
   11 fusable B0 blocks at 224 px, 128 patches: rel <= 1e-5 at f32 (TF32
   off), rel <= 1e-2 at bf16 (the plain version rounds where the kernel
   does; a sound kernel reads about 3.6e-3).
4. depthwise — the k x k depthwise kernel against its plain version at 128
   patches, f32 and bf16, on the 8 distinct geometries of B0 224's 12
   stride-1 depthwise convs, one odd map (15^2 x 72, k5) and ``DW_EXTRA``
   (13^2 maps, 20 channels, a misaligned view, k 7): bitwise equal.
5. trunk  — full B0 224 extractor (feature_dim 4096, backbone_impl="fused"),
   f32 and bf16, ``verify_device_numerics`` min cosine >= 0.999.
6. serve  — a 4096->500->300->100->80 sigmoid head artifact, 4 AnnotationRun
   requests of 25 points and one of 200 (two backbone chunks) on 1536x2048
   images. Rows sum to 1 within 1e-6, top-N lists are well formed, request 0
   agrees with the f32 nn.Module path on the CPU within 1e-4, and the
   kernels' launch counts equal one crop per request and 11 fused blocks per
   128-patch chunk.
7. times  — the crop three ways at 32 and 128 points, on both routes: the
   whole wrapper and the launch-only entry by CUDA events, and the kernel's
   device time by ``torch.profiler``, each beside its bound. CUDA-event
   times of each kernel and its plain version (per fused block also the
   ``folded`` route's block, cuDNN/cuBLAS with TF32 off, and its three
   passes' device time from ``torch.profiler``; per depthwise geometry
   cuDNN's depthwise conv as the ``folded`` schedule runs it, the kernel's
   share of its bound, its effective GB/s and the
   bit-exact ceiling), each beside its bound; trunk patch-features/s at
   batch 128 (bf16 and f32; fused kernel blocks and plain "folded" blocks),
   p50 latency of a 25-point request and its stages as the extractor runs
   them (raw upload, crop, trunk, head).
8. train  — the head-training lane at production width, 4096 -> (500, 300,
   100) -> 80, ``learning_rate_init`` 1e-4, ``random_state`` 0, auto
   mini-batch 200: seeded features (80 class means plus noise), 40,000
   training rows streamed as 4 ``partial_fit`` chunks of 10,000 per epoch
   for 3 epochs, and 8,000 reference rows. The loss is finite and falls
   epoch over epoch, reference accuracy is >= 0.9; the first chunk, trained
   on the card and on the CPU from the same weights, agrees (loss rel 1e-4,
   each weight matrix 2e-3 relative Frobenius norm, reference
   probabilities 2e-3 max abs: Adam's normalised steps carry rounding
   differences in small gradients into the weights; for scale the phase
   prints each device against itself, the chunk trained again and with
   the network's units permuted, the same sums in other orders); the
   device calibration solve agrees with
   the scipy fits (rtol 2e-3, atol 2e-4); the temperature fit runs;
   ``export_artifact`` passes its 1e-6 gate with the torch pin enforced;
   ``load_predictor(..., device="cuda")`` serves the artifact in one
   25-point ``AnnotationRun`` (rows sum to 1 within 1e-6, one crop launch
   and 11 fused launches). Times: ms per Adam step and rows/s of each
   ``partial_fit`` call (CUDA events, one readback per call) beside the
   step's bound, the chunk's upload, the device's busy share and kernels
   per step during one call (``torch.profiler``), the device and scipy
   calibration solves and the export gate (host clock).
9. trainer — ``MermaidTrainer`` at the same width (classifier mini-batch
   200, trainer batches of 10,000 rows) on 2,240 seeded feature files of 25
   points (80 class means plus noise), split 0.7 / 0.15 / 0.15: resident
   f32 for 3 epochs with early stopping (patience 2) and the device
   calibration solve; val loss finite, ref accuracy >= 0.9; its first
   epoch's weights equal a streamed trainer's epoch bit for bit; calibrated
   val rows sum to 1 within 1e-6. Resident bf16 and int8 for 2 epochs: each
   calibrated model over its stored val rows against the f32 rows, and its
   calibrated val probabilities against the f32 run's, min row cosine >=
   0.999. One 10,000-row ``partial_fit_resident``, the captured step
   against the eager step from the same state: bitwise equal. The f32 run's
   ``export_artifact`` passes its 1e-6 gate, the artifact over the resident
   val rows equals the predictor on the disk rows within 1e-6, and it serves
   a 25-point ``AnnotationRun`` (one crop launch, 11 fused launches).
   Times: ms per Adam step of a resident and of a streamed call (CUDA
   events around one call, one readback) beside the step's bound, device
   events per step and the device's busy share during one resident call
   (``torch.profiler``), each run's ``resident_timings``, and one resident
   epoch over 449,000 seeded int8 rows (1.84 GB staged) in 10,000-row calls.
10. trunk_ab — the full-trunk A/B harness (``experiments.trunk_ab``) at B0
   224, 128-patch chunks, on every schedule of ``AB_SCHEDULES``: in bf16 and
   f32 each schedule's ``gate_cosine`` against ``folded`` is >= 0.999;
   ``time_trunk`` patch-features/s of every schedule in bf16 and of
   ``AB_F32_TIMED`` in f32, with the depthwise and fused launches per chunk
   of each timed run equal to ``AB_PER_CHUNK``; then the harness's CLI
   ``main`` once at 256 points with its numerics gate, which must print no
   ``[FAIL]``.

Then the card's name and power limit (nvidia-smi), one JSON line of kernel
results, and as the last line ``{"ok": true, "device": {...}}``.

A kernel's bound (``bound_ms``) is the least time the card could take for
its work at the shapes of this run: the largest of the bytes it must move
(each input read once, each output written once) over 3.35 TB/s, and, for
each type of operation, those operations over the card's peak rate for
that type (989 TFLOP/s bf16 and 495 TFLOP/s TF32 on the tensor cores, the
f32 products counted as the three TF32 products the fused kernel runs; 67
TFLOP/s f32 on the CUDA cores), from NVIDIA's H100 SXM data sheet. The
memory, the tensor cores and the CUDA cores work at once, so the times are
not added.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
IMAGE_HW = (1536, 2048)
PATCHES = 128
DW_ODD = (15, 72, 5)  # (map, channels, k): odd map, channels not a multiple of 32
# (map, channels, k, misaligned) at 128 patches, reaching the depthwise
# kernel's other instances and masks: a width that is no multiple of its 8
# outputs per thread, 20 channels (no multiple of the 8-channel bf16
# vector), a view not 16-byte aligned (scalar loads) at a B0 geometry, k 7.
DW_EXTRA = ((13, 24, 3, False), (13, 20, 5, False), (14, 480, 5, True),
            (13, 40, 7, False))

AB_SCHEDULES = (
    "flax", "folded", "folded+dwp5", "folded+dwp3+dwp5", "folded+taps5",
    "folded+im2col", "folded+w8", "folded+fused", "folded+fused+dwp3",
    "folded+fused+w8", "folded+split8",
)
AB_F32_TIMED = ("folded", "folded+dwp5", "folded+dwp3+dwp5")
# (depthwise, fused) kernel launches per 128-patch B0 224 chunk; (0, 0) else.
AB_PER_CHUNK = {
    "folded+dwp5": (7, 0), "folded+dwp3+dwp5": (12, 0),
    "folded+fused": (0, 11), "folded+fused+dwp3": (1, 11),
    "folded+fused+w8": (0, 11),
}
AB_POINTS, AB_WARMUP, AB_ITERS, AB_REPEATS = 512, 2, 3, 3


HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {"bf16_tc": 989e12, "tf32_tc": 495e12, "f32": 67e12}


def bound(n_bytes: float, flops: dict) -> tuple[float, float, float]:
    """(bound ms, bytes ms, operations ms) for ``n_bytes`` moved and
    ``flops`` {peak name: operations} done; operations ms is that of the
    unit that takes longest."""
    bytes_ms = n_bytes / HBM_BYTES_S * 1e3
    ops_ms = max(f / PEAK_FLOP_S[kind] for kind, f in flops.items()) * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


def bound_by(bytes_ms: float, ops_ms: float) -> str:
    return "bytes" if bytes_ms >= ops_ms else "operations"


def fused_bound(meta, cse: int, n: int, bf16: bool):
    """Bound of one fused block over n patches: x in and out in the
    activation type, f32 weights; both 1x1 products on the tensor cores
    (bf16, or split TF32 at three products for f32), the depthwise taps and
    the SE products in f32 on the CUDA cores."""
    hw, cin, cmid = meta.h * meta.w, meta.in_channels, meta.mid_channels
    cout, k = meta.out_channels, meta.kernel
    item = 2 if bf16 else 4
    weights = (cin * cmid + cmid * cout + k * k * cmid + 2 * cmid * cse
               + 3 * cmid + cse + cout)
    n_bytes = n * hw * (cin + cout) * item + 4 * weights
    products = 2.0 * n * hw * (cin * cmid + cmid * cout)
    flops = {"bf16_tc": products} if bf16 else {"tf32_tc": 3 * products}
    flops["f32"] = 2.0 * n * (hw * cmid * k * k + 2 * cmid * cse)
    return bound(n_bytes, flops)


def depthwise_bound(h: int, c: int, k: int, n: int, bf16: bool):
    """Bound of one k x k depthwise conv over n maps of h x h x c."""
    item = 2 if bf16 else 4
    n_bytes = 2 * n * h * h * c * item + 4 * (k * k * c + c)
    return bound(n_bytes, {"f32": 2.0 * n * h * h * c * k * k})


def depthwise_ceiling(h: int, c: int, k: int, n: int, bf16: bool) -> float:
    """Least ms of a depthwise conv that keeps the plain version's bits: a
    separate multiply and add per tap (no FMA), so the CUDA cores do half
    the FLOP of their 67 TFLOP/s peak; or the bytes, if they take longer."""
    _, bytes_ms, ops_ms = depthwise_bound(h, c, k, n, bf16)
    return max(bytes_ms, 2 * ops_ms)


def crop_bound(starts, ps: int, bf16: bool, image_hw, pad: int):
    """Bound of the crop: the distinct image pixels the crops cover (u8 x3)
    read once, the patches written once, one multiply-add per output. With
    ``pad`` > 0 the pixels outside the (h, w) image are zeros that are not
    read, so only those inside count."""
    import numpy as np

    h, w = image_hw
    covered = np.zeros((h + 2 * pad, w + 2 * pad), bool)
    for r, c in starts:
        covered[r:r + ps, c:c + ps] = True
    covered = covered[pad:pad + h, pad:pad + w]
    out = len(starts) * ps * ps * 3
    n_bytes = 3 * int(covered.sum()) + out * (2 if bf16 else 4)
    return bound(n_bytes, {"f32": 2.0 * out})


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(line: str) -> None:
    print(line, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def pass_ms(fn, names, iters: int = 5) -> dict:
    """Device milliseconds per call of ``fn`` in each kernel whose name
    holds one of ``names`` (torch.profiler over ``iters`` calls after a
    warm-up); {} if the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        for name in names:
            if name in ev.key and us:
                out[name] = out.get(name, 0.0) + us / iters / 1e3
    return out


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


def perturbed_b0_variables(config):
    """Seeded B0 variables with non-trivial BN statistics, so that folding
    is exercised (the seeded init has identity-like stats)."""
    import numpy as np

    from mermaid_classifier_tpu_torch.models.efficientnet import (
        init_backbone_params,
    )

    variables = init_backbone_params(SEED, config)
    rng = np.random.default_rng(SEED + 1)

    def perturb(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                perturb(val)
            elif key == "mean":
                tree[key] = (rng.standard_normal(val.shape) * 0.1).astype(np.float32)
            elif key == "var":
                tree[key] = (rng.random(val.shape) * 0.5 + 0.75).astype(np.float32)

    perturb(variables["batch_stats"])
    return variables


def crop_images(rng, config):
    """A random IMAGE_HW image on the card, raw and host-padded (ps//2 on
    each side, bottom/right to a multiple of 256, as the extractor padded
    before the pad was folded into the crop)."""
    import numpy as np
    import torch

    h, w = IMAGE_HW
    half = config.patch_size // 2
    hp = -(-(h + 2 * half) // 256) * 256
    wp = -(-(w + 2 * half) // 256) * 256
    image = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    out = np.zeros((hp, wp, 3), np.uint8)
    out[half:half + h, half:half + w] = image
    return torch.from_numpy(image).cuda(), torch.from_numpy(out).cuda()


def points(rng, n: int):
    """n points in the image, the four corners among them."""
    import numpy as np

    h, w = IMAGE_HW
    pts = np.stack([rng.integers(0, h, n), rng.integers(0, w, n)], 1)
    pts[:4] = [[0, 0], [h - 1, w - 1], [0, w - 1], [h - 1, 0]]
    return pts.astype(np.int32)


def phase_build():
    from mermaid_classifier_tpu_torch import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    say(f"build: ok in {time.perf_counter() - t0:.1f} s -> {lib_path.name}")


def phase_crop(config, results):
    import numpy as np
    import torch

    from mermaid_classifier_tpu_torch.ops.patch_crop import extract_patches
    from mermaid_classifier_tpu_torch.ops.patch_ops import (
        channel_scale_bias,
        extract_patches_plain,
    )

    rng = np.random.default_rng(SEED)
    scale, bias = channel_scale_bias(config.mean_rgb, config.std_rgb)
    ps = config.patch_size
    raw, padded = crop_images(rng, config)
    for n in (25, 32, PATCHES):
        starts = points(rng, n)
        for dtype in (torch.float32, torch.bfloat16):
            routes = []
            for image, pad in ((raw, ps // 2), (padded, 0)):
                got = extract_patches(image, starts, ps, scale, bias, dtype,
                                      pad=pad)
                want = extract_patches_plain(
                    image, torch.from_numpy(starts).cuda(), ps,
                    torch.from_numpy(scale).cuda(),
                    torch.from_numpy(bias).cuda(), dtype, pad=pad,
                )
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"crop kernel differs from plain at {n} points {dtype}"
                         f" pad {pad}: max abs"
                         f" {float((got.float() - want.float()).abs().max())}")
                routes.append(got)
            if not torch.equal(*routes):
                fail(f"crop of the raw image at pad {ps // 2} differs from the"
                     f" host-padded crop at {n} points {dtype}")
    results["patch_crop"] = {"max_abs_err": 0.0}
    say(f"crop: kernel == plain bitwise at 25, 32 and {PATCHES} points, f32"
        f" and bf16, raw image at pad {ps // 2} and host-padded at pad 0;"
        " the two routes equal")


def phase_fused(config, folded, results):
    import numpy as np
    import torch

    from mermaid_classifier_tpu_torch.ops import fused_mbconv as fm

    rng = np.random.default_rng(SEED + 2)
    worst_abs = 0.0
    rels = {}
    for i, blk in enumerate(folded["blocks"]):
        meta = blk["meta"]
        if not fm.fusable(meta):
            continue
        x = torch.from_numpy(rng.standard_normal(
            (PATCHES, meta.h, meta.w, meta.in_channels)).astype(np.float32)).cuda()
        for dtype, bound in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            xin = x.to(dtype)
            got = fm.fused_mbconv(xin, blk)
            with fm.full_f32():
                want = fm.fused_mbconv_reference(xin, blk)
            torch.cuda.synchronize()
            rel = rel_err(got, want)
            if not torch.isfinite(got.float()).all() or not rel <= bound:
                fail(f"fused block {i} {meta} {dtype}: rel {rel} > {bound}")
            rels[(i, dtype)] = rel
            worst_abs = max(worst_abs, float((got.float() - want.float()).abs().max()))
    n_blocks = len({i for i, _ in rels})
    if n_blocks != 11:
        fail(f"expected 11 fusable B0 blocks, found {n_blocks}")
    results["fused_mbconv"] = {"max_abs_err": worst_abs}
    f32 = max(r for (_, d), r in rels.items() if d == torch.float32)
    bf16 = max(r for (_, d), r in rels.items() if d == torch.bfloat16)
    say(f"fused: 11 blocks x {PATCHES} patches, max rel f32 {f32:.3e}"
        f" (<= 1e-5), bf16 {bf16:.3e} (<= 1e-2)")


def depthwise_geometries(config):
    """(map, channels, k, blocks) of every distinct stride-1 depthwise conv
    of the trunk, then the odd map (blocks 0: no block of B0 224 has it)."""
    from collections import Counter

    from mermaid_classifier_tpu_torch.ops import fused_mbconv as fm

    counts = Counter((m.h, m.mid_channels, m.kernel)
                     for m in fm.block_metas(config) if m.stride == 1)
    return [(*g, n) for g, n in sorted(counts.items())] + [(*DW_ODD, 0)]


def depthwise_inputs(rng, h, c, k):
    import numpy as np
    import torch

    x = torch.from_numpy(rng.standard_normal((PATCHES, h, h, c)).astype(np.float32)).cuda()
    w = torch.from_numpy((rng.standard_normal((k, k, c)) * 0.2).astype(np.float32)).cuda()
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).cuda()
    return x, w, b


def phase_depthwise(config, results):
    import numpy as np
    import torch

    from mermaid_classifier_tpu_torch.ops import depthwise as dw

    geoms = depthwise_geometries(config)
    if len(geoms) != 9 or sum(g[3] for g in geoms) != 12:
        fail(f"expected 8 distinct stride-1 depthwise geometries in 12 B0"
             f" blocks, found {geoms[:-1]}")
    rng = np.random.default_rng(SEED + 6)
    cases = [(h, c, k, False) for h, c, k, _ in geoms] + list(DW_EXTRA)
    scalar = []
    for h, c, k, misaligned in cases:
        x, w, b = depthwise_inputs(rng, h, c, k)
        for dtype in (torch.float32, torch.bfloat16):
            xin = x.to(dtype)
            if misaligned:  # one element into its storage
                flat = torch.empty(xin.numel() + 1, dtype=dtype, device="cuda")
                xin = flat[1:].view(xin.shape).copy_(xin)
            plan = dw.tile_plan(*xin.shape, k, dtype, xin.data_ptr())
            if not plan.vector_loads:
                scalar.append(f"{h}^2x{c} k{k} {str(dtype)[6:]}")
            got = dw.depthwise_conv(xin, w, b, kernel=k)
            want = dw.depthwise_conv_reference(xin, w, b, kernel=k)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"depthwise kernel differs from plain at {h}^2 x {c} k{k}"
                     f" {dtype} (misaligned {misaligned}, {plan}): max abs"
                     f" {float((got.float() - want.float()).abs().max())}")
    if len(scalar) != 3:
        fail(f"expected 3 scalar-load cases (20 channels bf16, the misaligned"
             f" view in f32 and bf16), got {scalar}")
    results["depthwise_conv"] = {"max_abs_err": 0.0}
    say(f"depthwise: kernel == plain bitwise at {PATCHES} patches, f32 and"
        f" bf16, on " + ", ".join(
            f"{h}^2x{c} k{k}{' misaligned' if m else ''}" for h, c, k, m in cases)
        + f"; scalar-load instance on {', '.join(scalar)}")


TRAIN_HIDDEN, TRAIN_CLASSES, TRAIN_LR = (500, 300, 100), 80, 1e-4
TRAIN_ROWS, TRAIN_CHUNK, TRAIN_EPOCHS, TRAIN_REF_ROWS = 40_000, 10_000, 3, 8_000
TRAIN_MEAN_STD = 0.3  # class means ~ N(0, 0.3^2) per feature, noise N(0, 1)


def train_step_bound(dims, rows: int):
    """Bound of one Adam step of the MLP over ``rows`` rows: forward and
    backward products (the first layer's input gradient is not needed) in
    f32 on the CUDA cores; the bytes are the parameters and both Adam
    moments read and written once, and the batch's rows and labels read."""
    pairs = list(zip(dims[:-1], dims[1:]))
    n_params = sum(a * b + b for a, b in pairs)
    flops = 2.0 * rows * (2 * sum(a * b for a, b in pairs)
                          + sum(a * b for a, b in pairs[1:]))
    n_bytes = 6 * 4 * n_params + rows * (4 * dims[0] + 8)
    return (*bound(n_bytes, {"f32": flops}), flops, n_bytes)


def device_busy(fn):
    """(device ms, device operations, {name: ms} of the three longest by
    total) during one call of ``fn``: kernels and copies on the card, by
    torch.profiler; (None, None, {}) if it saw none."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = Counter()
    spans = 0
    for e in prof.events():
        # A user annotation (the optimizer's step) spans kernels counted
        # on their own.
        if (getattr(e, "device_type", None) == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith("Optimizer.")):
            by_name[e.name[:48]] += e.time_range.elapsed_us() / 1e3
            spans += 1
    if not spans:
        return None, None, {}
    return sum(by_name.values()), spans, dict(by_name.most_common(3))


def train_summary(clf, X_ref):
    """(last loss, weight matrices, X_ref probabilities) of a classifier."""
    return clf.loss_curve_[-1], clf.coefs_, clf.predict_proba(X_ref)


def train_gap(a, b):
    """(loss rel, max relative Frobenius norm of a weight matrix's
    difference, max |dp|) between two train_summary results."""
    import numpy as np

    return (abs(a[0] / b[0] - 1.0),
            max(np.linalg.norm(u - v) / np.linalg.norm(v) for u, v in zip(a[1], b[1])),
            float(np.abs(a[2] - b[2]).max()))


def twin_run(init, names, kw, X, y, X_ref, device, permute):
    """train_summary of the chunk trained again on ``device`` from the same
    weights; with ``permute``, by the same network with its input features
    and hidden units in a seeded other order (the same arithmetic, summed
    in other orders), mapped back to the original order."""
    import numpy as np

    from mermaid_classifier_tpu_torch.train.mlp_classifier import (
        classifier_from_arrays,
    )

    rng = np.random.default_rng(SEED + 8)
    perms = [rng.permutation(w.shape[0]) if permute else np.arange(w.shape[0])
             for w in init.coefs_]
    perms.append(np.arange(init.coefs_[-1].shape[1]))
    twin = classifier_from_arrays(
        [w[perms[i]][:, perms[i + 1]] for i, w in enumerate(init.coefs_)],
        [v[perms[i + 1]] for i, v in enumerate(init.intercepts_)],
        classes=names, device=device, **kw)
    twin.partial_fit(np.ascontiguousarray(X[:, perms[0]]), y)
    inv = [np.argsort(p) for p in perms]
    return (twin.loss_curve_[-1],
            [w[inv[i]][:, inv[i + 1]] for i, w in enumerate(twin.coefs_)],
            twin.predict_proba(np.ascontiguousarray(X_ref[:, perms[0]])))


def train_features(rng, means, n: int):
    """n seeded rows: a class mean plus unit noise, in place."""
    import numpy as np

    y = rng.integers(0, len(means), n)
    X = rng.standard_normal((n, means.shape[1]), dtype=np.float32)
    for s in range(0, n, TRAIN_CHUNK):
        X[s:s + TRAIN_CHUNK] += means[y[s:s + TRAIN_CHUNK]]
    return X, y


def phase_train(extractor, tmp: Path, smi: str):
    import numpy as np
    import torch

    from mermaid_classifier_tpu_torch.inference import (
        export_artifact,
        load_predictor,
    )
    from mermaid_classifier_tpu_torch.ops import fused_mbconv, patch_crop
    from mermaid_classifier_tpu_torch.serve.annotation import AnnotationRun
    from mermaid_classifier_tpu_torch.train.calibration import (
        CalibratedClassifier,
        TemperatureCalibratedClassifier,
    )
    from mermaid_classifier_tpu_torch.train.mlp_classifier import (
        MLPClassifier,
        classifier_from_arrays,
    )

    dim = extractor.config.feature_dim
    rng = np.random.default_rng(SEED + 7)
    means = (rng.standard_normal((TRAIN_CLASSES, dim))
             * TRAIN_MEAN_STD).astype(np.float32)
    names = np.asarray([f"ba-{i:02d}::gf-{i % 7}" for i in range(TRAIN_CLASSES)])
    X, y_idx = train_features(rng, means, TRAIN_ROWS)
    X_ref, ref_idx = train_features(rng, means, TRAIN_REF_ROWS)
    y, y_ref = names[y_idx], names[ref_idx]

    # The port's own seeded init (drawn on the host), carried to each device.
    kw = dict(learning_rate_init=TRAIN_LR, random_state=0)
    init = MLPClassifier(TRAIN_HIDDEN, device="cpu", **kw)
    init.classes_, init.n_features_in_ = np.unique(names), dim
    init._init_params()
    clf = classifier_from_arrays(init.coefs_, init.intercepts_, classes=names,
                                 device="cuda", **kw)
    cpu = classifier_from_arrays(init.coefs_, init.intercepts_, classes=names,
                                 device="cpu", **kw)

    dims = (dim, *TRAIN_HIDDEN, TRAIN_CLASSES)
    b_ms, bytes_ms, ops_ms, flops, n_bytes = train_step_bound(dims, 200)
    steps = -(-TRAIN_CHUNK // 200)
    call_ms = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for epoch in range(TRAIN_EPOCHS):
        for s in range(0, TRAIN_ROWS, TRAIN_CHUNK):
            start.record()
            clf.partial_fit(X[s:s + TRAIN_CHUNK], y[s:s + TRAIN_CHUNK])
            end.record()
            end.synchronize()
            call_ms.append(start.elapsed_time(end))
            if epoch == 0 and s == 0:
                t0 = time.perf_counter()
                cpu.partial_fit(X[:TRAIN_CHUNK], y[:TRAIN_CHUNK])
                cpu_s = time.perf_counter() - t0
                base = train_summary(cpu, X_ref)
                loss_rel, w_rel, p_diff = train_gap(train_summary(clf, X_ref), base)
                ref = {"cpu": base, "cuda": train_summary(clf, X_ref)}
                twin_gaps = {
                    f"{dev}{' permuted' if permute else ' again'}": train_gap(
                        twin_run(init, names, kw, X[:TRAIN_CHUNK], y[:TRAIN_CHUNK],
                                 X_ref, dev, permute), ref[dev])
                    for dev, permute in (("cuda", False), ("cpu", True),
                                         ("cuda", True))}
                if not (loss_rel <= 1e-4 and w_rel <= 2e-3 and p_diff <= 2e-3):
                    fail(f"train: first chunk cuda vs cpu: loss rel {loss_rel:.3e}"
                         f" (<= 1e-4), weight rel Frobenius {w_rel:.3e}, ref proba"
                         f" max |dp| {p_diff:.3e} (each <= 2e-3)")
                say(f"train: first chunk cuda vs cpu from the same weights: loss"
                    f" rel {loss_rel:.3e} (<= 1e-4), max weight rel Frobenius"
                    f" {w_rel:.3e}, ref proba max |dp| {p_diff:.3e} (each <="
                    f" 2e-3); each device against itself, trained again and"
                    f" with every layer's units permuted (the same sums in"
                    f" other orders): "
                    + "; ".join(f"{name} " + ", ".join(f"{v:.3e}" for v in gap)
                                for name, gap in twin_gaps.items())
                    + f"; the cpu chunk took {cpu_s:.1f} s")

    curve = np.asarray(clf.loss_curve_).reshape(TRAIN_EPOCHS, -1)
    epoch_loss = curve.mean(axis=1)
    if not np.isfinite(curve).all() or not np.all(np.diff(epoch_loss) < 0):
        fail(f"train: loss per epoch {epoch_loss.tolist()} is not finite and falling")
    proba_ref = clf.predict_proba(X_ref)
    acc = float(np.mean(clf.classes_[proba_ref.argmax(axis=1)] == y_ref))
    if not acc >= 0.9:
        fail(f"train: reference accuracy {acc:.4f} < 0.9")
    say(f"train: {dims} lr {TRAIN_LR}, {TRAIN_EPOCHS} epochs x"
        f" {TRAIN_ROWS // TRAIN_CHUNK} chunks of {TRAIN_CHUNK} rows, mean loss"
        f" per epoch {[round(float(v), 5) for v in epoch_loss]}, reference"
        f" accuracy {acc:.4f} over {TRAIN_REF_ROWS} rows")

    upload = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    chunk = X[:TRAIN_CHUNK]
    up_ms = []
    for _ in range(4):
        upload[0].record()
        torch.from_numpy(chunk).to("cuda")
        upload[1].record()
        upload[1].synchronize()
        up_ms.append(upload[0].elapsed_time(upload[1]))
    busy_ms, n_ops, top = device_busy(
        lambda: clf.partial_fit(chunk, y[:TRAIN_CHUNK]))
    steady = sorted(call_ms[1:])
    med = steady[len(steady) // 2]
    say(f"time train on: {smi}")
    say(f"time train partial_fit ({TRAIN_CHUNK} rows, {steps} Adam steps of 200):"
        f" first call {call_ms[0]:.3f} ms, median of the other"
        f" {len(steady)} {med:.3f} ms (min {steady[0]:.3f}, max {steady[-1]:.3f}),"
        f" {TRAIN_CHUNK / med * 1e3:.1f} rows/s; per Adam step"
        f" {med / steps:.4f} ms against a bound of {b_ms:.4f} ms"
        f" ({bound_by(bytes_ms, ops_ms)}: {flops / 1e9:.3f} GFLOP f32,"
        f" {n_bytes / 1e6:.1f} MB), {b_ms / (med / steps):.1%} of it; the"
        f" chunk's upload alone {sorted(up_ms)[1]:.3f} ms (CUDA events)")
    if busy_ms is not None:
        say(f"time train one partial_fit (torch.profiler): device busy"
            f" {busy_ms:.3f} ms over {n_ops} kernels and copies,"
            f" {n_ops / steps:.1f} per step, {busy_ms / steps:.4f} ms per step;"
            f" longest by total: " + ", ".join(f"{k} {v:.3f} ms" for k, v in top.items()))
    else:
        say("time train one partial_fit (torch.profiler): device time not measured")

    # Calibration on the reference set: the batched device solve and the
    # scipy fits, which must agree; then the temperature fit.
    cal_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        model = CalibratedClassifier.fit_from_scores(
            clf, proba_ref, y_ref, backend="device", device="cuda")
        cal_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    scipy = CalibratedClassifier.fit_from_scores(clf, proba_ref, y_ref)
    scipy_ms = (time.perf_counter() - t0) * 1e3
    for attr in ("calibration_a_", "calibration_b_"):
        got, want = getattr(model, attr), getattr(scipy, attr)
        if not np.all(np.abs(got - want) <= 2e-4 + 2e-3 * np.abs(want)):
            fail(f"train: device calibration {attr} differs from scipy by"
                 f" {np.abs(got - want).max():.3e} (rtol 2e-3, atol 2e-4)")
    a_rel = float(np.max(np.abs(model.calibration_a_ - scipy.calibration_a_)
                         / np.abs(scipy.calibration_a_)))
    t0 = time.perf_counter()
    temp = TemperatureCalibratedClassifier.fit_from_scores(clf, proba_ref, y_ref)
    temp_ms = (time.perf_counter() - t0) * 1e3
    if not np.isfinite(temp.temperature_):
        fail(f"train: temperature {temp.temperature_}")
    say(f"train: calibration on {TRAIN_REF_ROWS} x {TRAIN_CLASSES}: device solve"
        f" agrees with scipy (max a rel {a_rel:.3e}; rtol 2e-3, atol 2e-4);"
        f" temperature {temp.temperature_:.6f}")
    say(f"time train calibration {TRAIN_REF_ROWS} x {TRAIN_CLASSES} (host clock):"
        f" device solve {sorted(cal_ms)[1]:.3f} ms (median of 3, first"
        f" {cal_ms[0]:.3f}), scipy {scipy_ms:.1f} ms, temperature {temp_ms:.1f} ms")

    art = tmp / "trained"
    t0 = time.perf_counter()
    _, manifest, diff = export_artifact(model, art, X_ref[:2048])
    gate_ms = (time.perf_counter() - t0) * 1e3
    if not diff <= 1e-6:
        fail(f"train: export gate max |dp| {diff}")
    say(f"train: export_artifact gate max |dp| {diff:.3e} (<= 1e-6) on 2048 rows,"
        f" torch pin enforced ({manifest['trained_with']['torch']})")
    say(f"time train export gate (host clock, 2048 rows, files written):"
        f" {gate_ms:.3f} ms")

    predictor = load_predictor(art, device="cuda")
    h, w = IMAGE_HW
    image = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    csv_path = tmp / "points_trained.csv"
    write_points(csv_path, points(rng, 25))
    run = AnnotationRun(image, csv_path, predictor, extractor=extractor)
    patch_crop.launches = fused_mbconv.launches = 0
    run.run()
    launches = (patch_crop.launches, fused_mbconv.launches)
    torch.cuda.synchronize()
    check_run(run, 25, list(names), run.top_n)
    if launches != (1, 11):
        fail(f"train: serving the trained artifact launched (crop, fused)"
             f" {launches}, want (1, 11)")
    say(f"train: the exported artifact serves a 25-point AnnotationRun on the"
        f" card, rows sum to 1, launches crop={launches[0]} fused={launches[1]}")


TRAINER_IMAGES, TRAINER_POINTS = 2_240, 25
TRAINER_BATCH, TRAINER_EPOCHS, TRAINER_LOW_EPOCHS = 10_000, 3, 2
PROD_ROWS = 449_000


def write_trainer_features(tmp: Path, dim: int, names):
    """TRAINER_IMAGES seeded feature files of TRAINER_POINTS points (a class
    mean plus unit noise, as the train phase draws them) and their labels,
    split 0.7 / 0.15 / 0.15 by ``preprocess_labels``."""
    import numpy as np

    from mermaid_classifier_tpu_torch.data.features_io import write_feature_file
    from mermaid_classifier_tpu_torch.data.labels import (
        ImageLabels,
        preprocess_labels,
    )

    rng = np.random.default_rng(SEED + 9)
    means = (rng.standard_normal((len(names), dim)) * TRAIN_MEAN_STD).astype(np.float32)
    rowcols = np.stack([np.arange(TRAINER_POINTS) * 37 + 5,
                        np.arange(TRAINER_POINTS) * 53 + 3], 1).astype(np.int32)
    labels = ImageLabels()
    for i in range(TRAINER_IMAGES):
        y = rng.integers(0, len(names), TRAINER_POINTS)
        x = rng.standard_normal((TRAINER_POINTS, dim), dtype=np.float32) + means[y]
        path = str(tmp / "features" / f"img_{i:05d}.features.npz")
        write_feature_file(path, rowcols, x)
        labels.add_image(path, [(int(r), int(c), names[k])
                                for (r, c), k in zip(rowcols, y)])
    return preprocess_labels(labels, split_ratios=(0.15, 0.15))


def min_row_cosine(a, b) -> float:
    import numpy as np

    num = np.sum(a * b, axis=1)
    den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
    return float(np.min(num / np.maximum(den, 1e-12)))


def same_weights(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(u, v) for u, v in
               zip(a.coefs_ + a.intercepts_, b.coefs_ + b.intercepts_))


def phase_trainer(extractor, tmp: Path, smi: str):
    """MermaidTrainer at the production head's width on seeded feature
    files: resident f32 (its first epoch against a streamed epoch, bit for
    bit), bf16 and int8 against f32, the captured step against the eager
    one, the export gate and a served request, the step times, and one
    resident epoch at the production row count."""
    import copy

    import numpy as np
    import torch

    from mermaid_classifier_tpu_torch.inference import (
        export_artifact,
        load_predictor,
    )
    from mermaid_classifier_tpu_torch.ops import fused_mbconv, patch_crop
    from mermaid_classifier_tpu_torch.serve.annotation import AnnotationRun
    from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier
    from mermaid_classifier_tpu_torch.train.trainer import MermaidTrainer

    class Trainer(MermaidTrainer):
        """Keeps the live classifier, to read its weights after epoch 1."""

        def _make_classifier(self, class_weight):
            self.live = super()._make_classifier(class_weight)
            return self.live

    dim = extractor.config.feature_dim
    names = [f"ba-{i:02d}::gf-{i % 7}" for i in range(TRAIN_CLASSES)]
    t0 = time.perf_counter()
    labels = write_trainer_features(tmp, dim, names)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_val, y_val = labels.val.load_all()
    read_s = time.perf_counter() - t0
    counts = [getattr(labels, s).label_count for s in ("train", "ref", "val")]
    say(f"trainer: {TRAINER_IMAGES} feature files x {TRAINER_POINTS} points"
        f" written and split in {write_s:.1f} s: train / ref / val {counts[0]} /"
        f" {counts[1]} / {counts[2]} rows, {sum(counts) * dim * 4 / 1e9:.3f} GB f32;"
        f" the val rows read back from {len(labels.val)} files in {read_s:.2f} s"
        f" ({read_s / len(labels.val) * 1e3:.3f} ms per file, host clock)")

    kw = dict(batch_size=TRAINER_BATCH, early_stopping_patience=2,
              calibration_backend="device", device="cuda")
    runs, first = {}, {}
    for dtype in ("float32", "bfloat16", "int8"):
        epochs = []
        trainer = Trainer(device_resident=True, resident_dtype=dtype, **kw)

        def on_epoch(m, epochs=epochs, trainer=trainer, dtype=dtype):
            epochs.append(m)
            if dtype == "float32" and m["epoch"] == 0:
                first["clf"] = copy.deepcopy(trainer.live)

        trainer.on_epoch_end = on_epoch
        t1 = time.perf_counter()
        cal, _, msg = trainer(labels, TRAINER_EPOCHS if dtype == "float32"
                              else TRAINER_LOW_EPOCHS, pc_models=[])
        wall = time.perf_counter() - t1
        proba = cal.predict_proba(x_val)
        runs[dtype] = (trainer, cal, msg, proba)
        # The reduced-precision gate: the same calibrated model over its
        # resident (storage-rounded) val rows and over the f32 rows.
        stored = cal.calibrate_scores(cal.estimator.predict_proba_resident(
            np.arange(counts[2]) + counts[0] + counts[1]))
        gate = min_row_cosine(stored, proba)
        if not gate >= 0.999:
            fail(f"trainer {dtype}: resident val rows against f32 rows, min row"
                 f" cosine {gate} (>= 0.999)")
        val_loss = [m["val_loss"] for m in epochs]
        if not (np.isfinite(val_loss).all() and max(msg.ref_accs) >= 0.9):
            fail(f"trainer {dtype}: val loss {val_loss}, ref accuracy {msg.ref_accs}")
        say(f"trainer: resident {dtype}, {len(epochs)} epochs in {wall:.2f} s:"
            f" val loss {[round(v, 6) for v in val_loss]}, ref accuracy"
            f" {[round(a, 4) for a in msg.ref_accs]}, val accuracy {msg.acc:.4f},"
            f" early stop {trainer._early_stop_info['stop_reason']}; calibrated"
            f" val over the stored rows against f32 rows: min row cosine"
            f" {gate:.7f} (>= 0.999)")
        say(f"time trainer resident {dtype} budget (host clock, s, on {smi}):"
            f" {trainer.resident_timings}")
    _, cal32, _, proba32 = runs["float32"]
    sums = float(np.abs(proba32.sum(axis=1) - 1.0).max())
    if not sums <= 1e-6:
        fail(f"trainer: calibrated val rows sum to 1 within {sums}")
    cos = {dt: min_row_cosine(runs[dt][3], proba32) for dt in ("bfloat16", "int8")}
    if not min(cos.values()) >= 0.999:
        fail(f"trainer: calibrated val min row cosine against f32 {cos} (>= 0.999)")

    streamed = Trainer(**kw)
    t1 = time.perf_counter()
    streamed(labels, 1, pc_models=[])
    streamed_s = time.perf_counter() - t1
    if not same_weights(streamed.live, first["clf"]):
        gap = max(np.linalg.norm(u - v) / np.linalg.norm(v) for u, v in
                  zip(streamed.live.coefs_, first["clf"].coefs_))
        fail(f"trainer: the resident first epoch differs from the streamed one"
             f" (max weight rel Frobenius {gap:.3e}); want bitwise")
    say(f"trainer: calibrated val rows sum to 1 within {sums:.2e}; min row"
        f" cosine against f32: bf16 {cos['bfloat16']:.6f}, int8 {cos['int8']:.6f}"
        f" (>= 0.999); the resident f32 first epoch equals a streamed epoch bit"
        f" for bit (the streamed run took {streamed_s:.2f} s)")

    # The captured step against the eager step, from the same state.
    idx, y = next(labels.train.iter_index_batches(batch_size=TRAINER_BATCH))
    captured = copy.deepcopy(cal32.estimator)
    eager = copy.deepcopy(cal32.estimator)
    eager.capture_step = False
    captured.partial_fit_resident(idx, y)
    eager.partial_fit_resident(idx, y)
    if not (same_weights(captured, eager)
            and captured.loss_curve_[-1] == eager.loss_curve_[-1]):
        gap = max(np.linalg.norm(u - v) / np.linalg.norm(v) for u, v in
                  zip(captured.coefs_, eager.coefs_))
        fail(f"trainer: the captured step differs from the eager step (max"
             f" weight rel Frobenius {gap:.3e}); want bitwise")
    say(f"trainer: one {len(idx)}-row partial_fit_resident, captured graph"
        f" against eager steps from the same state: weights, biases and loss"
        f" bitwise equal")

    # Step times: one call with one readback, by CUDA events.
    x_chunk, y_chunk = next(labels.train.load_data_in_batches(TRAINER_BATCH))
    steps = -(-len(idx) // 200)
    dims = (dim, *TRAIN_HIDDEN, TRAIN_CLASSES)
    b_ms, bytes_ms, ops_ms, flops, n_bytes = train_step_bound(dims, 200)
    ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def call_ms(fn, n=7):
        out = []
        for _ in range(n):
            ev[0].record()
            fn()
            ev[1].record()
            ev[1].synchronize()
            out.append(ev[0].elapsed_time(ev[1]))
        return sorted(out)

    res_ms = call_ms(lambda: captured.partial_fit_resident(idx, y))
    eager_ms = call_ms(lambda: eager.partial_fit_resident(idx, y), n=3)
    captured.partial_fit(x_chunk, y_chunk)  # captures the streamed step
    str_ms = call_ms(lambda: captured.partial_fit(x_chunk, y_chunk))
    med = {k: v[len(v) // 2] for k, v in
           (("resident", res_ms), ("streamed", str_ms), ("eager", eager_ms))}
    say(f"time trainer on: {smi}")
    say(f"time trainer step ({len(idx)} rows, {steps} Adam steps of 200, median of"
        f" {len(res_ms)} calls, CUDA events around one call with one readback):"
        f" resident {med['resident'] / steps:.4f} ms per step ({med['resident']:.3f}"
        f" ms per call, min {res_ms[0]:.3f}), streamed {med['streamed'] / steps:.4f}"
        f" ms per step ({med['streamed']:.3f} ms per call with its upload, min"
        f" {str_ms[0]:.3f}), resident eager {med['eager'] / steps:.4f} ms per step;"
        f" bound {b_ms:.4f} ms per step ({bound_by(bytes_ms, ops_ms)}: {flops / 1e9:.3f}"
        f" GFLOP f32, {n_bytes / 1e6:.1f} MB), resident at"
        f" {b_ms / (med['resident'] / steps):.1%} of it")
    busy_ms, n_ops, top = device_busy(lambda: captured.partial_fit_resident(idx, y))
    if busy_ms is not None:
        say(f"time trainer one resident call (torch.profiler): device busy"
            f" {busy_ms:.3f} ms of a {med['resident']:.3f} ms call"
            f" ({busy_ms / med['resident']:.1%}), {n_ops} kernels and copies,"
            f" {n_ops / steps:.1f} per step, {busy_ms / steps:.4f} ms per step;"
            f" longest by total: " + ", ".join(f"{k} {v:.3f} ms" for k, v in top.items()))
    else:
        say("time trainer one resident call (torch.profiler): device time not measured")

    # Export, the gate, the artifact over the resident val rows, one request.
    trainer32 = runs["float32"][0]
    art = tmp / "trainer_artifact"
    _, manifest, diff = export_artifact(cal32, art, x_val[:2048])
    if not diff <= 1e-6:
        fail(f"trainer: export gate max |dp| {diff}")
    predictor = load_predictor(art, device="cuda")
    res_val, gt = trainer32.resident_artifact_val_proba(
        cal32.estimator, labels.val, predictor.head_params.as_tensors("cuda"))
    art_diff = float(np.abs(res_val - predictor.predict_proba(x_val)).max())
    if gt != y_val or not art_diff <= 1e-6:
        fail(f"trainer: artifact over resident val rows max |dp| {art_diff}")
    rng = np.random.default_rng(SEED + 10)
    h, w = IMAGE_HW
    image = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    csv_path = tmp / "points_trainer.csv"
    write_points(csv_path, points(rng, 25))
    run = AnnotationRun(image, csv_path, predictor, extractor=extractor)
    patch_crop.launches = fused_mbconv.launches = 0
    run.run()
    launches = (patch_crop.launches, fused_mbconv.launches)
    torch.cuda.synchronize()
    check_run(run, 25, names, run.top_n)
    if launches != (1, 11):
        fail(f"trainer: serving the artifact launched (crop, fused) {launches},"
             f" want (1, 11)")
    say(f"trainer: export_artifact gate max |dp| {diff:.3e} (<= 1e-6); the"
        f" artifact over the resident val rows against the predictor on disk rows"
        f" {art_diff:.3e}; a 25-point AnnotationRun served, launches"
        f" crop={launches[0]} fused={launches[1]}")
    del runs, first, captured, eager, streamed, trainer32, cal32
    torch.cuda.empty_cache()

    # One resident epoch at the production row count: seeded int8 rows made
    # on the card, brought to the host, staged back (timing only).
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    q = torch.randint(-127, 128, (PROD_ROWS, dim), dtype=torch.int8, device="cuda",
                      generator=gen).cpu()
    scale = (torch.rand(PROD_ROWS, device="cuda", generator=gen) * 0.02 + 0.01).cpu().numpy()
    y_prod = np.asarray(names)[rng.integers(0, len(names), PROD_ROWS)]
    clf = MLPClassifier(TRAIN_HIDDEN, learning_rate_init=TRAIN_LR, random_state=0,
                        device="cuda")
    t1 = time.perf_counter()
    clf.set_resident_features_storage(q, scale)
    stage_s = time.perf_counter() - t1
    order = rng.permutation(PROD_ROWS)
    chunks = [order[s:s + TRAINER_BATCH] for s in range(0, PROD_ROWS, TRAINER_BATCH)]
    clf.partial_fit_resident(chunks[0], y_prod[chunks[0]], classes=names)  # capture
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev[0].record()
    for c in chunks:
        clf.partial_fit_resident(c, y_prod[c])
    ev[1].record()
    ev[1].synchronize()
    epoch_s = time.perf_counter() - t1
    epoch_ms = ev[0].elapsed_time(ev[1])
    n_steps = sum(-(-len(c) // 200) for c in chunks)
    if not np.isfinite(clf.loss_curve_).all():
        fail(f"trainer: production epoch losses {clf.loss_curve_[-3:]}")
    say(f"time trainer production epoch on {smi}: {PROD_ROWS} int8 rows x {dim}"
        f" ({q.numel() / 1e9:.3f} GB + scales) staged in {stage_s:.3f} s; one"
        f" epoch of {len(chunks)} partial_fit_resident calls, {n_steps} Adam steps:"
        f" {epoch_ms / 1e3:.3f} s by CUDA events ({epoch_s:.3f} s host clock),"
        f" {epoch_ms / n_steps:.4f} ms per step against a bound of {b_ms:.4f}")
    del clf, q
    torch.cuda.empty_cache()


def phase_trunk_ab(variables, config, results):
    import contextlib
    import io
    from dataclasses import replace

    from mermaid_classifier_tpu_torch.experiments import trunk_ab as ta
    from mermaid_classifier_tpu_torch.models.efficientnet import (
        EfficientNetBackbone,
    )
    from mermaid_classifier_tpu_torch.ops import depthwise as dw
    from mermaid_classifier_tpu_torch.ops import fused_mbconv as fm
    from mermaid_classifier_tpu_torch.ops import patch_crop

    chunks = (AB_WARMUP + AB_ITERS * AB_REPEATS) * (AB_POINTS // PATCHES)
    dw_total = 0
    for dtype in ("bfloat16", "float32"):
        cfg = replace(config, compute_dtype=dtype)
        built = {}
        for schedule in AB_SCHEDULES:
            base, split = ta.parse_split(schedule)
            fwd, weights = ta.build_forward(base, EfficientNetBackbone(cfg),
                                            variables, cfg, device="cuda")
            if split is not None:
                def fwd(w, p, split=split):  # the seam over two half chunks
                    half = p.shape[0] // 2
                    return ta.split_forward(w, cfg, [p[:half], p[half:]], split)
            built[schedule] = (fwd, weights, split)

        ref = built["folded"][:2]
        worst = (2.0, "")
        for schedule, (fwd, weights, _) in built.items():
            if schedule == "folded":
                continue
            cos = ta.gate_cosine(*ref, fwd, weights, cfg, device="cuda",
                                 chunk=PATCHES)
            if not cos >= 0.999:
                fail(f"trunk_ab {dtype} {schedule}: min cosine vs folded"
                     f" {cos:.6f} < 0.999")
            worst = min(worst, (cos, schedule))
        say(f"trunk_ab {dtype}: {len(built) - 1} schedules vs folded, min"
            f" cosine {worst[0]:.6f} ({worst[1]}) >= 0.999")

        for schedule, (fwd, weights, split) in built.items():
            if dtype == "float32" and schedule not in AB_F32_TIMED:
                continue
            dw.launches = fm.launches = patch_crop.launches = 0
            rate, runs = ta.time_trunk(
                fwd, weights, cfg, device="cuda", points=AB_POINTS, chunk=PATCHES,
                warmup=AB_WARMUP, iters=AB_ITERS, repeats=AB_REPEATS,
                split=split,
            )
            got = (dw.launches, fm.launches, patch_crop.launches)
            want = (*(n * chunks for n in AB_PER_CHUNK.get(schedule, (0, 0))), 0)
            if got != want:
                fail(f"trunk_ab {dtype} {schedule}: launches (depthwise,"
                     f" fused, crop) {got} over {chunks} chunks, want {want}")
            dw_total += got[0]
            say(f"time trunk_ab {dtype} {schedule}: {rate:.1f} patch-features/s"
                f" ({1e6 / rate:.2f} us/patch), runs"
                f" {[round(r, 1) for r in runs]}, launches per chunk"
                f" depthwise {got[0] // chunks} fused {got[1] // chunks}")
    results["depthwise_conv"]["launches"] = dw_total

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ta.main(["--device", "cuda", "--schedules", "folded",
                      "folded+dwp3+dwp5", "folded+fused+w8", "folded+split8",
                      "--points", "256", "--chunk", str(PATCHES), "--iters",
                      "1", "--repeats", "1", "--numerics-gate"])
    text = out.getvalue()
    for line in text.splitlines():
        say(f"trunk_ab cli | {line}")
    if rc != 0 or "[FAIL]" in text or text.count("[PASS]") != 2:
        fail(f"trunk_ab cli: rc {rc}, expected two [PASS] and no [FAIL]")


def phase_trunk(variables, config):
    from dataclasses import replace

    from mermaid_classifier_tpu_torch.models.extractor import build_extractor

    cosines = {}
    for dtype in ("float32", "bfloat16"):
        ext = build_extractor(
            variables, replace(config, compute_dtype=dtype), device="cuda",
            backbone_impl="fused",
        )
        cosines[dtype] = ext.verify_device_numerics()
    say(f"trunk: B0 224 fused, min cosine vs f32 CPU module: f32"
        f" {cosines['float32']:.6f}, bf16 {cosines['bfloat16']:.6f} (>= 0.999)")


def write_head_artifact(out_dir: Path, n_classes: int = 80) -> list[str]:
    import numpy as np

    from mermaid_classifier_tpu_torch.inference import SCHEMA_VERSION
    from mermaid_classifier_tpu_torch.inference.export import save_head_npz
    from mermaid_classifier_tpu_torch.inference.head import HeadParams

    rng = np.random.default_rng(SEED + 3)
    dims = [4096, 500, 300, 100, n_classes]
    weights = [
        (rng.standard_normal((a, b)) * (2.0 / np.sqrt(a))).astype(np.float32)
        for a, b in zip(dims[:-1], dims[1:])
    ]
    biases = [(rng.standard_normal(b) * 0.1).astype(np.float32) for b in dims[1:]]
    a = (-rng.random(n_classes) * 4.0 - 1.0).astype(np.float32)
    b = (rng.standard_normal(n_classes) * 0.5).astype(np.float32)
    classes = [f"ba-{i}::gf-{i % 7}" for i in range(n_classes)]
    save_head_npz(out_dir / "model.npz", HeadParams(weights, biases, a, b))
    (out_dir / "model.json").write_text(json.dumps({
        "schema_version": SCHEMA_VERSION,
        "task": "mermaid_mlp_classifier",
        "classes": classes,
        "input_dim": dims[0],
        "calibration": "sigmoid",
        "config": {"patch_size": 224},
    }))
    return classes


def write_points(path: Path, pts) -> None:
    lines = ["Row,Column,id"] + [f"{r},{c},{i}" for i, (r, c) in enumerate(pts)]
    path.write_text("\n".join(lines) + "\n")


def check_run(run, n: int, classes: list[str], top_n: int) -> None:
    import numpy as np

    proba = run.proba
    if proba is None or proba.shape != (n, len(classes)):
        fail(f"serve: probabilities of shape {None if proba is None else proba.shape}")
    if not np.isfinite(proba).all():
        fail("serve: non-finite probabilities")
    if not np.abs(proba.sum(axis=1) - 1.0).max() <= 1e-6:
        fail(f"serve: row sums off by {np.abs(proba.sum(axis=1) - 1.0).max()}")
    if len(run.predictions) != n:
        fail(f"serve: {len(run.predictions)} predictions for {n} points")
    for pred in run.predictions:
        if (len(pred.labels) != top_n or not set(pred.labels) <= set(classes)
                or pred.scores != sorted(pred.scores, reverse=True)
                or not all(0.0 <= s <= 1.0 for s in pred.scores)):
            fail(f"serve: malformed top-{top_n} {pred}")


def phase_serve(variables, config, results, tmp: Path):
    import numpy as np
    import torch

    from mermaid_classifier_tpu_torch.inference import load_predictor
    from mermaid_classifier_tpu_torch.models.extractor import build_extractor
    from mermaid_classifier_tpu_torch.ops import fused_mbconv, patch_crop
    from mermaid_classifier_tpu_torch.serve.annotation import AnnotationRun

    classes = write_head_artifact(tmp)
    predictor = load_predictor(tmp, device="cuda")
    extractor = build_extractor(variables, config, device="cuda")
    rng = np.random.default_rng(SEED + 4)
    h, w = IMAGE_HW
    requests = []
    for i, n in enumerate((25, 25, 25, 25, 200)):
        image = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        csv_path = tmp / f"points_{i}.csv"
        write_points(csv_path, points(rng, n))
        requests.append((image, csv_path, n))

    runs = [AnnotationRun(image, csv_path, predictor, extractor=extractor)
            for image, csv_path, _ in requests]
    patch_crop.launches = 0
    fused_mbconv.launches = 0
    for run in runs:
        run.run()
    crop_launches = patch_crop.launches
    fused_launches = fused_mbconv.launches
    torch.cuda.synchronize()

    for run, (_, _, n) in zip(runs, requests):
        check_run(run, n, classes, run.top_n)
    chunks = sum(-(-n // extractor.backbone_batch) for _, _, n in requests)
    if crop_launches != len(requests) or fused_launches != 11 * chunks:
        fail(f"serve: {crop_launches} crop launches (want {len(requests)}),"
             f" {fused_launches} fused launches (want {11 * chunks})")
    results["patch_crop"]["launches"] = crop_launches
    results["fused_mbconv"]["launches"] = fused_launches

    # Request 0 again through the f32 nn.Module path on the CPU.
    cpu_run = AnnotationRun(
        requests[0][0], requests[0][1], load_predictor(tmp, device="cpu"),
        extractor=build_extractor(variables, config, device="cpu",
                                  backbone_impl="module"),
    )
    cpu_run.run()
    diff = float(np.abs(cpu_run.proba - runs[0].proba).max())
    if not diff <= 1e-4:
        fail(f"serve: request 0 differs from the CPU module path by {diff}")
    say(f"serve: 5 requests ({', '.join(str(n) for *_, n in requests)} points),"
        f" rows sum to 1, launches crop={crop_launches}"
        f" fused={fused_launches}, max |dp| vs CPU f32 module {diff:.2e}")
    return extractor, runs[0]


def phase_times(config, folded, results, extractor, run25, smi):
    from dataclasses import replace

    import numpy as np
    import torch

    from mermaid_classifier_tpu_torch.models.extractor import build_extractor
    from mermaid_classifier_tpu_torch.ops import depthwise as dw
    from mermaid_classifier_tpu_torch.ops import fused_mbconv as fm
    from mermaid_classifier_tpu_torch.ops import patch_crop
    from mermaid_classifier_tpu_torch.ops.patch_crop import extract_patches
    from mermaid_classifier_tpu_torch.ops.patch_ops import (
        channel_scale_bias,
        extract_patches_plain,
    )

    say(f"times on: {smi}")
    rng = np.random.default_rng(SEED + 5)
    ps = config.patch_size
    scale, bias = channel_scale_bias(config.mean_rgb, config.std_rgb)
    affine = (*map(float, scale), *map(float, bias))
    raw, padded = crop_images(rng, config)
    scale_dev, bias_dev = torch.from_numpy(scale).cuda(), torch.from_numpy(bias).cuda()
    # The crop three ways: the whole wrapper (host starts: validation,
    # allocation, upload and launch) and the launch-only entry (device
    # starts, preallocated output) by CUDA events, and the kernel's device
    # time by torch.profiler; at the serve shape (point_bucket, 32) and at
    # a backbone chunk (128); on the extractor's route (raw image, pad
    # ps//2) and on a host-padded image at pad 0.
    for n in (extractor.point_bucket, PATCHES):
        starts = points(rng, n)
        starts_dev = torch.from_numpy(starts).cuda()
        for image, pad in ((raw, ps // 2), (padded, 0)):
            route = "raw" if pad else "padded"
            for dtype in (torch.float32, torch.bfloat16):
                out = torch.empty((n, ps, ps, 3), dtype=dtype, device="cuda")

                def launch():
                    patch_crop.launch(image, starts_dev, out, affine, pad)

                w_ms = cuda_ms(lambda: extract_patches(image, starts, ps, scale,
                                                       bias, dtype, pad=pad))
                l_ms = cuda_ms(launch)
                d_ms = pass_ms(launch, ("crop_kernel",), iters=20).get("crop_kernel")
                p_ms = cuda_ms(lambda: extract_patches_plain(
                    image, starts_dev, ps, scale_dev, bias_dev, dtype, pad=pad))
                b_ms, bytes_ms, ops_ms = crop_bound(
                    starts, ps, dtype == torch.bfloat16, image.shape[:2], pad)
                say(f"time crop {n} points {route} pad {pad} {str(dtype)[6:]}:"
                    f" wrapper {w_ms:.4f} ms, launch {l_ms:.4f} ms, device "
                    + (f"{d_ms:.4f} ms ({b_ms / d_ms:.1%} of bound)" if d_ms
                       else "not measured")
                    + f", plain {p_ms:.4f} ms, bound {b_ms:.4f} ms"
                    f" ({bound_by(bytes_ms, ops_ms)})")
                if n == PATCHES and pad and dtype == extractor.dtype:
                    results["patch_crop"].update(
                        ms=d_ms or l_ms, plain_ms=p_ms, bound_ms=b_ms,
                        bound_by=bound_by(bytes_ms, ops_ms), library_ms=None)

    # Fused blocks: the kernel (and its three passes' device time), its
    # plain version, the "folded" route's block (cuDNN/cuBLAS, TF32 off) and
    # the bound; then the 11-block sums.
    passes = ("expand_dw_kernel", "se_kernel", "project_kernel")
    for dtype in (torch.float32, torch.bfloat16):
        sums = [0.0] * 6  # kernel, plain, folded, bound, bytes, operations
        pass_sums = dict.fromkeys(passes, 0.0)
        for i, blk in enumerate(folded["blocks"]):
            meta = blk["meta"]
            if not fm.fusable(meta):
                continue
            x = torch.from_numpy(rng.standard_normal(
                (PATCHES, meta.h, meta.w, meta.in_channels)).astype(np.float32)
            ).cuda().to(dtype)
            k_ms = cuda_ms(lambda: fm.fused_mbconv(x, blk), iters=10)
            with fm.full_f32():
                p_ms = cuda_ms(lambda: fm.fused_mbconv_reference(x, blk), iters=10)
                f_ms = cuda_ms(lambda: fm._block_plain(x, blk, dtype), iters=10)
            b = fused_bound(meta, blk["se_reduce"][0].shape[1], PATCHES,
                            dtype == torch.bfloat16)
            by_pass = pass_ms(lambda: fm.fused_mbconv(x, blk), passes)
            sums = [s + t for s, t in zip(sums, (k_ms, p_ms, f_ms, *b))]
            for name in passes:
                pass_sums[name] += by_pass.get(name, float("nan"))
            say(f"time fused block {i} ({meta.h}^2 {meta.in_channels}->"
                f"{meta.mid_channels}->{meta.out_channels} k{meta.kernel})"
                f" {str(dtype)[6:]}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms,"
                f" folded {f_ms:.4f} ms, bound {b[0]:.4f} ms"
                f" ({bound_by(*b[1:])}); passes (profiler) " + ", ".join(
                    f"{name} {by_pass[name]:.4f}" if name in by_pass
                    else f"{name} not measured" for name in passes))
        say(f"time fused 11 blocks {str(dtype)[6:]}: kernel {sums[0]:.4f} ms,"
            f" plain {sums[1]:.4f} ms, folded {sums[2]:.4f} ms, bound"
            f" {sums[3]:.4f} ms ({bound_by(*sums[4:])}); passes (profiler) "
            + ", ".join(f"{name} {v:.4f}" for name, v in pass_sums.items()))
        if dtype == extractor.dtype:
            results["fused_mbconv"].update(
                ms=sums[0], plain_ms=sums[1], bound_ms=sums[3],
                bound_by=bound_by(*sums[4:]), library_ms=None)

    # Depthwise per geometry: the kernel, its plain version, and cuDNN's
    # grouped conv plus bias as the "folded" schedule runs it. The sums
    # weight each geometry by its count among B0 224's 12 stride-1 blocks.
    for dtype in (torch.float32, torch.bfloat16):
        # kernel, plain, cuDNN, bound, bytes, operations, bit-exact ceiling
        sums = [0.0] * 7
        for h, c, k, blocks in depthwise_geometries(config):
            x, w, b = depthwise_inputs(rng, h, c, k)
            x = x.to(dtype)
            w_oihw = w.permute(2, 0, 1).unsqueeze(1).contiguous()
            pads = ((k - 1) // 2,) * 2
            with fm.full_f32():
                times = (
                    cuda_ms(lambda: dw.depthwise_conv(x, w, b, kernel=k)),
                    cuda_ms(lambda: dw.depthwise_conv_reference(x, w, b, kernel=k),
                            iters=5),
                    cuda_ms(lambda: fm._conv_nhwc(x, w_oihw, 1, (pads, pads), c,
                                                  dtype) + b.to(dtype)),
                )
            bf16 = dtype == torch.bfloat16
            b = depthwise_bound(h, c, k, PATCHES, bf16)
            ceil_ms = depthwise_ceiling(h, c, k, PATCHES, bf16)
            sums = [s + blocks * t
                    for s, t in zip(sums, (*times, *b, ceil_ms))]
            say(f"time depthwise {h}^2x{c} k{k} ({blocks} B0 blocks)"
                f" {str(dtype)[6:]}: kernel {times[0]:.4f} ms, plain"
                f" {times[1]:.4f} ms, cuDNN {times[2]:.4f} ms, bound"
                f" {b[0]:.4f} ms ({bound_by(*b[1:])}), bit-exact ceiling"
                f" {ceil_ms:.4f} ms; kernel at {b[0] / times[0]:.1%} of its"
                f" bound, {b[1] / times[0] * HBM_BYTES_S / 1e9:.1f} GB/s")
        say(f"time depthwise 12 B0 blocks {str(dtype)[6:]}: kernel"
            f" {sums[0]:.4f} ms, plain {sums[1]:.4f} ms, cuDNN {sums[2]:.4f} ms,"
            f" bound {sums[3]:.4f} ms ({bound_by(*sums[4:6])}), bit-exact"
            f" ceiling {sums[6]:.4f} ms; kernel at {sums[3] / sums[0]:.1%} of"
            f" its bound, {sums[4] / sums[0] * HBM_BYTES_S / 1e9:.1f} GB/s")
        if dtype == extractor.dtype:
            results["depthwise_conv"].update(
                ms=sums[0], plain_ms=sums[1], bound_ms=sums[3],
                bound_by=bound_by(*sums[4:6]), library_ms=sums[2])

    patches = torch.from_numpy(
        rng.random((PATCHES, ps, ps, 3)).astype(np.float32)).cuda()
    for dtype in ("bfloat16", "float32"):
        for impl in ("fused", "folded"):
            trunk = build_extractor(
                extractor.variables, replace(config, compute_dtype=dtype),
                device="cuda", backbone_impl=impl,
            )
            x = patches.to(trunk.dtype)
            with torch.inference_mode():
                trunk_ms = cuda_ms(lambda: trunk._forward(x), iters=10)
            say(f"time trunk {dtype} {impl} batch {PATCHES}: {trunk_ms:.3f} ms,"
                f" {PATCHES / trunk_ms * 1e3:.1f} patch-features/s")

    lat = []
    for i in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run25.run()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = sorted(lat[3:])
    say(f"time request 25 points f32 fused: p50 {lat[len(lat) // 2]:.3f} ms,"
        f" min {lat[0]:.3f} ms, max {lat[-1]:.3f} ms over {len(lat)} runs")

    # The same request by stage as the extractor runs it, synchronizing
    # after each (host clock).
    image = run25.load_image()
    rowcols = extractor._validate_rowcols(image, run25.points.rowcols())
    stages = {"upload": [], "crop": [], "trunk": [], "head": []}

    def staged():
        marks = [time.perf_counter()]
        dev = extractor._upload(image)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        patches = extractor._crop(dev, rowcols)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        feats = extractor.features_for_patches_device(patches)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        run25.predictor.predict_proba(feats)
        marks.append(time.perf_counter())
        for name, t0, t1 in zip(stages, marks, marks[1:]):
            stages[name].append((t1 - t0) * 1e3)

    for _ in range(23):
        staged()
    say("time request 25 points by stage (p50 ms): " + ", ".join(
        f"{name} {sorted(v[3:])[len(v[3:]) // 2]:.3f}" for name, v in stages.items()))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    from mermaid_classifier_tpu_torch.models.efficientnet import EfficientNetConfig
    from mermaid_classifier_tpu_torch.ops import fused_mbconv as fm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    config = EfficientNetConfig()
    results = {}
    phase_build()
    phase_crop(config, results)
    variables = perturbed_b0_variables(config)
    folded = fm.to_device(fm.fold_backbone(variables, config), "cuda")
    phase_fused(config, folded, results)
    phase_depthwise(config, results)
    phase_trunk(variables, config)
    with tempfile.TemporaryDirectory() as tmp:
        extractor, run25 = phase_serve(variables, config, results, Path(tmp))
        # The kernels' profiler readings come before any CUDA graph is
        # profiled: after the training phases traced graph replays, later
        # profiles in the process read device times below the kernels'
        # bounds (PERF.md, the training lane).
        phase_times(config, folded, results, extractor, run25, smi)
        phase_train(extractor, Path(tmp), smi)
        phase_trainer(extractor, Path(tmp), smi)
        phase_trunk_ab(variables, config, results)

    sources = {
        "patch_crop": ("mermaid_classifier_tpu_torch/csrc/patch_crop.cu",
                       "mermaid_classifier_tpu/experiments/pallas_crop.py:72"),
        "fused_mbconv": ("mermaid_classifier_tpu_torch/csrc/fused_mbconv.cu",
                         "mermaid_classifier_tpu/ops/fused_mbconv.py:424"),
        "depthwise_conv": ("mermaid_classifier_tpu_torch/csrc/depthwise.cu",
                           "mermaid_classifier_tpu/ops/depthwise.py:65"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **{key: results[name][key]
            for key in ("launches", "max_abs_err", "ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms")}}
        for name, (src, rep) in sources.items()
    ]
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
