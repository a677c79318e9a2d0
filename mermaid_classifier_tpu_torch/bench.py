"""Bench: the port's patch-feature throughput and its neighbouring legs on one
device, reported as one JSON payload and a compact headline line.

Run as ``python -m mermaid_classifier_tpu_torch.bench`` (``--device``
defaults to ``cuda``; a CUDA device without a card raises, there is no
fallback to the CPU; ``--device cpu`` exists for the tests). Every leg runs
at the production width: B0 at 224 px giving 4096-d features, and the head
4096 -> (500, 300, 100) -> 80.

Before anything is timed, a numerics gate runs 8 seeded probe patches
through the f32 ``module`` forward (TF32 off) and through the trunk the
device loop times; a min cosine below 0.999 exits 1 with the reading.

Legs, in order:

- **device loop** (``patch_features_per_sec``): one raw image on the device,
  each step one crop-kernel launch over ``--points`` starts with the zero
  pad folded in (``ops/patch_crop.py``, the extractor's route), then the
  trunk in chunks of ``--chunk``; each step's feature sum chained into a
  scalar carry, ``--iters`` steps per repeat timed by CUDA events, the
  median of ``--repeats``. The roofline models the trunk's activation bytes
  and FLOPs per patch from its geometry against the achieved rate.
- **bucket** (``bucket_patches_per_sec``): synthetic JPEGs in a local store
  through ``FeatureBucketBuilder`` (decode-ahead, the device pipeline, the
  writer), ``--repeats`` + 1 runs into distinct target buckets, run 0
  discarded. The stage budget times one image's decode, raw upload, feature
  readback and store write.
- **annotate** (``annotate_latency_ms``): one JPEG, 25 points, decode ->
  extractor -> calibrated head, with an in-process replay through the f32
  ``module`` extractor on the CPU (features by cosine, head logits by their
  largest gap).
- **train** (``train_samples_per_sec``): resident head training, epoch 0
  (the step's capture) excluded.
- **serve** (``serve_rows_per_sec``): the calibrated head over a device
  batch, repeated calls and one readback.
- **quality**: ``scripts/quality_parity_bench.py`` as a subprocess, against
  sklearn where it imports, else the port's side alone per seed.
- **full recipe**: ``scripts/full_recipe_drive.py`` (the C2 recipe) as a
  subprocess, last.

A leg that was asked for and fails (an exception, a non-zero exit, a
timeout) is listed under ``failed_legs``; the payload and the headline are
still written, and the process exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
DEFAULT_OUTPUT = REPO / "bench_out" / "bench_full.json"
RUNS_DIR = REPO / "docs" / "torch_runs"
GATE_MIN_COSINE = 0.999
ANNOTATE_POINTS = 25
HEAD_HIDDEN = (500, 300, 100)
HEAD_CLASSES = 80
# Dense peaks of one H100 SXM (NVIDIA's data sheet): bf16 on the tensor
# cores, f32 on the CUDA cores with TF32 off.
PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 67.0}
# Device-memory touches per materialized activation byte in the roofline
# model: written once, read once by the next layer.
TRAFFIC_FACTOR = 2.0
QUALITY_KEYS = ("repo_accuracy", "repo_balanced_accuracy", "repo_log_loss",
                "sklearn_accuracy", "sklearn_balanced_accuracy",
                "sklearn_log_loss", "accuracy_delta", "balanced_accuracy_delta")
RECIPE_KEYS = ("train_full_recipe_minutes", "total_minutes", "stage_seconds",
               "train_stage_breakdown", "subsample_realized", "final_epoch",
               "best_val_epoch", "accuracy", "balanced_accuracy", "log_loss",
               "f1_macro", "mcc", "cover_median_r_squared",
               "per_source_min_accuracy", "export_parity_max_abs_diff",
               "reference_minutes", "device")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _seconds(fn, device: torch.device) -> float:
    """Seconds of ``fn()``: CUDA events around it on a card (ended by the
    event's synchronize), the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _launches() -> tuple[int, int]:
    """(crop, fused-MBConv) kernel launches so far in this process."""
    from mermaid_classifier_tpu_torch.ops import fused_mbconv, patch_crop

    return patch_crop.launches, fused_mbconv.launches


def _min_cosine(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    num = np.sum(a * b, axis=1)
    den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
    return float(np.min(num / np.maximum(den, 1e-12)))


def _jpeg(image: np.ndarray) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def make_extractor(backbone: str, variables, config, device, batch: int):
    """A ``FeatureExtractor`` over ``variables`` with ``batch``-patch trunk
    chunks; its ``features_for_patches_device`` is the trunk the device
    loop times."""
    from mermaid_classifier_tpu_torch.models.extractor import FeatureExtractor

    return FeatureExtractor(variables, config, device=device,
                            backbone_batch=batch, backbone_impl=backbone)


def numerics_gate(forward, variables, config, device, n: int = 8,
                  seed: int = 0) -> float:
    """Min cosine over ``n`` seeded probe patches between ``forward`` and
    the f32 ``module`` forward on the same device (TF32 off)."""
    from mermaid_classifier_tpu_torch.models.extractor import FeatureExtractor

    ps = config.patch_size
    probe = torch.from_numpy(np.random.default_rng(seed).random(
        (n, ps, ps, 3)).astype(np.float32)).to(device)
    reference = FeatureExtractor(
        variables, replace(config, compute_dtype="float32"), device=device,
        backbone_batch=n, backbone_impl="module")
    want = reference.features_for_patches_device(probe).float().cpu().numpy()
    with torch.inference_mode():
        got = forward(probe).float().cpu().numpy()
    return _min_cosine(got, want)


def run_device_loop(forward, config, device, *, image_size: int, points: int,
                    chunk: int, iters: int, warmup: int, repeats: int) -> dict:
    """Steady-state rate of crop + trunk on one resident image: each step
    crops ``points`` patches in one launch and runs them through
    ``forward`` (``points // chunk`` trunk chunks); the steps of a repeat
    are chained through a scalar carry and timed together."""
    from mermaid_classifier_tpu_torch.models.efficientnet import compute_dtype
    from mermaid_classifier_tpu_torch.ops.patch_crop import extract_patches
    from mermaid_classifier_tpu_torch.ops.patch_ops import channel_scale_bias

    if points % chunk != 0:
        raise ValueError(f"--points {points} must divide by --chunk {chunk}")
    ps, dtype = config.patch_size, compute_dtype(config)
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.integers(
        0, 256, size=(image_size, image_size, 3), dtype=np.uint8)).to(device)
    scale, bias = channel_scale_bias(config.mean_rgb, config.std_rgb)
    # Warm-up runs at least one step; every step, warm-up or timed, has
    # starts of its own (the timed ones are reused across repeats).
    n_warmup = max(warmup, 1)
    starts = [rng.integers(0, image_size, size=(points // chunk, chunk, 2))
              .astype(np.int32).reshape(points, 2)
              for _ in range(n_warmup + iters)]

    def step(acc, s):
        patches = extract_patches(image, s, ps, scale, bias, out_dtype=dtype,
                                  pad=ps // 2)
        return acc + forward(patches).sum()

    log(f"device loop: warm-up ({n_warmup} steps, {points} patches/step as"
        f" {points // chunk}x{chunk})")
    with torch.inference_mode():
        acc = torch.zeros((), device=device)
        for i in range(n_warmup):
            acc = step(acc, starts[i])
        _sync(device)
        runs = []
        crop0, fused0 = _launches()
        for r in range(repeats):
            carry = {"acc": torch.zeros((), device=device)}

            def timed():
                for i in range(iters):
                    carry["acc"] = step(carry["acc"], starts[n_warmup + i])

            elapsed = _seconds(timed, device)
            if not torch.isfinite(carry["acc"]).item():
                raise RuntimeError(f"device loop[{r}]: the feature sum is not finite")
            runs.append(points * iters / elapsed)
            log(f"device loop[{r}]: {iters} steps x {points} patches in"
                f" {elapsed:.3f}s -> {runs[-1]:,.1f} patch-features/s")
        crop1, fused1 = _launches()
    n_steps = iters * repeats
    return {"runs_pps": runs, "crop_launches_per_step": (crop1 - crop0) / n_steps,
            "fused_launches_per_step": (fused1 - fused0) / n_steps}


def trunk_cost(config) -> tuple[int, int]:
    """(materialized activation elements, FLOPs) per patch, walked over the
    trunk geometry (``ops/fused_mbconv.block_metas``). Elements: stem out,
    each block's expand / depthwise / project outs, head out (the unfused
    activation model). FLOPs: two per multiply-add of every conv and
    dense layer (stem, expand, depthwise, the two SE layers, project, head,
    the feature projection)."""
    from mermaid_classifier_tpu_torch.ops.fused_mbconv import block_metas

    spatial = -(-config.patch_size // 2)  # stem stride 2
    elements = spatial * spatial * config.stem_channels
    flops = 2 * spatial * spatial * 27 * config.stem_channels
    in_ch = config.stem_channels
    for m in block_metas(config):
        mid, out_ch, kernel = m.mid_channels, m.out_channels, m.kernel
        se = max(1, int(m.in_channels * config.se_ratio))
        if m.has_expand:
            elements += m.h * m.w * mid
            flops += 2 * m.h * m.w * m.in_channels * mid
        spatial = -(-m.h // m.stride)
        elements += spatial * spatial * mid
        elements += spatial * spatial * out_ch
        flops += 2 * spatial * spatial * mid * (kernel * kernel + out_ch)
        flops += 2 * 2 * mid * se
        in_ch = out_ch
    elements += spatial * spatial * config.head_channels
    flops += 2 * spatial * spatial * in_ch * config.head_channels
    if config.feature_dim != config.head_channels:
        flops += 2 * config.head_channels * config.feature_dim
    return elements, flops


def schedule_bytes(config, dtype: str, backbone: str) -> int:
    """Activation bytes per patch that the ``backbone`` schedule writes to
    device memory (each read back once by the next layer). Under ``fused``
    each block ``ops/fused_mbconv.fusable`` routes to the fused kernel
    keeps its expand output on chip and writes its depthwise output in
    f32 (the kernel's scratch, read back by its project pass) and its own
    output; the SE partial sums are left out. Every other layer, and every
    layer of ``module`` and ``folded``, writes what ``trunk_cost`` counts:
    a lower bound for their eager ops, which also write each bias,
    activation and SE product."""
    from mermaid_classifier_tpu_torch.ops.fused_mbconv import block_metas, fusable

    act = 2 if dtype == "bfloat16" else 4
    total = trunk_cost(config)[0] * act
    if backbone != "fused":
        return total
    for m in filter(fusable, block_metas(config)):
        # Stride 1: the expand and depthwise outputs have the same size.
        total += m.h * m.w * m.mid_channels * (4 - 2 * act)
    return total


def modeled_roofline(config, dtype: str, backbone: str, device_pps: float | None,
                     hbm_gbps: float) -> dict:
    """The trunk's bounds per patch beside the achieved time.

    The unfused activation model (the JAX bench's definition, kept for
    comparison with its records): every materialized activation tensor
    (``trunk_cost``) touched ``TRAFFIC_FACTOR`` times over ``hbm_gbps``;
    ``roofline_fraction`` is that bound over the achieved time. The
    schedule's bytes (``schedule_bytes`` for ``backbone``) give
    ``schedule_hbm_bound_us_per_patch`` and ``schedule_roofline_fraction``
    the same way. The FLOP bound: the trunk's FLOPs over the dtype's peak.
    ``bound_by`` names the larger of the schedule's bytes bound and the
    FLOP bound. ``device_pps`` None (a CPU run) leaves the achieved time
    and both fractions null."""
    elements, flops = trunk_cost(config)
    materialized_bytes = elements * (2 if dtype == "bfloat16" else 4)
    run_bytes = schedule_bytes(config, dtype, backbone)
    bytes_us = materialized_bytes * TRAFFIC_FACTOR / (hbm_gbps * 1e9) * 1e6
    run_bytes_us = run_bytes * TRAFFIC_FACTOR / (hbm_gbps * 1e9) * 1e6
    flop_us = flops / (PEAK_TFLOPS[dtype] * 1e12) * 1e6
    achieved_us = 1e6 / device_pps if device_pps else None

    def fraction(bound_us):
        return round(bound_us / achieved_us, 3) if achieved_us else None

    return {
        "activation_model": "unfused: every block's expand, depthwise and"
                            " project outputs written and read back (the JAX"
                            " bench's modeled_roofline)",
        "materialized_mb_per_patch": round(materialized_bytes / 1e6, 2),
        "traffic_factor": TRAFFIC_FACTOR,
        "hbm_gbps_assumed": hbm_gbps,
        "modeled_hbm_bound_us_per_patch": round(bytes_us, 3),
        "roofline_fraction": fraction(bytes_us),
        "schedule": backbone,
        "schedule_materialized_mb_per_patch": round(run_bytes / 1e6, 2),
        "schedule_hbm_bound_us_per_patch": round(run_bytes_us, 3),
        "schedule_roofline_fraction": fraction(run_bytes_us),
        "gflop_per_patch": round(flops / 1e9, 4),
        "peak_tflops_assumed": PEAK_TFLOPS[dtype],
        "flop_bound_us_per_patch": round(flop_us, 3),
        "bound_by": "bytes" if run_bytes_us >= flop_us else "operations",
        "achieved_us_per_patch": round(achieved_us, 3) if achieved_us else None,
    }


def run_bucket(extractor, *, image_size: int, n_images: int, points: int,
               repeats: int) -> dict:
    """End to end: JPEGs in a local store -> ``FeatureBucketBuilder`` ->
    feature files written back, ``repeats`` + 1 runs into distinct target
    buckets (a bucket already holding an image's file would skip it); run 0
    is discarded and reported."""
    from mermaid_classifier_tpu_torch.data.feature_bucket import FeatureBucketBuilder
    from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore

    rng = np.random.default_rng(1)
    with tempfile.TemporaryDirectory(prefix="bench_bucket_") as td:
        store = LocalFSObjectStore(Path(td) / "store")
        log(f"bucket: synthesizing {n_images} JPEGs ({image_size}^2,"
            f" {points} points each)")
        lines = ["image_id,image_key,row,col"]
        for i in range(n_images):
            image = rng.integers(0, 256, size=(image_size, image_size, 3),
                                 dtype=np.uint8)
            key = f"s1/images/i{i:04d}.jpg"
            store.put_bytes("imgs", key, _jpeg(image))
            rows = rng.integers(0, image_size, size=(points, 2))
            lines.extend(f"{i:04d},{key},{r},{c}" for r, c in rows)
        store.put_bytes("imgs", "s1/annotations.csv",
                        ("\n".join(lines) + "\n").encode())

        crop0, fused0 = _launches()
        warm = rng.integers(0, 256, size=(image_size, image_size, 3), dtype=np.uint8)
        extractor.extract_features(
            warm, rng.integers(0, image_size, size=(points, 2)).astype(np.int32))
        runs, warmup_pps, total = [], None, 0
        for r in range(repeats + 1):
            builder = FeatureBucketBuilder(store, "imgs", f"feats{r}", extractor)
            t0 = time.perf_counter()
            result = builder.run(["1"])
            elapsed = time.perf_counter() - t0
            if result.images_failed:
                raise RuntimeError(f"bucket run {r} had failures: {result.describe()}")
            total = sum(s.points_done for s in result.sources)
            pps = total / elapsed
            log(f"bucket[{'warm-up, discarded' if r == 0 else r - 1}]: {n_images}"
                f" images / {total} points in {elapsed:.3f}s -> {pps:,.1f}"
                " patch-features/s end to end")
            if r == 0:
                warmup_pps = pps
            else:
                runs.append(pps)
        crop1, fused1 = _launches()
    return {"runs_pps": runs, "warmup_pps": warmup_pps, "images": n_images,
            "points": total, "crop_launches": crop1 - crop0,
            "fused_launches": fused1 - fused0}


def run_stage_budget(extractor, *, image_size: int, points: int, reps: int,
                     device_pps: float) -> dict:
    """One bucket image's stages, each the median of ``reps``: JPEG decode,
    the extractor's pageable raw upload, the readback of its (points,
    feature_dim) f32 features, one store write; compute from the device
    loop's rate. Device timings end in a synchronize. The decode is timed
    on the bucket leg's per-pixel noise (the worst case for the entropy
    decoder) and on the smooth fields of ``feature_bucket_drive``."""
    from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
    from mermaid_classifier_tpu_torch.scripts.feature_bucket_drive import smooth_field
    from mermaid_classifier_tpu_torch.serve.image_sources import decode_image_bytes

    device, feature_dim = extractor.device, extractor.feature_dim
    rng = np.random.default_rng(3)

    def med(fn) -> float:
        ts = []
        for i in range(reps):
            t0 = time.perf_counter()
            fn(i)
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    jpegs = [_jpeg(rng.integers(0, 256, (image_size, image_size, 3), np.uint8))
             for _ in range(reps)]
    decode_ms = med(lambda i: decode_image_bytes(jpegs[i]))
    smooth = [_jpeg(smooth_field(rng, image_size, image_size)) for _ in range(reps)]
    decode_smooth_ms = med(lambda i: decode_image_bytes(smooth[i]))

    images = [rng.integers(0, 256, (image_size, image_size, 3), np.uint8)
              for _ in range(reps)]

    def upload(i):
        extractor._upload(images[i])
        _sync(device)

    _sync(device)
    h2d_ms = med(upload)
    feats = [torch.from_numpy(rng.standard_normal((points, feature_dim))
                              .astype(np.float32)).to(device) for _ in range(reps)]
    _sync(device)
    d2h_ms = med(lambda i: feats[i].cpu())
    payloads = [feats[i % reps].cpu().numpy().tobytes() for i in range(2)]
    with tempfile.TemporaryDirectory(prefix="bench_probe_") as td:
        store = LocalFSObjectStore(Path(td))
        write_ms = med(lambda i: store.put_bytes("probe", f"f{i}.bin", payloads[i % 2]))
    h2d_bytes, d2h_bytes = image_size * image_size * 3, points * feature_dim * 4
    budget = {
        "points_per_image": points,
        "decode_ms": round(decode_ms, 3),
        "jpeg_kb": round(float(np.mean([len(j) for j in jpegs])) / 1e3, 1),
        "decode_ms_smooth_images": round(decode_smooth_ms, 3),
        "jpeg_kb_smooth_images": round(float(np.mean([len(j) for j in smooth])) / 1e3, 1),
        "h2d_ms": round(h2d_ms, 3),
        "h2d_mbps": round(h2d_bytes / 1e3 / h2d_ms, 1),
        "compute_ms": round(points / device_pps * 1e3, 3),
        "d2h_ms": round(d2h_ms, 3),
        "d2h_mbps": round(d2h_bytes / 1e3 / d2h_ms, 1),
        "write_ms": round(write_ms, 3),
        "host_cpus": os.cpu_count() or 1,
        "loadavg_1m": round(os.getloadavg()[0], 2),
    }
    log(f"stage budget/image: decode {decode_ms:.2f} (smooth images"
        f" {decode_smooth_ms:.2f}) h2d {h2d_ms:.2f} compute"
        f" {budget['compute_ms']:.2f} d2h {d2h_ms:.2f} write {write_ms:.2f} ms")
    return budget


def annotate_head(dim: int):
    """The annotate leg's seeded calibrated head (rng seed 5, last layer x4,
    as the JAX bench draws it) and the rng, which goes on to draw the image
    and points. On the seeded trunk's features its logits stay near 0, so
    its softmax is flat."""
    from mermaid_classifier_tpu_torch.inference.head import HeadParams

    rng = np.random.default_rng(5)
    sizes = (dim, *HEAD_HIDDEN, HEAD_CLASSES)
    weights = [rng.standard_normal((i, o)).astype(np.float32) / np.sqrt(i)
               for i, o in zip(sizes[:-1], sizes[1:])]
    weights[-1] *= 4.0
    return HeadParams(weights, [np.zeros(o, np.float32) for o in sizes[1:]],
                      -np.ones(sizes[-1], np.float32),
                      np.zeros(sizes[-1], np.float32)), rng


def cpu_reference(variables, config, image: np.ndarray, rowcols: np.ndarray,
                  params) -> tuple[np.ndarray, np.ndarray]:
    """(features, probabilities) of one image's points through the f32
    ``module`` extractor and the calibrated head on the CPU."""
    from mermaid_classifier_tpu_torch.inference.head import make_head_fn

    extractor = make_extractor("module", variables,
                               replace(config, compute_dtype="float32"), "cpu",
                               len(rowcols))
    features = extractor.extract_features(image, rowcols)
    return features, make_head_fn(params, "cpu")(features)


def head_logits(params, features, device) -> np.ndarray:
    """The head's raw logits (before softmax and calibration) of
    ``features`` on ``device``."""
    from mermaid_classifier_tpu_torch.inference.head import mlp_logits

    tensors = params.as_tensors(device)
    x = torch.as_tensor(features, dtype=torch.float32).to(device)
    with torch.inference_mode():
        return mlp_logits(tensors["weights"], tensors["biases"], x).cpu().numpy()


def run_annotate_latency(extractor, variables, *, image_size: int,
                         repeats: int) -> dict:
    """One JPEG, 25 points: decode -> ``extract_features`` -> calibrated
    head, the median of ``repeats`` x 5 requests after one warm request;
    then the same image and points on the CPU (``cpu_reference``)."""
    from mermaid_classifier_tpu_torch.inference.head import make_head_fn
    from mermaid_classifier_tpu_torch.serve.image_sources import decode_image_bytes

    params, rng = annotate_head(extractor.feature_dim)
    head_fn = make_head_fn(params, extractor.device)
    jpeg = _jpeg(rng.integers(0, 256, size=(image_size, image_size, 3),
                              dtype=np.uint8))
    rowcols = rng.integers(0, image_size, size=(ANNOTATE_POINTS, 2)).astype(np.int32)

    def annotate():
        features = extractor.extract_features(decode_image_bytes(jpeg), rowcols)
        return features, head_fn(features)

    annotate()
    times = []
    for _ in range(repeats * 5):
        t0 = time.perf_counter()
        features, proba = annotate()
        times.append((time.perf_counter() - t0) * 1e3)
    latency_ms = float(np.median(times))
    log(f"annotate (1 image, {ANNOTATE_POINTS} points): median {latency_ms:.3f} ms"
        f" ({min(times):.3f}-{max(times):.3f} over {len(times)})")
    feats_cpu, proba_cpu = cpu_reference(
        variables, extractor.config, decode_image_bytes(jpeg), rowcols, params)
    cosine = _min_cosine(features, feats_cpu)
    proba_diff = float(np.max(np.abs(proba - proba_cpu)))
    # A softmax that is flat (logits near 0) or one-hot gives probabilities
    # that are constants of the calibration, equal on both sides whatever
    # the features; the logits before it carry the features' differences.
    logits = head_logits(params, features, extractor.device)
    logits_cpu = head_logits(params, feats_cpu, "cpu")
    logit_diff = float(np.max(np.abs(logits - logits_cpu)))
    logit_scale = float(np.max(np.abs(logits_cpu)))
    saturated = int(np.sum(torch.softmax(torch.from_numpy(logits), dim=1)
                           .max(dim=1).values.numpy() == 1.0))
    log(f"annotate CPU parity: min feature cosine {cosine:.6f}, max |logit diff|"
        f" {logit_diff:.3e} (max |logit| {logit_scale:.3e}), max |proba diff|"
        f" {proba_diff:.3e} ({saturated} of {len(logits)} rows' softmax one-hot)")
    return {"latency_ms": round(latency_ms, 3), "points": ANNOTATE_POINTS,
            "runs": len(times), "cpu_parity_min_cosine": round(cosine, 6),
            "cpu_parity_max_logit_diff": logit_diff,
            "cpu_parity_max_abs_logit": logit_scale,
            "cpu_parity_max_proba_diff": proba_diff,
            "softmax_one_hot_rows": saturated}


def run_head_training(device, *, rows: int, epochs: int, dim: int) -> dict:
    """Resident head training: the production head over ``rows`` seeded
    rows of ``dim`` (80 classes), 5,000-row ``partial_fit_resident`` calls
    over a permutation per epoch; epoch 0 (the step's capture) is not
    timed, the upload is timed apart."""
    from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier

    rng = np.random.default_rng(2)
    X = rng.normal(size=(rows, dim)).astype(np.float32)
    y = np.asarray([f"c{i:02d}" for i in rng.integers(0, HEAD_CLASSES, rows)])
    classes = sorted(set(y.tolist()))
    clf = MLPClassifier(HEAD_HIDDEN, learning_rate_init=1e-4, random_state=0,
                        device=device)
    t0 = time.perf_counter()
    clf.set_resident_features(X)
    _sync(device)
    upload_s = time.perf_counter() - t0
    erng = np.random.default_rng(0)
    t_start = None
    for epoch in range(epochs + 1):
        if epoch == 1:
            _sync(device)
            t_start = time.perf_counter()
        order = erng.permutation(rows)
        for s in range(0, rows, 5000):
            idx = order[s:s + 5000]
            clf.partial_fit_resident(idx, y[idx], classes=classes)
    _sync(device)
    elapsed = time.perf_counter() - t_start
    if not np.isfinite(clf.loss_curve_[-1]):
        raise RuntimeError(f"head training: the loss is not finite"
                           f" ({clf.loss_curve_[-1]})")
    sps = rows * epochs / elapsed
    log(f"head training (resident): {epochs} epochs x {rows} samples in"
        f" {elapsed:.3f}s -> {sps:,.1f} samples/s (upload {upload_s:.3f}s)")
    return {"samples_per_sec": sps, "rows": rows, "epochs": epochs,
            "upload_seconds": upload_s}


def serve_head(dim: int):
    """The serve leg's seeded calibrated head (rng seed 4) and the rng,
    which goes on to draw the batch."""
    from mermaid_classifier_tpu_torch.inference.head import HeadParams

    rng = np.random.default_rng(4)
    sizes = (dim, *HEAD_HIDDEN, HEAD_CLASSES)
    return HeadParams(
        [rng.standard_normal((i, o)).astype(np.float32) * (1.0 / np.sqrt(i))
         for i, o in zip(sizes[:-1], sizes[1:])],
        [np.zeros(o, np.float32) for o in sizes[1:]],
        -np.ones(sizes[-1], np.float32), np.zeros(sizes[-1], np.float32)), rng


def run_serve(device, *, batch: int, dim: int, iters: int = 30) -> dict:
    """Calibrated-head rows/s over one ``batch``-row device batch: ``iters``
    ``head_apply`` calls timed together after one warm-up call, ended by
    one scalar readback of the last result. The calls run in order on one
    stream, so nothing chains them."""
    from mermaid_classifier_tpu_torch.inference.head import head_apply

    params, rng = serve_head(dim)
    tensors = params.as_tensors(device)
    x = torch.from_numpy(rng.standard_normal((batch, dim)).astype(np.float32)).to(device)

    with torch.inference_mode():
        float(head_apply(tensors, x)[0, 0])
        last = {}

        def timed():
            for _ in range(iters):
                out = head_apply(tensors, x)
            float(out[0, 0])
            last["proba"] = out

        elapsed = _seconds(timed, device)
    if not torch.isfinite(last["proba"]).all():
        raise RuntimeError("serve: the probabilities are not finite")
    rows_per_sec = batch * iters / elapsed
    log(f"serve: {iters} x {batch}-row head batches -> {rows_per_sec:,.1f} rows/s")
    return {"rows_per_sec": rows_per_sec, "batch": batch}


def _module_cmd(module: str, *args: str) -> list[str]:
    return [sys.executable, "-m", f"mermaid_classifier_tpu_torch.scripts.{module}",
            *args]


def _quality_run(args: list[str], timeout: float) -> dict:
    proc = subprocess.run(_module_cmd("quality_parity_bench", *args),
                          capture_output=True, text=True, timeout=timeout, cwd=REPO)
    if proc.returncode != 0:
        raise RuntimeError(f"quality_parity_bench {' '.join(args)} exited"
                           f" {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def run_quality(device: str, seeds: int, *, extra=(), have_sklearn=None,
                timeout: float = 1800.0) -> dict:
    """The composed quality check (``scripts/quality_parity_bench.py``) as
    subprocesses on ``device``. With sklearn: the matched-init run over
    ``seeds`` seeds (mean and 95% t-CI of each delta) and the
    reference-init run. Without it: ``--repo-only`` per seed, the port's
    metrics and their means, every delta null."""
    import importlib.util

    base = ["--device", device, *extra]
    if have_sklearn is None:
        have_sklearn = importlib.util.find_spec("sklearn") is not None
    if not have_sklearn:
        per_seed = []
        for seed in range(seeds):
            r = _quality_run([*base, "--repo-only", "--seed", str(seed)], timeout)
            per_seed.append({"seed": seed, **{k: r[k] for k in (
                "repo_accuracy", "repo_balanced_accuracy", "repo_log_loss",
                "repo_seconds")}})
            log(f"quality (repo only, seed {seed}): accuracy {r['repo_accuracy']},"
                f" balanced {r['repo_balanced_accuracy']}, log loss"
                f" {r['repo_log_loss']}")
        means = {f"{k}_mean": round(float(np.mean([r[k] for r in per_seed])), 4)
                 for k in ("repo_accuracy", "repo_balanced_accuracy", "repo_log_loss")}
        return {"quality": {
            "sklearn": "not installed", **means,
            **{f"{k}_delta": None for k in ("accuracy", "balanced_accuracy", "log_loss")},
            **{f"{k}_delta_ci95": None
               for k in ("accuracy", "balanced_accuracy", "log_loss")},
            "ci_contains_zero": None, "seeds": seeds, "per_seed": per_seed,
            "init": "reference (repo only: sklearn is not installed)"}}
    multi = _quality_run([*base, "--init", "sklearn", "--seeds", str(seeds)], timeout)
    ref = _quality_run([*base, "--init", "reference"], timeout)
    deltas = multi["deltas"]
    band = deltas["balanced_accuracy_delta"]
    log(f"quality (sklearn init, {seeds} seeds): balanced accuracy delta"
        f" {band['mean']} CI [{band['ci95_low']}, {band['ci95_high']}]")
    return {
        "quality": {
            "sklearn": "installed",
            **{k: deltas[k]["mean"] for k in
               ("accuracy_delta", "balanced_accuracy_delta", "log_loss_delta")},
            **{f"{k}_ci95": [deltas[k]["ci95_low"], deltas[k]["ci95_high"]]
               for k in ("accuracy_delta", "balanced_accuracy_delta", "log_loss_delta")},
            "ci_contains_zero": {k: deltas[k]["ci_contains_zero"] for k in deltas},
            "seeds": len(multi["seeds"]),
            "per_seed": [{k: r[k] for k in QUALITY_KEYS} for r in multi["per_seed"]],
            "init": "sklearn (matched init; pipeline-only delta; mean and 95% t-CI"
                    " over seeds)",
        },
        "quality_reference_init": {
            **{k: ref[k] for k in QUALITY_KEYS},
            "init": "reference (the delta includes the init-draw difference)",
        },
    }


def full_recipe_committed_record(run_dir: Path = RUNS_DIR) -> dict | None:
    """The fastest committed C2 recipe record of the port
    (``docs/torch_runs/full_recipe*.json``), labelled as not this run's."""
    records = []
    for path in sorted(run_dir.glob("full_recipe*.json")):
        rec = json.loads(path.read_text())
        if "train_full_recipe_minutes" in rec:
            records.append((rec["train_full_recipe_minutes"], path, rec))
    if not records:
        return None
    _, best_path, best = min(records, key=lambda r: r[0])
    return {
        "source": f"docs/torch_runs/{best_path.name}",
        "measured_this_run": False,
        "all_committed_runs": {p.name: m for m, p, _ in records},
        **{k: best[k] for k in ("train_full_recipe_minutes", "accuracy",
                                "balanced_accuracy", "export_parity_max_abs_diff",
                                "reference_minutes", "device") if k in best},
    }


def run_full_recipe(device: str, *, pool_rows: int, resident_dtype: str,
                    timeout: float, extra=()) -> dict:
    """The C2 recipe drive (``scripts/full_recipe_drive.py``) as a
    subprocess under ``timeout``; its stdout (stage lines, its result line)
    goes to this process's stderr, so the bench's stdout stays JSON."""
    try:
        drive_stdout = sys.stderr.fileno()
    except (AttributeError, OSError, ValueError):  # a stderr with no file
        drive_stdout = subprocess.DEVNULL
    with tempfile.TemporaryDirectory(prefix="bench_recipe_") as td:
        out_json = Path(td) / "result.json"
        log(f"full recipe: the C2 drive (pool {pool_rows:,} rows)")
        proc = subprocess.run(
            _module_cmd("full_recipe_drive", "--pool-rows", str(pool_rows),
                        "--resident-dtype", resident_dtype, "--device", device,
                        "--output-json", str(out_json), *extra),
            timeout=timeout, stdout=drive_stdout, cwd=REPO)
        if proc.returncode != 0 or not out_json.is_file():
            raise RuntimeError(f"full_recipe_drive exited {proc.returncode}")
        result = json.loads(out_json.read_text())
    log(f"full recipe: train {result['train_full_recipe_minutes']} min, accuracy"
        f" {result.get('accuracy')}, balanced {result.get('balanced_accuracy')}")
    return {k: result[k] for k in RECIPE_KEYS if k in result}


def headline(payload: dict) -> dict:
    """The compact last line: the device loop's metric, the device, the gate,
    the roofline share, the four leg rates, the quality and recipe blocks,
    the failed legs."""
    head = {k: payload[k] for k in (
        "metric", "value", "unit", "device", "dtype", "backbone",
        "numerics_gate_cosine", "roofline_fraction", "schedule_roofline_fraction",
        "bucket_patches_per_sec",
        "annotate_latency_ms", "train_samples_per_sec", "serve_rows_per_sec",
        "failed_legs") if k in payload}
    quality = payload.get("quality")
    if quality:
        head["quality"] = {k: quality[k] for k in (
            "sklearn", "accuracy_delta", "balanced_accuracy_delta",
            "balanced_accuracy_delta_ci95", "ci_contains_zero", "repo_accuracy_mean",
            "repo_balanced_accuracy_mean", "seeds", "init") if k in quality}
    recipe = payload.get("full_recipe")
    if recipe:
        head["full_recipe"] = {
            **{k: recipe[k] for k in ("train_full_recipe_minutes", "accuracy",
                                      "balanced_accuracy", "log_loss",
                                      "export_parity_max_abs_diff",
                                      "subsample_realized") if k in recipe},
            "measured_this_run": True}
    elif payload.get("full_recipe_committed_record"):
        committed = payload["full_recipe_committed_record"]
        head["full_recipe"] = {k: v for k, v in committed.items()
                               if k != "all_committed_runs"}
    head["full_payload_file"] = payload.get("full_payload_file")
    return head


def write_payload(payload: dict, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1) + "\n")
    log(f"full payload written to {path}")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda, which raises without"
                        " a card; cpu for tests)")
    parser.add_argument("--output-json", default=str(DEFAULT_OUTPUT),
                        help="where the full payload is written (before the"
                        " recipe leg and at the end)")
    parser.add_argument("--points", type=int, default=2048,
                        help="patches per device-loop step")
    parser.add_argument("--chunk", type=int, default=128,
                        help="trunk chunk inside a device-loop step")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--repeats", type=int, default=3,
                        help="measurement repeats per leg; the payload has the"
                        " median and every run")
    parser.add_argument("--probe-reps", type=int, default=5,
                        help="repeats inside the stage budget")
    parser.add_argument("--hbm-gbps", type=float, default=3350.0,
                        help="device memory rate for the roofline model (H100"
                        " SXM data sheet)")
    parser.add_argument("--no-stage-budget", action="store_true")
    parser.add_argument("--image-size", type=int, default=1536)
    parser.add_argument("--backbone-batch", type=int, default=128,
                        help="the bucket and annotate extractor's trunk chunk")
    parser.add_argument("--bucket-images", type=int, default=24)
    parser.add_argument("--bucket-points", type=int, default=256)
    parser.add_argument("--no-bucket", action="store_true")
    parser.add_argument("--no-annotate", action="store_true")
    parser.add_argument("--no-full-recipe", action="store_true")
    parser.add_argument("--recipe-pool-rows", type=int, default=620_000,
                        help="annotation pool of the C2 drive (the default"
                        " realizes a 449,099-row subsample)")
    parser.add_argument("--recipe-timeout", type=float, default=5400.0)
    parser.add_argument("--recipe-resident-dtype", default="int8",
                        choices=("float32", "bfloat16", "int8"))
    parser.add_argument("--no-train", action="store_true")
    parser.add_argument("--no-quality", action="store_true")
    parser.add_argument("--quality-seeds", type=int, default=5,
                        help="seeds of the quality leg (>= 2)")
    parser.add_argument("--no-serve", action="store_true")
    parser.add_argument("--serve-batch", type=int, default=4096)
    parser.add_argument("--train-rows", type=int, default=10000)
    parser.add_argument("--train-epochs", type=int, default=3)
    parser.add_argument("--backbone", choices=("module", "folded", "fused"),
                        default="fused",
                        help="trunk schedule: fused (folded weights, the fused"
                        " MBConv kernel for every fusable block; the"
                        " extractor's default), folded, or module")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"),
                        default="bfloat16", help="trunk compute dtype")
    args = parser.parse_args(argv)
    if not args.no_quality and args.quality_seeds < 2:
        parser.error("--quality-seeds must be >= 2 (a CI band needs more than"
                     " one draw); use --no-quality to skip the leg")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    # Another process's load, sampled before this one does anything heavy.
    loadavg_at_start = round(os.getloadavg()[0], 2)

    from mermaid_classifier_tpu_torch.models.efficientnet import (
        EfficientNetConfig,
        init_backbone_params,
    )
    from mermaid_classifier_tpu_torch.models.extractor import _resolve_device
    from mermaid_classifier_tpu_torch.scripts.full_recipe_drive import device_entry

    device = _resolve_device(args.device)
    device_block = device_entry(args.device)
    log(f"device: {device_block}")
    config = EfficientNetConfig(compute_dtype=args.dtype)  # B0 224 -> 4096
    variables = init_backbone_params(0, config)
    output = Path(args.output_json)

    loop_extractor = make_extractor(args.backbone, variables, config, device,
                                    args.chunk)
    forward = loop_extractor.features_for_patches_device
    gate = numerics_gate(forward, variables, config, device)
    log(f"{args.dtype}/{args.backbone} numerics gate: min cosine {gate:.6f} vs the"
        " f32 module forward")
    if not gate >= GATE_MIN_COSINE:
        log(f"{args.dtype}/{args.backbone} fails the {GATE_MIN_COSINE} cosine gate"
            f" ({gate:.6f}); nothing is timed")
        return 1

    loop = run_device_loop(
        forward, config, device, image_size=args.image_size, points=args.points,
        chunk=args.chunk, iters=args.iters, warmup=args.warmup, repeats=args.repeats)
    device_pps = float(np.median(loop["runs_pps"]))
    roofline = modeled_roofline(config, args.dtype, args.backbone,
                                device_pps if device.type == "cuda" else None,
                                args.hbm_gbps)
    payload = {
        "metric": "patch_features_per_sec",
        "value": round(device_pps, 1),
        "unit": "patches/s",
        "device": device_block,
        "device_runs_pps": [round(r, 1) for r in loop["runs_pps"]],
        "device_loop": {"points": args.points, "chunk": args.chunk,
                        "iters": args.iters, "repeats": args.repeats,
                        "crop_launches_per_step": loop["crop_launches_per_step"],
                        "fused_launches_per_step": loop["fused_launches_per_step"]},
        "dtype": args.dtype,
        "backbone": args.backbone,
        "numerics_gate_cosine": round(gate, 6),
        "roofline": roofline,
        "roofline_fraction": roofline["roofline_fraction"],
        "schedule_roofline_fraction": roofline["schedule_roofline_fraction"],
        "loadavg_at_start": loadavg_at_start,
        "failed_legs": [],
        "full_payload_file": str(output),
    }
    log(f"roofline: unfused model {roofline['materialized_mb_per_patch']} MB/patch x"
        f" {TRAFFIC_FACTOR} -> {roofline['modeled_hbm_bound_us_per_patch']} us,"
        f" {args.backbone} schedule {roofline['schedule_materialized_mb_per_patch']}"
        f" MB -> {roofline['schedule_hbm_bound_us_per_patch']}"
        f" us, {roofline['gflop_per_patch']} GFLOP -> {roofline['flop_bound_us_per_patch']}"
        f" us (bound by {roofline['bound_by']}); achieved"
        f" {roofline['achieved_us_per_patch']} us/patch")

    def leg(name, fn, *a, **kw):
        try:
            return fn(*a, **kw)
        except Exception as exc:  # noqa: BLE001 - a failed leg is reported, not hidden
            log(f"leg {name} failed:\n{traceback.format_exc()}")
            payload["failed_legs"].append(
                {"leg": name, "error": f"{type(exc).__name__}: {exc}"[:2000]})
            return None

    if not (args.no_bucket and args.no_annotate):
        extractor = make_extractor(args.backbone, variables, config, device,
                                   args.backbone_batch)
        if not args.no_bucket:
            bucket = leg("bucket", run_bucket, extractor, image_size=args.image_size,
                         n_images=args.bucket_images, points=args.bucket_points,
                         repeats=args.repeats)
            if bucket is not None:
                bucket_pps = float(np.median(bucket["runs_pps"]))
                payload.update({
                    "bucket_patches_per_sec": round(bucket_pps, 1),
                    "bucket_runs_pps": [round(r, 1) for r in bucket["runs_pps"]],
                    "bucket_warmup_pps_discarded": round(bucket["warmup_pps"], 1),
                    "bucket_images": bucket["images"],
                    "bucket_vs_device": round(bucket_pps / device_pps, 3),
                    "bucket_launches": {"crop": bucket["crop_launches"],
                                        "fused_mbconv": bucket["fused_launches"],
                                        "runs": args.repeats + 1},
                })
        if not args.no_stage_budget:
            budget = leg("stage_budget", run_stage_budget, extractor,
                         image_size=args.image_size, points=args.bucket_points,
                         reps=args.probe_reps, device_pps=device_pps)
            if budget is not None:
                payload["stage_budget"] = budget
        if not args.no_annotate:
            annotate = leg("annotate", run_annotate_latency, extractor, variables,
                           image_size=args.image_size, repeats=args.repeats)
            if annotate is not None:
                payload["annotate_latency_ms"] = annotate["latency_ms"]
                payload["annotate"] = annotate
    if not args.no_train:
        head = leg("train", run_head_training, device, rows=args.train_rows,
                   epochs=args.train_epochs, dim=config.feature_dim)
        if head is not None:
            payload["train_samples_per_sec"] = round(head["samples_per_sec"], 1)
            payload["train_upload_seconds"] = round(head["upload_seconds"], 3)
            payload["train_steady_state"] = True
    if not args.no_serve:
        serve = leg("serve", run_serve, device, batch=args.serve_batch,
                    dim=config.feature_dim)
        if serve is not None:
            payload["serve_rows_per_sec"] = round(serve["rows_per_sec"], 1)
            payload["serve_batch"] = serve["batch"]
    if not args.no_quality:
        quality = leg("quality", run_quality, args.device, args.quality_seeds)
        if quality is not None:
            payload.update(quality)
    committed = full_recipe_committed_record()
    if committed is not None:
        payload["full_recipe_committed_record"] = committed

    if not args.no_full_recipe:
        # Every other leg is on disk and on stdout before the longest one.
        write_payload(payload, output)
        print(json.dumps(headline(payload)), flush=True)
        recipe = leg("full_recipe", run_full_recipe, args.device,
                     pool_rows=args.recipe_pool_rows,
                     resident_dtype=args.recipe_resident_dtype,
                     timeout=args.recipe_timeout)
        if recipe is not None:
            payload["full_recipe"] = recipe
            payload["train_full_recipe_minutes"] = recipe["train_full_recipe_minutes"]
    write_payload(payload, output)
    print(json.dumps(payload), flush=True)
    print(json.dumps(headline(payload)), flush=True)
    return 1 if payload["failed_legs"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
