#!/usr/bin/env python3
"""Drive the PyTorch port's serve path, its backbone-weight landing strip
(a pyspacer-lineage checkpoint -> ``diff_backbone`` -> release -> serve),
its bulk extraction lane, its head-training lane, its trainer (with the
packed feature cache), the composed quality check, its training recipe
(ETL -> resident train -> gated export -> nine metric groups -> registry ->
``models:/`` serve, programmatically and through the ``classifier_train``
YAML CLI), its full-trunk A/B harness, the operator's lifecycle around a
training run (CoralNet manifest, generated config, S3 store, tracking sync,
report, release, ``store://`` serve), its job layer (two extraction
workers sharing the card, a relaunch, the one-command E2E drive), its
at-scale drives (the kill-and-resume bulk build, the C2 recipe) and its
parallel layer on one CUDA card and check them.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (PATH or /usr/local/cuda/bin), ``g++``
(the packed cache's row gather) and ``nvidia-smi``; it imports only the
port (``mermaid_classifier_tpu_torch``), torch, numpy, (through the port's
calibration) scipy, pyarrow (to write the recipe's annotation tables as
production has them), the repository's stdlib fake S3 endpoint
(``tests/data/fake_s3_server.py``), its torch-only rebuild of the
pyspacer-lineage EfficientNet (``tests/parity/foreign_checkpoints.py``)
and, where it is installed, Pillow, and exits non-zero at the first failed
phase.

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
8. bucket — the bulk extraction lane at full width (B0 224, 4096-d,
   ``fused``) on a seeded local store: source 1 in the canonical layout (24
   images of 1536x2048, 25-200 points each on a grid of class-coloured
   cells, the outer cells within 112 px of an edge, one truncated image
   object), source 2 as a CoralNet export (24 images, status suffixes, two
   rows naming no listed image); JPEG bytes where Pillow imports, else
   ``.npy`` bytes (the port's decoder reads both). The port's
   ``build_feature_bucket`` CLI in bf16 (the cosine gate runs on its own):
   exit 1, the corrupt image in the error log, images and points done equal
   the good images' annotation rows, every file's rowcols equal its
   annotations in file order, four files equal ``extract_features`` bit for
   bit, and the wrapper counts are one crop per image and 11 fused blocks
   per 128-patch chunk (plus 11 for the gate). A second run writes nothing
   (mtimes unchanged) and ``--no-skip-existing`` rewrites every file; an f32
   run over four images (source 3) agrees with bf16 at min row cosine >=
   0.999. Times: the builder in bf16 and f32 with its host stages timed
   (fetch, decode, upload, dispatch, readback wait, write), images/s and
   patch-features/s beside the times phase's trunk-only rate, the same
   bf16 run with every image decoded beforehand, and a profiled bf16 run (device busy share; crop and fused kernels counted by
   ``torch.profiler``); the raw upload's host time on an idle stream, right
   after an image was dispatched, and pinned + non-blocking. Then the chain:
   the bucket's files with their points' classes through ``MermaidTrainer``
   (resident f32, 20 epochs), ``export_artifact`` (1e-6 gate), the
   ``predict_features`` CLI (one CSV row per point extracted) and, on two
   images, ``AnnotationRun`` from ``store://`` specs: the same top-3 labels,
   scores within 2e-6 (each f32 head is held within 1e-6 of the f64 model
   by the export gate, and the two run batches of other sizes).
9. train  — the head-training lane at production width, 4096 -> (500, 300,
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
10. trainer — ``MermaidTrainer`` at the same width (classifier mini-batch
   200, trainer batches of 10,000 rows) on 2,240 seeded feature files of 25
   points (80 class means plus noise), split 0.7 / 0.15 / 0.15: resident
   f32 for 3 epochs with early stopping (patience 2) and the device
   calibration solve; val loss finite, ref accuracy >= 0.9; its first
   epoch's weights equal a streamed trainer's epoch bit for bit; two
   streamed runs of 2 epochs over the first 480 files (12,000 rows, split
   again), with ``packed_cache_dir`` and without it: the native row gather
   in use, loss curve and weights bit for bit equal, the packing seconds
   and seconds per streamed epoch printed; calibrated
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
11. recipe — the training recipe through its programmatic entry point,
   ``TrackingTrainingRunner(...).run()``, at the production head's width
   (4096 -> (500, 300, 100) -> 80, mini-batch 200, lr 1e-4) on a seeded
   local store (``settings.object_store_root``): 1,200 MERMAID-layout and 200
   CoralNet-layout feature files of 25 points (a class mean plus unit noise,
   35,000 rows of 4096), the taxonomy through ``TAXONOMY_FIXTURE_ENV``
   (82 BA x GF classes under 4 top-level BAs, a rollup CSV folding 2 of
   them, a CoralNet mapping with one label left unmapped), the two
   annotation tables as parquet, a stratified subsample to 90%, effective-number weighting, resident bf16,
   the device calibration solve, 5 epochs, patience 2. It prints which of
   pyarrow, pandas, yaml, psutil, pydantic, sklearn and matplotlib import
   here. Checks: the annotations table carries ``training_set``, no split is
   empty, 80 classes remain, ``artifact_eval_inputs`` is
   ``resident(bfloat16)``, export parity <= 1e-6, the metric groups logged
   their classification scalars, the logged accuracy equals the registered
   predictor's argmax accuracy over the resident val rows and lies within
   0.005 of its accuracy over the f32 val rows on disk, and
   ``registry_meta.json`` names the run; the phase's environment variables
   are put back afterwards; then ``models:/<name>`` and
   ``models:/<name>/v1`` each classify a 25-point 1536x2048 request with one
   crop and 11 fused launches, within 2e-6 of the registered predictor on
   ``extract_features``. Times: the run's ``profiled_sections``,
   ``metrics_group_seconds``, ``resident_timings`` and the phase's wall.
   Then ``train_job_entrypoint`` on a config with an unknown key prints
   ``==== FAIL load_config`` and exits 1. The ``classifier_train`` CLI
   runs in the lifecycle phase, held to the checks a CLI run must pass,
   and once more in the jobs phase's E2E drive.
12. trunk_ab — the full-trunk A/B harness (``experiments.trunk_ab``) at B0
   224, 128-patch chunks, on every schedule of ``AB_SCHEDULES``: in bf16 and
   f32 each schedule's ``gate_cosine`` against ``folded`` is >= 0.999;
   ``time_trunk`` patch-features/s of every schedule in bf16 and of
   ``AB_F32_TIMED`` in f32, with the depthwise and fused launches per chunk
   of each timed run equal to ``AB_PER_CHUNK``; then the harness's CLI
   ``main`` once at 256 points with its numerics gate, which must print no
   ``[FAIL]``.
13. lifecycle — what a MERMAID operator runs around a training run, each
   step through the port's CLI in a subprocess, against the fake S3
   endpoint in this process (``OBJECT_STORE_ROOT=s3://``,
   ``OBJECT_STORE_ENDPOINT``, ``AWS_*``, proxies cleared): the recipe's
   1,400 feature files uploaded; a CoralNet export (the recipe's 200 images
   with their points, and six more with a bad or missing header status or
   no object key) through ``build_coralnet_manifest``, whose rows must
   equal the recipe's hand-written manifest; the recipe's rows relabelled
   one BA per class (the two folded classes children of the BAs they fold
   into), their counts through ``generate_training_config --top-n 80`` with
   the two excluded by name (80 bare labels, the two folded by rollups);
   ``classifier_train`` on the generated directory (the operator's edits:
   the manifest, resident bf16, the model name) with ``TRACKING_SYNC_BUCKET``
   set: exit 0, parity <= 1e-6, a 4096 -> 80 head, no sync warning, all
   nine groups in ``metrics_group_seconds`` with the scalars the JAX groups
   emit and no group failure in the CLI's log, every figure the groups draw
   for these inputs (read off the run's tables) either written or named in
   ``figures_not_written`` (the card machine has no matplotlib),
   ``registry_meta.json`` naming the run, and the bucket holding the run
   directory and the registry entry key for key and byte for byte; ``generate_report`` on the run, ``sync_tracking pull``
   into a second root and ``generate_report`` again: equal HTML;
   ``release_artifact`` v1 (exit 0, the registered bytes under
   ``classifier/v1/``), v1 again (exit 1, bucket unchanged);
   ``annotate_image`` (in this process, so the launch counts can be read)
   from ``store://releases/classifier/v1`` and from ``models:/``: 1 crop and
   11 fused launches each, the same labels, scores within 2e-6; and the
   store:// request through the smoke's extractor against ``models:/``
   within 2e-6, 1 crop and 11 fused launches per request. Times: each CLI's
   subprocess wall, the run's ``profiled_sections`` (its downloads over S3
   beside the recipe phase's local ones), requests, objects and bytes
   through the endpoint, the sync's objects and seconds (the training CLI's
   debug log), the releases, the store:// request's p50 (host clock).

14. weights — the fidelity runbook at B0 224, feature_dim 4096 (after
   ``bucket``): a pyspacer-lineage ``efficientnet.pt`` (lukemelas naming in
   CoralNet's ``{'net': {'module.<key>': ...}}`` dict, TF-SAME padding, BN
   eps 1e-3, random weights from a seed) through the port's
   ``diff_backbone --device cuda --save-npz --record`` in a subprocess:
   exit 0, 212 layers each within 5e-4, feature MAE < 1e-4;
   ``release_artifact`` (in this process) with the bundle, its sidecar and
   the record: accepted, and a copy of the bundle with one byte flipped
   refused (exit 1); a 25-point ``AnnotationRun`` from
   ``store://releases/classifier/v1`` over the released bundle in f32 and
   bf16: 1 crop and 11 fused launches each, features against
   ``LukemelasEfficientNetB0.forward`` on pyspacer's own crops f32 MAE <
   1e-4 and bf16 min row cosine >= 0.999. Times: the diff's subprocess
   wall, the release, the phase, and the request's p50 (host clock).
15. quality — the composed chain of ``train/quality_parity.py`` (after
   ``trainer``): ``run_repo_pipeline`` at the CI ``QualityRunSpec()`` on
   the card and on the CPU, the card within the JAX test's bands of the
   CPU (accuracy 0.02, balanced accuracy 0.04, log loss 0.10) and its log
   loss under 0.7 x uniform; then ``quality_parity_bench --repo-only`` at
   its default scale (40,000 x 512, 30 classes) on the card, printing its
   accuracy, balanced accuracy, log loss and wall seconds. sklearn is not
   on the card, so the sklearn side runs in the CPU tests only.
16. jobs — the job layer (last): ``launch_processing`` in a subprocess with
   a run YAML of two workers of the port's ``build_feature_bucket`` (run as
   a file, bf16, ``fused``, the bucket phase's weights) over the bucket
   phase's sources 1 and 2, sharing the card: exit 1, the worker whose
   shard holds the truncated object FAILED, its log and the error log name
   the image, every other image's file equal to the bucket phase's
   single-process file bit for bit at the same dtype, and each worker's
   logged kernel launches one crop per image it extracted and 11 fused per
   128-patch chunk plus 11 for its numerics gate (the workers are other
   processes, so this process's counters cannot see them); the same run
   launched again: exit 1, every worker skipped every done image, no
   file's bytes or ``mtime_ns`` changed, no new progress record, launches
   (0, 11); then the port's ``e2e_smoke --production-backbone`` with the
   bucket phase's weights (the seeded B0 gives every patch nearly the same
   feature, and a head trained on those fails the export gate) over 8
   images of 64 points per source (a head trained on the default 128
   points learns nothing, and its calibration puts its float32 copy past
   the export gate) in a subprocess: exit 0 and ``PASS``. Times: the fan-out's and the
   relaunch's wall from submit to all terminal, each worker's images/s and
   patch-features/s from the progress log (first image to last, and from
   submit), their sum beside the bucket phase's single-process rate, and
   the E2E's ``stage budget:``.
17. drives — the port's at-scale drives at full width and reduced depth, each
   a subprocess as its user runs it: ``feature_bucket_drive`` over 24 JPEGs
   of 1536x2048 / 1440x1920 / 1152x1536 with 200 points each over 4 sources
   (bf16, the fused trunk, the kernel library built once beforehand), a
   clean build, a build SIGKILLed at 40% and its resume: ``ok``, the kill
   mid-run, featsB byte-identical to featsA, no rewrite of a file finished
   before the kill, no failure, no ``.part`` file, the library unchanged by
   the three build processes, and each process's logged launches one crop
   per image it wrote and 11 fused per 128-patch chunk plus 11 for its
   gate; then ``full_recipe_drive`` at 60,000 pool rows x 4096, 80 classes,
   100 points per image, 20 sources, 5 epochs + patience 3, resident int8:
   export parity <= 1e-6 and a finite metric row. The two drives run at
   once. Times (each read with the other drive running): each drive's
   wall, stages, the builds' start and steady rates, the resident budget.
18. parallel — the parallel layer (last), in this process at world size 1
   over NCCL on ``cuda:0`` (``make_mesh(device="cuda")``; NCCL refuses two
   ranks on one card): the mesh extractor (B0 224, 4096-d, ``folded``,
   batch 128, f32 and bf16, 256 points on a 1536x2048 image: one crop
   launch per image) against the single-process ``folded`` extractor, bit
   for bit or within 1e-4 MAE; ``load_sharded_predictor`` over the serve
   phase's 4096 -> (500, 300, 100) -> 80 artifact against ``load_predictor``
   within 1e-6 (1,001 rows); ``ShardedHeadTrainer`` at (1, 1) against one
   ``MLPClassifier`` step at the same width from the same numpy weights
   (loss rel 1e-5, each weight matrix 1e-5 relative Frobenius norm);
   resident training on the mesh (40,000 rows, f32 and int8, captured
   steps with the all-reduce in the graph) against the single-device run at
   the JAX tests' tolerances (losses abs 1e-6, weights rtol 1e-5 / atol
   1e-6), the largest differences printed; ``production_geometry_report``
   at ``C2_GEOMETRY`` (on ``meta``), its ``buffer_gb_per_device`` against
   the allocated bytes of a real 449,099 x 4096 int8 buffer on the mesh;
   the port's ``dryrun_multihost`` with 2 x 2 gloo CPU ranks in a
   subprocess: exit 0 and its marker. Times: ms per Adam step of the mesh
   and single-device captured resident steps (CUDA events around one
   10,000-row call, 50 steps), of the single-device step at batch 100 and
   50 (what one rank of a 2- and a 4-rank mesh would run were batches
   regrouped by owner), and each leg's wall.

After each phase, its seconds (``phase <name>: <s> s``). Then the card's
name and power limit (nvidia-smi), one JSON line of kernel results, and as
the last line ``{"ok": true, "device": {...}}``.

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
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
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


@contextmanager
def restored_env(*names: str):
    """Put the named environment variables back as they were on exit, so a
    phase that sets them leaves no trace in the phases after it."""
    saved = {name: os.environ.get(name) for name in names}
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


@contextmanager
def restored_settings(*names: str):
    """Put the named fields of the port's settings back as they were on
    exit (the store root is a setting: ``get_default_store`` reads
    ``settings.object_store_root`` only)."""
    from mermaid_classifier_tpu_torch.config.settings import override_settings, settings

    with override_settings(**{name: getattr(settings, name) for name in names}):
        yield


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


TRAINER_PACKED_IMAGES, TRAINER_PACKED_EPOCHS = 480, 2


def trainer_packed(labels, kw, tmp: Path, smi: str):
    """Streamed runs over the first TRAINER_PACKED_IMAGES feature files
    (12,000 rows of 4096, split again 0.7 / 0.15 / 0.15), with
    ``packed_cache_dir`` and without it: the
    same loss curve and weights bit for bit, the native row gather in use,
    the packing seconds and the seconds per streamed epoch of each."""
    import numpy as np

    from mermaid_classifier_tpu_torch.data.labels import (
        ImageLabels,
        preprocess_labels,
    )
    from mermaid_classifier_tpu_torch.native.fastbatch import native_available
    from mermaid_classifier_tpu_torch.train.trainer import MermaidTrainer

    if not native_available():
        fail("trainer: the packed cache's native row gather did not build (g++)")
    points_of: dict = {}
    for split in ("train", "ref", "val"):
        for key, anns in getattr(labels, split).data.items():
            points_of.setdefault(key, []).extend(anns)
    keep = sorted(points_of)[:TRAINER_PACKED_IMAGES]
    runs = {}
    for packed in (False, True):
        task = preprocess_labels(ImageLabels({k: points_of[k] for k in keep}),
                                 split_ratios=(0.15, 0.15))
        stamps = []
        trainer = MermaidTrainer(
            **kw, packed_cache_dir=str(tmp / "packed_cache") if packed else None,
            on_epoch_end=lambda m, stamps=stamps: stamps.append(time.perf_counter()))
        t0 = time.perf_counter()
        cal, _, msg = trainer(task, TRAINER_PACKED_EPOCHS, pc_models=[])
        start = t0 + (trainer.packing_seconds or 0.0)
        epochs = np.diff([start, *stamps])
        if packed and not task.train.packed_cache.use_native:
            fail("trainer: the packed run gathered with numpy, not natively")
        runs[packed] = (cal.estimator, msg, trainer.packing_seconds, epochs)
    (plain, pm, _, pe), (fast, fm_, pack_s, fe) = runs[False], runs[True]
    if not (same_weights(plain, fast) and plain.loss_curve_ == fast.loss_curve_
            and pm.ref_accs == fm_.ref_accs):
        fail("trainer: the packed streamed run differs from the file-backed one;"
             " want bitwise")
    n_rows = sum(len(points_of[k]) for k in keep)
    say(f"time trainer packed cache on {smi}: streamed runs over {len(keep)} files"
        f" ({n_rows} rows of {plain.coefs_[0].shape[0]}), {TRAINER_PACKED_EPOCHS}"
        f" epochs each, loss curve and weights bitwise equal, native gather:"
        f" packing {pack_s:.2f} s; s per streamed epoch (train batches + ref and"
        f" val evals, host clock) from the files"
        f" {', '.join(f'{e:.2f}' for e in pe)}, from the packed cache"
        f" {', '.join(f'{e:.2f}' for e in fe)}")


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
    trainer_packed(labels, kw, tmp, smi)

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


RECIPE_ROOTS, RECIPE_GENERA = 4, 10   # top-level BAs, genera under each
RECIPE_GFS = ("gf-br", "gf-ma", "gf-en")
RECIPE_MERMAID_IMAGES, RECIPE_CN_IMAGES, RECIPE_POINTS = 1_200, 200, 25
RECIPE_CN_SOURCE, RECIPE_UNMAPPED = 7, "99999"
RECIPE_SUBSAMPLE_SHARE, RECIPE_EPOCHS, RECIPE_PATIENCE = 0.9, 5, 2
RECIPE_MODEL = "mermaid-recipe-80"
# Largest gap allowed between the logged accuracy (resident bf16 val rows)
# and the registered predictor's over the f32 val rows on disk.
RECIPE_ACC_MARGIN = 0.005
RECIPE_PACKAGES = ("pyarrow", "pandas", "yaml", "psutil", "pydantic", "sklearn",
                   "matplotlib")


def recipe_taxonomy(fixture_dir: Path):
    """The fixture taxonomy of the recipe phase: RECIPE_ROOTS top-level BAs
    with RECIPE_GENERA genera each; every genus with no growth form and
    with one of RECIPE_GFS is a raw class (80), plus two classes the
    rollup folds into others (so 80 remain). Returns (raw classes, rollup
    pairs, CoralNet mapping records)."""
    records, classes = [], []
    for r in range(RECIPE_ROOTS):
        records.append({"id": f"ba-r{r}", "name": f"Category {r}", "parent": None})
        for g in range(RECIPE_GENERA):
            ba = f"ba-r{r}-g{g}"
            records.append({"id": ba, "name": f"Genus {r}.{g}", "parent": f"ba-r{r}"})
            classes += [(ba, ""), (ba, RECIPE_GFS[(r + g) % len(RECIPE_GFS)])]
    folded = [("ba-r0-g0", "gf-ma"), ("ba-r1-g1", "gf-br")]
    rollups = [(folded[0], classes[0]), (folded[1], classes[3])]
    classes += folded
    gfs = {"gf-br": "branching", "gf-ma": "massive", "gf-en": "encrusting"}
    mapping = [
        {"provider_id": str(1000 + i), "provider_label": f"CN{i}",
         "benthic_attribute_id": ba,
         "benthic_attribute_name": next(x["name"] for x in records if x["id"] == ba),
         "growth_form_id": gf or None, "growth_form_name": gfs.get(gf)}
        for i, (ba, gf) in enumerate(classes)
    ]
    fixture_dir.mkdir(parents=True, exist_ok=True)
    (fixture_dir / "benthic_attributes.json").write_text(json.dumps(records))
    (fixture_dir / "growth_forms.json").write_text(json.dumps(gfs))
    (fixture_dir / "label_mappings.json").write_text(json.dumps(mapping))
    return classes, rollups, mapping


def write_recipe_store(root: Path, bucket: str, classes, mapping):
    """The recipe's object store and annotation tables: MERMAID-layout and
    CoralNet-layout feature files of RECIPE_POINTS 4096-d rows each (a
    class mean plus unit noise, as the train phase draws them), and the
    two tables as columns. About 1 in 50 CoralNet points carries the
    unmapped label RECIPE_UNMAPPED. Returns (mermaid columns, manifest
    columns)."""
    import numpy as np

    from mermaid_classifier_tpu_torch.data.features_io import write_feature_file

    rng = np.random.default_rng(SEED + 21)
    dim = 4096
    means = (rng.standard_normal((len(classes), dim)) * TRAIN_MEAN_STD).astype(np.float32)
    rowcols = np.stack([np.arange(RECIPE_POINTS) * 53 + 11,
                        np.arange(RECIPE_POINTS) * 71 + 7], 1).astype(np.int64)
    mermaid = {k: [] for k in ("image_id", "row", "col", "benthic_attribute_id",
                               "growth_form_id")}
    manifest = {k: [] for k in ("source_id", "image_id", "row", "col", "coralnet_id")}

    def features(y):
        x = rng.standard_normal((RECIPE_POINTS, dim), dtype=np.float32)
        x += means[y]
        return x

    for i in range(RECIPE_MERMAID_IMAGES):
        image_id = f"m{i:05d}"
        y = rng.integers(0, len(classes), RECIPE_POINTS)
        write_feature_file(root / bucket / "mermaid" / f"{image_id}.features.npz",
                           rowcols.astype(np.int32), features(y))
        for (r, c), k in zip(rowcols, y):
            ba, gf = classes[k]
            mermaid["image_id"].append(image_id)
            mermaid["row"].append(int(r))
            mermaid["col"].append(int(c))
            mermaid["benthic_attribute_id"].append(ba)
            # MERMAID writes the string 'None' for no growth form.
            mermaid["growth_form_id"].append(gf or "None")
    for i in range(RECIPE_CN_IMAGES):
        image_id = 500_000 + i
        y = rng.integers(0, len(classes), RECIPE_POINTS)
        write_feature_file(
            root / bucket / f"s{RECIPE_CN_SOURCE}" / "features"
            / f"i{image_id}.features.npz", rowcols.astype(np.int32), features(y))
        for (r, c), k in zip(rowcols, y):
            manifest["source_id"].append(RECIPE_CN_SOURCE)
            manifest["image_id"].append(image_id)
            manifest["row"].append(int(r))
            manifest["col"].append(int(c))
            manifest["coralnet_id"].append(
                RECIPE_UNMAPPED if rng.random() < 0.02 else mapping[k]["provider_id"])
    return mermaid, manifest


def write_recipe_tables(tmp: Path, mermaid: dict, manifest: dict):
    """The two annotation tables as parquet, the production route (pyarrow
    imports on the card machine). Returns (mermaid path, manifest path)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    paths = tmp / "mermaid.parquet", tmp / "manifest.parquet"
    for path, cols in zip(paths, (mermaid, manifest)):
        pq.write_table(pa.table(cols), str(path))
    return paths


def phase_recipe(extractor, tmp: Path, smi: str):
    """The training recipe through its programmatic entry point,
    ``TrackingTrainingRunner(...).run()``, at the production head's width
    (4096 -> (500, 300, 100) -> 80, mini-batch 200, lr 1e-4) on a seeded
    store, then the registered model served by ``models:/``. Returns the
    seeded taxonomy, tables and store the lifecycle phase starts from, and
    the run's ``profiled_sections``."""
    import importlib.util
    import os

    import numpy as np
    import torch

    from mermaid_classifier_tpu_torch.common import taxonomy
    from mermaid_classifier_tpu_torch.config.options import (
        DatasetOptions,
        TrackingOptions,
        TrainingOptions,
    )
    from mermaid_classifier_tpu_torch.config.settings import override_settings
    from mermaid_classifier_tpu_torch.data.subsample import SubsampleOptions
    from mermaid_classifier_tpu_torch.inference import load_predictor
    from mermaid_classifier_tpu_torch.ops import fused_mbconv, patch_crop
    from mermaid_classifier_tpu_torch.serve.annotation import AnnotationRun
    from mermaid_classifier_tpu_torch.tracking import LocalTracker
    from mermaid_classifier_tpu_torch.train.class_weights import (
        SampleWeightingOptions,
    )
    from mermaid_classifier_tpu_torch.train.runner import TrackingTrainingRunner

    t0 = time.perf_counter()
    say("recipe: importable on this machine: " + ", ".join(
        f"{p} {'yes' if importlib.util.find_spec(p) else 'no'}"
        for p in RECIPE_PACKAGES))
    base = tmp / "recipe"
    classes, rollups, mapping = recipe_taxonomy(base / "taxonomy")
    os.environ[taxonomy.TAXONOMY_FIXTURE_ENV] = str(base / "taxonomy")
    taxonomy.get_benthic_attribute_library.cache_clear()
    taxonomy.get_growth_form_library.cache_clear()
    taxonomy.get_coralnet_mapping.cache_clear()
    bucket = "recipe-training"
    mermaid, manifest = write_recipe_store(base / "store", bucket, classes, mapping)
    mermaid_path, manifest_path = write_recipe_tables(base, mermaid, manifest)
    rollup_csv = base / "rollups.csv"
    rollup_csv.write_text("from_ba_id,from_gf_id,to_ba_id,to_gf_id\n" + "".join(
        f"{a},{b},{c},{d}\n" for (a, b), (c, d) in rollups))
    n_rows = len(mermaid["image_id"]) + len(manifest["image_id"])
    n_unmapped = manifest["coralnet_id"].count(RECIPE_UNMAPPED)
    write_s = time.perf_counter() - t0
    say(f"recipe: store of {RECIPE_MERMAID_IMAGES} MERMAID + {RECIPE_CN_IMAGES}"
        f" CoralNet feature files, {n_rows} rows of 4096 ({n_unmapped} with the"
        f" unmapped label), {len(classes)} raw classes, 2 rolled up; written in"
        f" {write_s:.1f} s")

    tracker = LocalTracker(base / "tracking")
    with override_settings(
        object_store_root=str(base / "store"),
        coralnet_train_data_bucket=bucket,
        mermaid_train_data_bucket=bucket,
        mermaid_annotations_parquet_pattern=str(mermaid_path),
        feature_cache_dir=str(base / "feature_cache"),
        tracking_dir=str(tracker.root),
    ):
        runner = TrackingTrainingRunner(
            DatasetOptions(
                coralnet_manifest_uri=str(manifest_path),
                label_rollup_spec_csv=str(rollup_csv),
                subsample=SubsampleOptions(
                    strategy="stratified",
                    total_annotations=int((n_rows - n_unmapped)
                                          * RECIPE_SUBSAMPLE_SHARE)),
                weighting=SampleWeightingOptions(enabled=True, weight_ratio_cap=10.0),
            ),
            TrainingOptions(epochs=RECIPE_EPOCHS,
                            early_stopping_patience=RECIPE_PATIENCE,
                            device_resident=True, resident_dtype="bfloat16",
                            calibration_backend="device"),
            tracking_options=TrackingOptions(experiment_name="recipe",
                                             model_name=RECIPE_MODEL),
            tracker=tracker,
            device="cuda",
        )
        t1 = time.perf_counter()
        msg, registered = runner.run()
        run_s = time.perf_counter() - t1

        ds = runner.dataset
        run = tracker.runs("recipe")[-1]
        params, metrics = run.params(), run.latest_metrics()
        if "training_set" not in ds.db.columns("annotations"):
            fail("recipe: the annotations table carries no training_set column")
        splits = {s: getattr(ds.labels, s).label_count for s in ("train", "ref", "val")}
        if min(splits.values()) <= 0:
            fail(f"recipe: an empty split {splits}")
        if len(ds.labels.ref.classes_set) != 80:
            fail(f"recipe: {len(ds.labels.ref.classes_set)} classes after the rollup,"
                 " want 80")
        if params.get("artifact_eval_inputs") != "resident(bfloat16)":
            fail(f"recipe: artifact_eval_inputs is"
                 f" {params.get('artifact_eval_inputs')!r}, want 'resident(bfloat16)'")
        parity = metrics.get("export_parity_max_abs_diff")
        if parity is None or not parity <= 1e-6:
            fail(f"recipe: export parity {parity} (want <= 1e-6)")
        want = ("balanced_accuracy", "mcc", "precision_macro", "recall_macro",
                "f1_macro", "log_loss")
        missing = [m for m in want if m not in metrics]
        if missing:
            fail(f"recipe: metric groups logged no {missing}")
        meta = json.loads((registered / "registry_meta.json").read_text())
        if meta["run_id"] != run.run_id or meta["name"] != RECIPE_MODEL:
            fail(f"recipe: registry_meta.json {meta} does not name run {run.run_id}")

        # The registered predictor over the val rows on the card: the rows
        # the trainer evaluated (its bf16 resident rows, one gather), and
        # the f32 rows on disk.
        predictor = load_predictor(registered, device="cuda")
        classes_arr = np.asarray(predictor.classes_)
        res = runner._trainer.resident_artifact_val_proba(
            runner._clf_calibrated.estimator, ds.labels.val,
            predictor.head_params.as_tensors("cuda"))
        proba_res, gt = res
        acc_res = float(np.mean(classes_arr[proba_res.argmax(1)] == np.asarray(gt)))
        x_val, y_val = ds.labels.val.load_all()
        proba_disk = predictor.predict_proba(x_val)
        acc_disk = float(np.mean(classes_arr[proba_disk.argmax(1)] == np.asarray(y_val)))
        if round(acc_res, 4) != metrics["accuracy"]:
            fail(f"recipe: logged accuracy {metrics['accuracy']} but the registered"
                 f" predictor's argmax accuracy over the resident val rows is"
                 f" {acc_res}")
        # The same predictor over the f32 rows read from disk, a route
        # independent of the resident gather: bf16 against f32 rows may flip
        # a few rows near a class boundary, not more than RECIPE_ACC_MARGIN.
        if not abs(acc_disk - metrics["accuracy"]) <= RECIPE_ACC_MARGIN:
            fail(f"recipe: logged accuracy {metrics['accuracy']} but the registered"
                 f" predictor's argmax accuracy over the f32 disk rows is"
                 f" {acc_disk} (want within {RECIPE_ACC_MARGIN})")

        # models:/ serving through the crop and fused kernels.
        rng = np.random.default_rng(SEED + 22)
        h, w = IMAGE_HW
        served = []
        for i, spec in enumerate((f"models:/{RECIPE_MODEL}",
                                  f"models:/{RECIPE_MODEL}/v1")):
            image = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            pts = points(rng, 25)
            csv_path = base / f"serve_{i}.csv"
            write_points(csv_path, pts)
            ann = AnnotationRun(image, csv_path, spec, extractor=extractor)
            patch_crop.launches = 0
            fused_mbconv.launches = 0
            ann.run()
            launches = (patch_crop.launches, fused_mbconv.launches)
            torch.cuda.synchronize()
            if launches != (1, 11):
                fail(f"recipe: {spec} launched (crop, fused) {launches}, want (1, 11)")
            check_run(ann, 25, list(predictor.classes_), ann.top_n)
            feats = extractor.extract_features(image, np.asarray(pts, np.int32))
            diff = float(np.abs(ann.proba - predictor.predict_proba(feats)).max())
            if not diff <= 2e-6:
                fail(f"recipe: {spec} scores {diff:.3e} from the registered"
                     " predictor on extract_features (want <= 2e-6)")
            served.append((spec, launches, diff))

    say(f"recipe: TrackingTrainingRunner.run() {run_s:.1f} s; splits {splits};"
        f" {len(ds.labels.ref.classes_set)} classes; epochs run"
        f" {len(msg.ref_accs)}; accuracy {metrics['accuracy']} (registered"
        f" predictor over the resident bf16 val rows {acc_res:.4f}, over the f32"
        f" disk rows {acc_disk:.4f}, within {RECIPE_ACC_MARGIN}); export parity {parity:.3e} (<= 1e-6);"
        f" balanced_accuracy {metrics['balanced_accuracy']}, mcc {metrics['mcc']},"
        f" f1_macro {metrics['f1_macro']}, log_loss {metrics['log_loss']:.4f};"
        f" artifact_eval_inputs {params['artifact_eval_inputs']}; registered"
        f" {registered.parent.name}/{registered.name} for run {run.run_id}")
    for spec, launches, diff in served:
        say(f"recipe: {spec} served 25 points, launches crop={launches[0]}"
            f" fused={launches[1]}, max |dp| vs the registered predictor on"
            f" extract_features {diff:.3e} (<= 2e-6)")
    say(f"time recipe on {smi}: profiled_sections (s): " + ", ".join(
        f"{s['name']} {s['seconds']}" for s in runner.profiled_sections))
    say(f"time recipe on {smi}: metrics_group_seconds: "
        + json.dumps(json.loads(run.artifact("metrics_group_seconds.json").read_text())))
    say(f"time recipe on {smi}: resident_timings: "
        + json.dumps(runner._resident_timings))
    sections = list(runner.profiled_sections)
    runner.dataset.cleanup()
    del runner, predictor
    torch.cuda.empty_cache()

    job_s = recipe_entrypoint(base)
    wall = time.perf_counter() - t0
    say(f"time recipe on {smi}: phase wall {wall:.1f} s (store and tables"
        f" {write_s:.1f} s, runner {run_s:.1f} s, entrypoint {job_s:.1f} s)")
    return {"classes": classes, "rollups": rollups, "mapping": mapping,
            "mermaid": mermaid, "manifest": manifest, "store": base / "store",
            "bucket": bucket, "sections": sections}


# Figures each metric group draws, in log order, with the table that says
# whether it draws it for a run's inputs: None (always), "rows" (the table
# has rows), "rows>1", or "cover" (a class above 0.5% mean cover).
RECIPE_FIGURES = (
    ("confusion_matrix/frequencies.png", None, None),
    ("confusion_matrix/percents.png", None, None),
    ("taxonomic/error_attribution.png", "taxonomic/error_attribution.csv", "rows"),
    ("taxonomic/top_level_confusion.png", None, None),
    ("taxonomic/gf_confusion.png", "taxonomic/gf_precision_recall_f1.csv", "rows"),
    ("calibration/reliability_diagram.png", None, None),
    ("cover/per_class_bias.png", "cover/per_class_cover_metrics.csv", "cover"),
    ("per_source/accuracy_by_source.png", "per_source/metrics.csv", "rows>1"),
    ("probability/per_category_log_loss.png",
     "probability/per_category_log_loss.csv", "rows"),
    ("ranking/per_category_topk.png", "ranking/per_category_topk.csv", "rows"),
)
# The scalars each of the nine groups logs (confusion_matrices logs tables
# only), as the JAX groups emit them.
RECIPE_GROUP_SCALARS = {
    "confusion_matrices": (),
    "precision_recall_f1": ("precision_macro", "recall_macro", "f1_macro"),
    "balanced_accuracy_mcc": ("balanced_accuracy", "mcc"),
    "taxonomic": ("cross_branch_error_rate", "within_branch_error_rate",
                  "gf_accuracy_gf_relevant", "within_ba_gf_accuracy"),
    "calibration": ("ece",),
    "cover": ("cover_mean_abs_bias_pct", "cover_mean_rmse_pct", "cover_mean_mae_pct",
              "cover_median_r_squared"),
    "per_source": ("per_source/n_sources", "per_source/min_accuracy",
                   "per_source/max_accuracy"),
    "probability": ("log_loss",),
    "ranking": ("top_1_accuracy", "top_3_accuracy", "top_5_accuracy",
                "top_10_accuracy", "mrr", "hierarchical_top_5_mean_similarity"),
}
def expected_figures(run) -> list[str]:
    """The figures the nine groups draw for this run's inputs, read off the
    run's tables (RECIPE_FIGURES)."""
    import csv

    out = []
    for figure, table, rule in RECIPE_FIGURES:
        if table is not None:
            path = run.artifact(table)
            rows = list(csv.DictReader(path.open())) if path.is_file() else []
            if rule == "cover":
                drawn = any(float(r["mean_true_cover_pct"]) > 0.5 for r in rows)
            else:
                drawn = len(rows) > (1 if rule == "rows>1" else 0)
            if not drawn:
                continue
        out.append(figure)
    return out


def check_cli_run(run, tracker, model: str, where: str, cli_log: str) -> dict:
    """What a ``classifier_train`` run must leave in its tracking dir: no
    group failure in the CLI's log, all nine groups in
    ``metrics_group_seconds`` with the scalars the JAX groups emit, the
    confusion tables, every figure the groups draw for these inputs
    written or named in ``figures_not_written`` (the card machine has no
    matplotlib), parity <= 1e-6, and ``registry_meta.json`` naming the run.
    Returns the run's metrics and params and the registered version."""
    from mermaid_classifier_tpu_torch.metrics import REPORT_ORDER

    if "Metric group" in cli_log:
        print(cli_log[-8000:], file=sys.stderr)
        fail(f"{where}: a metric group failed (its warning is in the CLI's log)")
    metrics, params = run.latest_metrics(), run.params()
    seconds = json.loads(run.artifact("metrics_group_seconds.json").read_text())
    if list(seconds) != list(REPORT_ORDER):
        fail(f"{where}: metrics_group_seconds names {list(seconds)}, want all"
             f" nine groups {list(REPORT_ORDER)}")
    missing = {g: [m for m in names if m not in metrics]
               for g, names in RECIPE_GROUP_SCALARS.items()}
    missing = {g: m for g, m in missing.items() if m}
    if missing:
        fail(f"{where}: groups logged no {missing}")
    for table in ("confusion_matrix/frequencies.csv", "confusion_matrix/percents.csv"):
        if not run.artifact(table).is_file():
            fail(f"{where}: confusion_matrices wrote no {table}")
    want_figs = expected_figures(run)
    pngs = [p for p in run.list_artifacts() if p.endswith(".png")]
    named = params.get("figures_not_written")
    if named is not None:
        if named.split(", ") != want_figs or pngs:
            fail(f"{where}: figures_not_written {named!r} (PNGs {pngs}), want"
                 f" exactly {want_figs}")
    elif sorted(pngs) != sorted(want_figs):
        fail(f"{where}: PNGs {pngs}, want {want_figs}")
    registered = tracker.latest_model_version(model)
    meta = json.loads((registered / "registry_meta.json").read_text())
    if meta["run_id"] != run.run_id:
        fail(f"{where}: registry_meta.json {meta} does not name run {run.run_id}")
    parity = metrics.get("export_parity_max_abs_diff")
    if parity is None or not parity <= 1e-6:
        fail(f"{where}: export parity {parity} (want <= 1e-6)")
    say(f"{where}: nine groups timed; ece {metrics['ece']:.4f}, top_5_accuracy"
        f" {metrics['top_5_accuracy']:.4f}, mrr {metrics['mrr']:.4f},"
        f" cross_branch_error_rate {metrics['cross_branch_error_rate']:.4f},"
        f" cover_mean_rmse_pct {metrics['cover_mean_rmse_pct']:.4f},"
        f" per_source/n_sources {metrics['per_source/n_sources']:.0f}")
    if named is not None:
        say(f"{where}: figures_not_written ({len(want_figs)}, matplotlib does not"
            f" import here): {named}")
    else:
        say(f"{where}: {len(pngs)} figures written: {', '.join(sorted(pngs))}")
    say(f"{where}: metrics_group_seconds: {json.dumps(seconds)}")
    return {"metrics": metrics, "params": params, "registered": registered}


def recipe_entrypoint(base: Path) -> float:
    """``train_job_entrypoint`` on a config with an unknown key prints
    ``==== FAIL load_config`` and exits 1. Returns the seconds taken."""
    bad = base / "bad_config"
    bad.mkdir()
    (bad / "training_config.yaml").write_text(
        "training: {epochs: 2}\nnot_a_real_block: {}\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(Path(__file__).resolve().parent), env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    job = subprocess.run(
        [sys.executable, "-m", "mermaid_classifier_tpu_torch.scripts.train_job_entrypoint",
         "--config-dir", str(bad)], cwd=base, env=env, capture_output=True, text=True,
        timeout=300)
    job_s = time.perf_counter() - t0
    if job.returncode != 1 or "==== FAIL load_config" not in job.stdout:
        print(job.stdout[-4000:], job.stderr[-4000:], file=sys.stderr)
        fail(f"recipe: train_job_entrypoint on an unknown key exited"
             f" {job.returncode} (want 1 with '==== FAIL load_config')")
    say(f"recipe: train_job_entrypoint on a config with an unknown key:"
        f" '==== FAIL load_config', exit 1, in {job_s:.1f} s")
    return job_s


BUCKET_IMAGES, BUCKET_POINTS = 24, (25, 200)  # per source; points per image
BUCKET_CLASSES = ((200, 60, 40), (40, 190, 70), (60, 80, 220), (230, 200, 40),
                  (150, 60, 190), (40, 200, 210), (240, 130, 30), (235, 235, 235))
BUCKET_CORRUPT = "1005"
BUCKET_GRID = (12, 17)  # cells of 128 x 120 px over the 1536 x 2048 image
BUCKET_EPOCHS = 20


def bucket_image(rng, n: int):
    """A seeded IMAGE_HW image and n points: each point at a jittered
    grid-cell center (the outer cells' within 112 px of an edge), its cell
    painted its class colour over a textured background, as
    scripts/e2e_smoke.py paints its classes. Returns (image, rowcols,
    class indices)."""
    import numpy as np

    h, w = IMAGE_HW
    gr, gc = BUCKET_GRID
    ch, cw = h // gr, w // gc
    image = rng.integers(90, 140, size=(h, w, 3), dtype=np.uint8)
    cells = np.sort(rng.choice(gr * gc, n, replace=False))
    cls = rng.integers(0, len(BUCKET_CLASSES), n)
    rowcols = np.empty((n, 2), np.int32)
    for i, (cell, k) in enumerate(zip(cells, cls)):
        r0, c0 = (cell // gc) * ch, (cell % gc) * cw
        color = np.asarray(BUCKET_CLASSES[k]) + rng.integers(-20, 21, 3)
        image[r0:r0 + ch, c0:c0 + cw] = np.clip(color, 0, 255).astype(np.uint8)
        rowcols[i] = (r0 + ch // 2 + rng.integers(-(ch // 6), ch // 6 + 1),
                      c0 + cw // 2 + rng.integers(-(cw // 6), cw // 6 + 1))
    order = rng.permutation(n)  # file order is not cell order
    return image, rowcols[order], cls[order]


def write_bucket_sources(store, rng, encode):
    """Source "1" in the canonical layout (24 images, one corrupt object),
    source "2" as a CoralNet export (24 images, image_list.csv with status
    suffixes, two rows naming no listed image) and source "3": four of
    source 1's good images with their rows, for the f32 run. Returns
    {(source, image_id): (image key, rowcols, class indices)} of the
    images that should extract."""
    import numpy as np

    truth = {}
    rows1 = ["image_id,image_key,row,col"]
    rows2 = ["Name,Row,Column"]
    listing = ["Name,Image Page,Image URL"]
    for s, source in enumerate(("1", "2")):
        for i in range(BUCKET_IMAGES):
            image, rowcols, cls = bucket_image(
                rng, int(rng.integers(BUCKET_POINTS[0], BUCKET_POINTS[1] + 1)))
            image_id = f"{source}{i:03d}"
            key = (f"s1/images/{image_id}.jpg" if source == "1"
                   else f"s2/images/{image_id}.jpg")
            data = encode(image)
            if image_id == BUCKET_CORRUPT:
                data = data[: len(data) // 3]  # a truncated object
            else:
                truth[(source, image_id)] = (key, rowcols, cls)
            store.put_bytes("src", key, data)
            if source == "1":
                rows1 += [f"{image_id},{key},{r},{c}" for r, c in rowcols]
            else:
                name = f"IMG_{i:04d}.JPG"
                status = ("Confirmed", "Unconfirmed", "Unclassified")[i % 3]
                listing.append(f"{name} - {status},/image/{image_id}/view/,")
                rows2 += [f"{name},{r},{c}" for r, c in rowcols]
                if i in (3, 17):
                    rows2.append(f"GHOST_{i}.JPG,5,5")
    store.put_bytes("src", "s1/annotations.csv", ("\n".join(rows1) + "\n").encode())
    store.put_bytes("src", "s2/annotations.csv", ("\n".join(rows2) + "\n").encode())
    store.put_bytes("src", "s2/image_list.csv", ("\n".join(listing) + "\n").encode())
    f32_ids = sorted(i for s, i in truth if s == "1")[:4]
    rows3 = ["image_id,image_key,row,col"]
    for image_id in f32_ids:
        key, rowcols, _ = truth[("1", image_id)]
        rows3 += [f"{image_id},{key},{r},{c}" for r, c in rowcols]
    store.put_bytes("src", "s3/annotations.csv", ("\n".join(rows3) + "\n").encode())
    return truth, f32_ids


# BatchNorm variances of the bucket's weights, as a multiple of those of
# the calibration batch: a little wider than the batch's own keeps the
# random trunk from amplifying bf16 rounding past the 0.999 gate against
# f32 (the phase checks it), while its rows stay apart (the phase prints
# how far).
BUCKET_VAR_GAIN = 1.1


def bn_calibrated(variables, config, patches):
    """A copy of ``variables`` whose BatchNorm statistics are those of the
    activations that ``patches`` produce, layer by layer (one train-mode
    pass with momentum 1), as a trained network's are, with the variances
    widened by ``BUCKET_VAR_GAIN``. The seeded statistics give every patch
    nearly the same feature (``row_spread``, printed by the bucket
    phase), which no head can learn from."""
    import copy

    import torch

    from mermaid_classifier_tpu_torch.models.efficientnet import (
        EfficientNetBackbone,
        load_jax_variables,
    )
    from mermaid_classifier_tpu_torch.ops.fused_mbconv import full_f32

    module = EfficientNetBackbone(config)
    load_jax_variables(module, variables)
    module = module.to(patches.device)
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    module.train()
    with torch.no_grad(), full_f32():
        module(patches.float())
    out = copy.deepcopy(variables)
    for key, val in module.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            node = out["batch_stats"]
            for part in key.split(".")[:-2]:
                node = node[part]
            if key.endswith("mean"):
                node["bn"]["mean"] = val.cpu().numpy()
            else:
                node["bn"]["var"] = val.cpu().numpy() * BUCKET_VAR_GAIN
    return out


def row_spread(features) -> float:
    """Mean distance between the rows of ``features`` over their mean norm."""
    import numpy as np

    diff = features[:, None, :] - features[None, :, :]
    n = len(features)
    mean_dist = np.linalg.norm(diff, axis=2).sum() / (n * (n - 1))
    return float(mean_dist / np.linalg.norm(features, axis=1).mean())


def bucket_features(store, bucket, source, image_id):
    import io

    from mermaid_classifier_tpu_torch.data.feature_bucket import feature_key
    from mermaid_classifier_tpu_torch.data.features_io import read_feature_file

    return read_feature_file(io.BytesIO(
        store.get_bytes(bucket, feature_key(source, image_id))))


class StageClock:
    """Host seconds per stage, summed over threads."""

    def __init__(self):
        import collections
        import threading

        self.seconds = collections.defaultdict(float)
        self._lock = threading.Lock()

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with self._lock:
                    self.seconds[name] += time.perf_counter() - t0
        return timed


def timed_bucket_run(store_root, extractor, target, clock=None, profile=False,
                     decode=None):
    """One builder run over sources 1 and 2 into ``target`` (no numerics
    gate), with the host stages timed by ``clock`` and ``decode`` in place
    of the default decoder: (wall s, result, torch.profiler or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from mermaid_classifier_tpu_torch.data.feature_bucket import (
        FeatureBucketBuilder,
    )
    from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
    from mermaid_classifier_tpu_torch.serve.image_sources import decode_image_bytes

    store = LocalFSObjectStore(store_root)
    decode = decode or decode_image_bytes
    if clock is not None:
        store.get_bytes = clock.wrap("fetch", store.get_bytes)
        decode = clock.wrap("decode", decode)
        extractor._upload = clock.wrap("upload", extractor._upload)
        dispatch = clock.wrap("dispatch", type(extractor).extract_features_async)

        def extract_async(image, rowcols):
            readback = dispatch(extractor, image, rowcols)
            readback.wait = clock.wrap("readback", readback.wait)
            return readback

        extractor.extract_features_async = extract_async
    builder = FeatureBucketBuilder(store, "src", target, extractor,
                                   decode_image=decode)
    if clock is not None:
        builder._write_features = clock.wrap("write", builder._write_features)
    torch.cuda.synchronize()
    prof = torch_profile(activities=[ProfilerActivity.CUDA]) if profile else None
    if prof is not None:
        prof.__enter__()
        # A first kernel for the trace to start on: one run's trace missed
        # the first of its 47 crop kernels while the wrapper counted 47.
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = builder.run(["1", "2"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    for name in ("_upload", "extract_features_async"):
        extractor.__dict__.pop(name, None)
    return wall, result, prof


def phase_bucket(variables, config, tmp: Path, smi: str, trunk_rates: dict):
    """The bulk extraction lane at full width (B0 224, 4096-d, fused):
    the port's build_feature_bucket CLI in bf16 over a seeded local store,
    resume and no-skip runs, an f32 run, timed and profiled builder runs,
    then the bucket's files through MermaidTrainer, the gated export,
    the predict_features CLI and AnnotationRun."""
    import csv
    import io
    from dataclasses import replace

    import numpy as np
    import torch

    from mermaid_classifier_tpu_torch.config.settings import settings
    from mermaid_classifier_tpu_torch.data.feature_bucket import feature_key
    from mermaid_classifier_tpu_torch.data.labels import (
        ImageLabels,
        preprocess_labels,
    )
    from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
    from mermaid_classifier_tpu_torch.inference import (
        export_artifact,
        load_predictor,
    )
    from mermaid_classifier_tpu_torch.models.convert import save_backbone_npz
    from mermaid_classifier_tpu_torch.models.extractor import build_extractor
    from mermaid_classifier_tpu_torch.ops import fused_mbconv, patch_crop
    from mermaid_classifier_tpu_torch.scripts import build_feature_bucket
    from mermaid_classifier_tpu_torch.scripts import predict_features
    from mermaid_classifier_tpu_torch.serve.annotation import AnnotationRun
    from mermaid_classifier_tpu_torch.serve.batch_predict import (
        predict_feature_files,
        write_predictions_csv,
    )
    from mermaid_classifier_tpu_torch.serve.image_sources import (
        ImageFetcher,
        decode_image_bytes,
    )
    from mermaid_classifier_tpu_torch.train.trainer import MermaidTrainer

    try:
        from PIL import Image
    except ImportError:
        Image = None

    def encode(image):
        buf = io.BytesIO()
        if Image is None:
            np.save(buf, image)
        else:
            Image.fromarray(image).save(buf, format="JPEG", quality=92)
        return buf.getvalue()

    phase_t0 = time.perf_counter()
    fmt = "JPEG (Pillow)" if Image is not None else ".npy bytes (no Pillow)"
    root = tmp / "bucket_store"
    store = LocalFSObjectStore(root)
    rng = np.random.default_rng(SEED + 12)
    t0 = time.perf_counter()
    truth, f32_ids = write_bucket_sources(store, rng, encode)
    setup_s = time.perf_counter() - t0
    n_images = len(truth)
    n_points = sum(len(rc) for _, rc, _ in truth.values())
    chunks = sum(-(-len(rc) // 128) for _, rc, _ in truth.values())
    # The bucket's weights: the seeded ones with their BatchNorm statistics
    # taken from 96 patches of two images outside the store.
    ext32 = build_extractor(variables, config, device="cuda")
    calib = []
    for _ in range(2):
        image, rowcols, _ = bucket_image(rng, 48)
        calib.append(ext32.extract_patches(image, rowcols))
    calib = torch.cat(calib)
    seeded = ext32.features_for_patches(calib[:16])
    variables = bn_calibrated(variables, config, calib)
    calibrated = build_extractor(variables, config, device="cuda").features_for_patches(
        calib[:16])
    del ext32, calib
    say(f"bucket: rows of 16 patches lie {row_spread(seeded):.2e} of their norm"
        f" apart with the seeded BatchNorm statistics, {row_spread(calibrated):.2e}"
        f" with the bucket's (statistics of 96 of its patches, variances"
        f" x{BUCKET_VAR_GAIN})")
    weights = tmp / "b0_weights.npz"
    save_backbone_npz(str(weights), variables, config)
    settings.object_store_root = str(root)
    say(f"bucket: store of {n_images + 1} images ({fmt}, {IMAGE_HW[0]}x"
        f"{IMAGE_HW[1]}) over sources 1 (canonical, one corrupt) and 2"
        f" (CoralNet export), {n_points} points in {chunks} 128-patch chunks,"
        f" written in {setup_s:.1f} s")

    logs = tmp / "bucket_logs"

    def cli(*extra, target="bf16"):
        argv = ["--source-bucket", "src", "--target-bucket", target,
                "--backbone-weights", str(weights),
                "--progress-log", str(logs / f"{target}.jsonl"),
                "--error-log", str(logs / f"{target}.csv"), *extra]
        t1 = time.perf_counter()
        rc = build_feature_bucket.main(argv)
        torch.cuda.synchronize()
        return rc, time.perf_counter() - t1

    def progress(target):
        path = logs / f"{target}.jsonl"
        return ([json.loads(line) for line in path.read_text().splitlines()]
                if path.exists() else [])

    def errors(target):
        with open(logs / f"{target}.csv", newline="") as fh:
            return list(csv.DictReader(fh))

    # 1. The bf16 run through the CLI: the automatic cosine gate, one failure.
    patch_crop.launches = fused_mbconv.launches = 0
    rc, cli_s = cli("--source-ids", "1,2", "--compute-dtype", "bfloat16")
    launches = (patch_crop.launches, fused_mbconv.launches)
    if rc != 1:
        fail(f"bucket: the bf16 CLI run exited {rc}, want 1 (one corrupt image)")
    records = progress("bf16")
    if [e["image_id"] for e in errors("bf16")] != [BUCKET_CORRUPT]:
        fail(f"bucket: error log {errors('bf16')}")
    done = {(r["source_id"], r["image_id"]): r["points"] for r in records}
    want_done = {k: len(rc_) for k, (_, rc_, _) in truth.items()}
    if done != want_done or len(records) != n_images:
        fail(f"bucket: progress records {len(records)} (want {n_images}),"
             f" points {sum(done.values())} (want {n_points})")
    # The gate runs 8 patches through the trunk: 11 more fused launches.
    if launches != (n_images, 11 * chunks + 11):
        fail(f"bucket: launches (crop, fused) {launches}, want"
             f" ({n_images}, {11 * chunks + 11})")
    for (source, image_id), (_, rowcols, _) in truth.items():
        got_rc, feats = bucket_features(store, "bf16", source, image_id)
        if not np.array_equal(got_rc, rowcols) or not np.isfinite(feats).all() \
                or feats.shape != (len(rowcols), config.feature_dim):
            fail(f"bucket: file {source}/{image_id} rowcols or features wrong")
    bf16_config = replace(config, compute_dtype="bfloat16")
    extractor = build_extractor(variables, bf16_config, device="cuda")
    spot = sorted(truth)[:: len(truth) // 4][:4]
    for source, image_id in spot:
        key, rowcols, _ = truth[(source, image_id)]
        image = decode_image_bytes(store.get_bytes("src", key))
        _, feats = bucket_features(store, "bf16", source, image_id)
        if not np.array_equal(feats, extractor.extract_features(image, rowcols)):
            fail(f"bucket: {source}/{image_id} differs from extract_features")
    say(f"bucket: bf16 CLI run (cosine gate on) exit 1, {len(records)} images"
        f" and {sum(done.values())} points done, the corrupt image {BUCKET_CORRUPT}"
        f" in the error log; every file's rowcols equal its annotations in file"
        f" order; {len(spot)} files equal extract_features bit for bit;"
        f" launches crop={launches[0]} fused={launches[1]} (11 x {chunks}"
        f" chunks + 11 for the gate); {cli_s:.2f} s with the extractor's build"
        f" and the gate")

    # 2. Resume: nothing written; then --no-skip-existing rewrites all.
    keys = [k for k in store.list_keys("bf16") if k.endswith(".features.npz")]
    mtimes = {k: store._path("bf16", k).stat().st_mtime_ns for k in keys}
    rc, resume_s = cli("--source-ids", "1,2", "--compute-dtype", "bfloat16")
    after = {k: store._path("bf16", k).stat().st_mtime_ns for k in keys}
    if rc != 1 or after != mtimes or len(progress("bf16")) != n_images \
            or len(errors("bf16")) != 2:
        fail(f"bucket: resume exit {rc}, files rewritten"
             f" {sum(after[k] != mtimes[k] for k in keys)}, progress"
             f" {len(progress('bf16'))}, errors {len(errors('bf16'))}")
    rc, noskip_s = cli("--source-ids", "1,2", "--compute-dtype", "bfloat16",
                       "--no-skip-existing")
    after = {k: store._path("bf16", k).stat().st_mtime_ns for k in keys}
    if rc != 1 or any(after[k] <= mtimes[k] for k in keys) \
            or len(progress("bf16")) != 2 * n_images:
        fail(f"bucket: --no-skip-existing exit {rc}, rewrote"
             f" {sum(after[k] > mtimes[k] for k in keys)} of {len(keys)}")
    say(f"bucket: resume wrote nothing ({len(keys)} files' mtimes unchanged, the"
        f" corrupt image failed again, {resume_s:.2f} s); --no-skip-existing"
        f" rewrote all {len(keys)} ({noskip_s:.2f} s)")

    # 3. f32 over four images into a second bucket, against bf16.
    rc, f32_cli_s = cli("--source-ids", "3", "--compute-dtype", "float32",
                        target="f32")
    if rc != 0:
        fail(f"bucket: the f32 CLI run exited {rc}")
    cos = min(min_row_cosine(bucket_features(store, "bf16", "1", i)[1],
                             bucket_features(store, "f32", "3", i)[1])
              for i in f32_ids)
    if not cos >= 0.999:
        fail(f"bucket: bf16 against f32 min row cosine {cos} (>= 0.999)")
    say(f"bucket: f32 CLI run over {len(f32_ids)} images: bf16 against f32 min"
        f" row cosine {cos:.6f} (>= 0.999)")

    # 4. Times: the builder with its host stages timed, in bf16 and f32;
    # then a profiled bf16 run for the device's busy share and the kernels.
    rates = {}
    for dtype in ("bfloat16", "float32"):
        ext = build_extractor(variables, replace(config, compute_dtype=dtype),
                              device="cuda")
        timed_bucket_run(root, ext, f"warm-{dtype}")  # first-use costs
        clock = StageClock()
        wall, result, _ = timed_bucket_run(root, ext, f"timed-{dtype}", clock)
        if result.sources[0].images_failed != 1 or sum(
                s.images_done for s in result.sources) != n_images:
            fail(f"bucket: timed {dtype} run {result.describe()}")
        rates[dtype] = (wall, n_images / wall, n_points / wall, dict(clock.seconds))
    # The same bf16 run with every image decoded beforehand (the decoder
    # returns the stored array): the main thread's dispatch without the
    # decode threads beside it.
    decoded = {}
    for key, _, _ in truth.values():
        data = store.get_bytes("src", key)
        decoded[len(data)] = decode_image_bytes(data)
    if len(decoded) != n_images:
        fail("bucket: two images' encoded sizes coincide")
    ext = build_extractor(variables, bf16_config, device="cuda")
    clock = StageClock()
    wall, _, _ = timed_bucket_run(root, ext, "predecoded", clock,
                                  decode=lambda data: decoded[len(data)])
    rates["bfloat16, decoded beforehand"] = (
        wall, n_images / wall, n_points / wall, dict(clock.seconds))
    del decoded, ext
    torch.cuda.synchronize()
    patch_crop.launches = fused_mbconv.launches = 0
    wall_p, _, prof = timed_bucket_run(root, extractor, "profiled", profile=True)
    if (patch_crop.launches, fused_mbconv.launches) != (n_images, 11 * chunks):
        fail(f"bucket: the profiled run launched (crop, fused)"
             f" ({patch_crop.launches}, {fused_mbconv.launches}), want"
             f" ({n_images}, {11 * chunks})")
    from torch.autograd import DeviceType

    counts, busy_us = {"crop_kernel": 0, "expand_dw_kernel": 0}, 0.0
    for ev in prof.events():
        if getattr(ev, "device_type", None) != DeviceType.CUDA or getattr(
                ev, "is_user_annotation", False):
            continue
        busy_us += ev.time_range.elapsed_us()
        for name in counts:
            counts[name] += name in ev.name
    if counts["crop_kernel"] != n_images or counts["expand_dw_kernel"] != 11 * chunks:
        fail(f"bucket: profiled kernels {counts}, want crop {n_images},"
             f" expand_dw {11 * chunks}")
    say(f"time bucket on: {smi}")
    for dtype, (wall, ims, pfs, stages) in rates.items():
        trunk = trunk_rates[(dtype.split(",")[0], "fused")]
        say(f"time bucket {dtype} builder run ({n_images} images, {n_points}"
            f" points, {fmt}, 8 decode threads, prefetch 16): {wall:.3f} s,"
            f" {ims:.2f} images/s, {pfs:.1f} patch-features/s against the trunk"
            f" alone at batch 128 {trunk:.1f} ({pfs / trunk:.1%} of it); host s"
            f" (summed over threads): fetch {stages.get('fetch', 0):.3f}, decode"
            f" {stages.get('decode', 0):.3f}, upload {stages.get('upload', 0):.3f},"
            f" dispatch without upload"
            f" {stages.get('dispatch', 0) - stages.get('upload', 0):.3f},"
            f" readback wait {stages.get('readback', 0):.3f}, write"
            f" {stages.get('write', 0):.3f}")
    say(f"time bucket bf16 profiled run (torch.profiler, CUDA activity):"
        f" {wall_p:.3f} s, device busy {busy_us / 1e3:.1f} ms"
        f" ({busy_us / 1e6 / wall_p:.1%} of the loop); kernels crop"
        f" {counts['crop_kernel']} (images), fused expand_dw"
        f" {counts['expand_dw_kernel']} (11 x {chunks} chunks)")

    # Does the pageable raw upload block the host while the previous image
    # computes? Its host time after a 128-point image is queued, against the
    # same upload on an idle stream and a pinned non-blocking copy.
    key, rowcols, _ = truth[spot[0]]
    image = decode_image_bytes(store.get_bytes("src", key))
    pts = points(rng, 128)
    probe = {"idle": [], "queued": [], "pinned queued": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        extractor._upload(image)
        probe["idle"].append(time.perf_counter() - t1)
        extractor.extract_features_device(image, pts)
        t1 = time.perf_counter()
        extractor._upload(image)
        probe["queued"].append(time.perf_counter() - t1)
        extractor.extract_features_device(image, pts)
        t1 = time.perf_counter()
        torch.from_numpy(image).pin_memory().to("cuda", non_blocking=True)
        probe["pinned queued"].append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    say("time bucket raw upload (host ms, median of 5; 'queued': right after"
        " a 128-point image was dispatched): " + ", ".join(
            f"{k} {sorted(v)[2] * 1e3:.3f}" for k, v in probe.items()))

    # 5. The chain: the bucket's files -> MermaidTrainer -> gated export ->
    # predict_features CLI -> equal to AnnotationRun on two images.
    names = [f"class-{k}" for k in range(len(BUCKET_CLASSES))]
    labels = ImageLabels()
    files = []
    for (source, image_id), (_, rowcols, cls) in sorted(truth.items()):
        path = str(store._path("bf16", feature_key(source, image_id)))
        files.append(path)
        labels.add_image(path, [(int(r), int(c), names[k])
                                for (r, c), k in zip(rowcols, cls)])
    split = preprocess_labels(labels, split_ratios=(0.15, 0.15))
    trainer = MermaidTrainer(batch_size=2_000, device_resident=True,
                             calibration_backend="device", device="cuda")
    t1 = time.perf_counter()
    cal, _, msg = trainer(split, BUCKET_EPOCHS, pc_models=[])
    train_s = time.perf_counter() - t1
    x_val, _ = split.val.load_all()
    art = tmp / "bucket_artifact"
    _, _, diff = export_artifact(cal, art, x_val[:2048])
    if not diff <= 1e-6:
        fail(f"bucket: export gate max |dp| {diff}")
    out_csv = tmp / "bucket_predictions.csv"
    rc = predict_features.main(["--classifier", str(art), "--output", str(out_csv),
                                *files])
    with open(out_csv, newline="") as fh:
        csv_rows = list(csv.DictReader(fh))
    if rc != 0 or len(csv_rows) != n_points:
        fail(f"bucket: predict_features exit {rc}, {len(csv_rows)} rows for"
             f" {n_points} points")
    # The CLI's rows, computed again in the same packing: the CSV is them.
    rows = predict_feature_files(load_predictor(art, device="cuda"), files)
    write_predictions_csv(rows, tmp / "bucket_predictions_again.csv", top_n=3)
    if (tmp / "bucket_predictions_again.csv").read_text() != out_csv.read_text():
        fail("bucket: predict_features' CSV differs from predict_feature_files")
    fetcher = ImageFetcher(store=store)
    worst = 0.0
    for source, image_id in spot[:2]:
        key, rowcols, _ = truth[(source, image_id)]
        points_csv = tmp / f"bucket_points_{image_id}.csv"
        write_points(points_csv, rowcols)
        run = AnnotationRun(f"store://src/{key}", points_csv, str(art),
                            extractor=extractor, fetcher=fetcher)
        path = files[sorted(truth).index((source, image_id))]
        mine = [r for r in rows if r.source_file == path]
        for pred, row in zip(run.run(), mine, strict=True):
            worst = max(worst, max(abs(a - b) for a, b in zip(row.scores, pred.scores)))
            if (row.row, row.col) != (pred.row, pred.col) or list(row.labels) != pred.labels:
                fail(f"bucket: predict_features row {row} against AnnotationRun {pred}")
    # Two f32 heads over batches of other sizes sum in other orders; the
    # export gate holds each within 1e-6 of the f64 model, so two of them
    # agree within 2e-6 (run 1 of this phase read 1.16e-6).
    if not worst <= 2e-6:
        fail(f"bucket: predict_features scores against AnnotationRun max |d| {worst}")
    say(f"bucket: chain: {len(files)} bucket files -> MermaidTrainer (resident"
        f" f32, {BUCKET_EPOCHS} epochs, {train_s:.2f} s, val accuracy {msg.acc:.4f}) ->"
        f" export gate max |dp| {diff:.3e} (<= 1e-6) -> predict_features CSV of"
        f" {len(csv_rows)} rows (= points extracted); on 2 images its top-3"
        f" labels equal AnnotationRun's, scores within {worst:.2e} (<= 2e-6)")
    say(f"bucket: phase took {time.perf_counter() - phase_t0:.1f} s")
    del extractor, trainer, cal
    torch.cuda.empty_cache()
    return {"root": root, "weights": weights, "truth": truth,
            "rate": rates["bfloat16"]}


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
    trunk_rates = {}
    for dtype in ("bfloat16", "float32"):
        for impl in ("fused", "folded"):
            trunk = build_extractor(
                extractor.variables, replace(config, compute_dtype=dtype),
                device="cuda", backbone_impl=impl,
            )
            x = patches.to(trunk.dtype)
            with torch.inference_mode():
                trunk_ms = cuda_ms(lambda: trunk._forward(x), iters=10)
            trunk_rates[(dtype, impl)] = PATCHES / trunk_ms * 1e3
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
    return trunk_rates


LIFECYCLE_MODEL = "mermaid-lifecycle-80"
# Images of the CoralNet export the manifest must drop: (header_status,
# s3_key) with None for a missing value ("k" stands for the image's key).
LIFECYCLE_BAD_IMAGES = (("error", "k"), (None, "k"), ("unreadable", "k"),
                        ("error", None), ("ok", None), ("ok", ""))
LIFECYCLE_TOTAL, LIFECYCLE_MIN_PER_CLASS, LIFECYCLE_EPOCHS = 28_000, 100, 5
LIFECYCLE_REQUESTS = 7  # store:// requests timed for the p50
PROXY_VARS = ("http_proxy", "https_proxy", "HTTP_PROXY", "HTTPS_PROXY",
              "all_proxy", "ALL_PROXY", "no_proxy", "NO_PROXY")
S3_VARS = ("OBJECT_STORE_ENDPOINT", "AWS_REGION", "AWS_ACCESS_KEY_ID",
           "AWS_SECRET_ACCESS_KEY", "AWS_SESSION_TOKEN")


def lifecycle_labels(recipe: dict, fixture_dir: Path):
    """The recipe's rows relabelled for the config generator: one BA per
    recipe class (``lc-NN``, "Label NN" under one of RECIPE_ROOTS roots), the
    two classes the recipe folds made children ("Folded i") of the BAs they
    fold into, each row keeping its growth form. Writes the taxonomy fixture
    (the mapping sends each CoralNet label to its class's BA) and returns
    (MERMAID columns, counts rows (ba_id, gf_id, count), class BA ids)."""
    from collections import Counter

    classes, mapping = recipe["classes"], recipe["mapping"]
    index = {c: k for k, c in enumerate(classes)}
    ba = [f"lc-{k:02d}" for k in range(len(classes))]
    parents = {index[src]: index[dst] for src, dst in recipe["rollups"]}
    records = [{"id": f"lc-r{r}", "name": f"Lifecycle root {r}", "parent": None}
               for r in range(RECIPE_ROOTS)]
    folded = 0
    for k in range(len(classes)):
        if k in parents:
            records.append({"id": ba[k], "name": f"Folded {folded}",
                            "parent": ba[parents[k]]})
            folded += 1
        else:
            records.append({"id": ba[k], "name": f"Label {k:02d}",
                            "parent": f"lc-r{k % RECIPE_ROOTS}"})
    gfs = {"gf-br": "branching", "gf-ma": "massive", "gf-en": "encrusting"}
    provider = {m["provider_id"]: k for k, m in enumerate(mapping)}
    lc_mapping = [{**m, "benthic_attribute_id": ba[k],
                   "benthic_attribute_name": records[RECIPE_ROOTS + k]["name"]}
                  for k, m in enumerate(mapping)]
    fixture_dir.mkdir(parents=True, exist_ok=True)
    (fixture_dir / "benthic_attributes.json").write_text(json.dumps(records))
    (fixture_dir / "growth_forms.json").write_text(json.dumps(gfs))
    (fixture_dir / "label_mappings.json").write_text(json.dumps(lc_mapping))

    m = recipe["mermaid"]
    ks = [index[(b, "" if g == "None" else g)]
          for b, g in zip(m["benthic_attribute_id"], m["growth_form_id"])]
    mermaid = {**m, "benthic_attribute_id": [ba[k] for k in ks]}
    counts = Counter((ba[k], classes[k][1]) for k in ks)
    counts.update((ba[provider[c]], classes[provider[c]][1])
                  for c in recipe["manifest"]["coralnet_id"] if c in provider)
    return mermaid, sorted((b, g, n) for (b, g), n in counts.items()), ba


def coralnet_export(manifest: dict, mapping):
    """The CoralNet ETL export behind the recipe's hand-written manifest: its
    points as the annotation table, its images (status ok, a key each) plus
    LIFECYCLE_BAD_IMAGES, each with RECIPE_POINTS points of its own, as the
    image table."""
    annotations = {k: list(v) for k, v in manifest.items()}
    images = {"source_id": [], "image_id": [], "header_status": [], "s3_key": []}
    for image_id in sorted(set(manifest["image_id"])):
        images["source_id"].append(RECIPE_CN_SOURCE)
        images["image_id"].append(image_id)
        images["header_status"].append("ok")
        images["s3_key"].append(f"s{RECIPE_CN_SOURCE}/i{image_id}.jpg")
    for j, (status, key) in enumerate(LIFECYCLE_BAD_IMAGES):
        image_id = 600_000 + j
        images["source_id"].append(RECIPE_CN_SOURCE)
        images["image_id"].append(image_id)
        images["header_status"].append(status)
        images["s3_key"].append(f"s{RECIPE_CN_SOURCE}/i{image_id}.jpg"
                                if key == "k" else key)
        for p in range(RECIPE_POINTS):
            annotations["source_id"].append(RECIPE_CN_SOURCE)
            annotations["image_id"].append(image_id)
            annotations["row"].append(17 + 40 * p)
            annotations["col"].append(29 + 60 * p)
            annotations["coralnet_id"].append(mapping[p % len(mapping)]["provider_id"])
    return annotations, images


def fake_s3_traffic(state) -> dict:
    """Requests, objects and bytes through the fake endpoint, from its
    request log (an object's bytes are its size at the end of the run)."""
    from urllib.parse import unquote, urlsplit

    out = {"requests": len(state.requests), "list": 0, "head": 0, "delete": 0,
           "put_objects": 0, "put_bytes": 0, "get_objects": 0, "get_bytes": 0}
    for method, path in state.requests:
        parsed = urlsplit(path)
        bucket, _, key = parsed.path.lstrip("/").partition("/")
        size = len(state.objects.get((bucket, unquote(key)), b""))
        if method == "GET" and not key:
            out["list"] += 1
        elif method in ("GET", "PUT"):
            out[f"{method.lower()}_objects"] += 1
            out[f"{method.lower()}_bytes"] += size
        else:
            out[method.lower()] = out.get(method.lower(), 0) + 1
    return out


def log_seconds(log: str, start: str, end: str) -> float:
    """Seconds between the first log line containing ``start`` and the first
    later one containing ``end`` (the ``%(asctime)s`` stamps that open each
    line of the training CLI's debug log)."""
    from datetime import datetime

    stamps = {}
    for line in log.splitlines():
        for key in (start, end):
            if key in line and key not in stamps and (key == start or start in stamps):
                stamps[key] = datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f")
    if len(stamps) != 2:
        fail(f"lifecycle: the training log has no {start!r} ... {end!r} lines")
    return (stamps[end] - stamps[start]).total_seconds()


def phase_lifecycle(variables, config, extractor, recipe: dict, tmp: Path, smi: str):
    """What a MERMAID operator runs around a training run, through the port's
    CLIs as subprocesses, on the fake S3 endpoint (tests/data/fake_s3_server,
    in this process): the CoralNet export -> ``build_coralnet_manifest`` ->
    counts -> ``generate_training_config`` -> ``classifier_train`` with the
    store on S3 and ``TRACKING_SYNC_BUCKET`` set -> ``generate_report`` ->
    ``sync_tracking pull`` on a second root and the report again ->
    ``release_artifact`` v1, v1 again -> ``annotate_image`` from
    ``store://releases/classifier/v1`` (in this process, so the kernels'
    launch counts can be read)."""
    import csv
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from mermaid_classifier_tpu_torch.common.relational import read_parquet_columns
    from mermaid_classifier_tpu_torch.common.taxonomy import TAXONOMY_FIXTURE_ENV
    from mermaid_classifier_tpu_torch.config.settings import settings
    from mermaid_classifier_tpu_torch.data.s3_store import (
        S3Credentials,
        S3ObjectStore,
    )
    from mermaid_classifier_tpu_torch.models.convert import save_backbone_npz
    from mermaid_classifier_tpu_torch.ops import fused_mbconv, patch_crop
    from mermaid_classifier_tpu_torch.scripts import annotate_image
    from mermaid_classifier_tpu_torch.serve.annotation import AnnotationRun
    from mermaid_classifier_tpu_torch.tracking import LocalTracker
    from tests.data.fake_s3_server import make_server

    t0 = time.perf_counter()
    base = tmp / "lifecycle"
    base.mkdir()
    # Each store:// request downloads its artifact into a new temporary
    # directory: keep those inside the smoke's own.
    saved_tempdir, tempfile.tempdir = tempfile.tempdir, str(base)
    server, state, endpoint = make_server()
    server.socket.listen(256)  # the ETL's 50 download threads connect at once
    walls: dict[str, float] = {}
    try:
        for name in PROXY_VARS:
            os.environ.pop(name, None)
        os.environ.update({
            "NO_PROXY": "127.0.0.1,localhost", "OBJECT_STORE_ENDPOINT": endpoint,
            "AWS_REGION": "us-east-1", "AWS_ACCESS_KEY_ID": "lifecycle-key",
            "AWS_SECRET_ACCESS_KEY": "lifecycle-secret"})
        os.environ.pop("AWS_SESSION_TOKEN", None)
        settings.object_store_root = "s3://"
        s3 = S3ObjectStore(endpoint, credentials=S3Credentials(
            "lifecycle-key", "lifecycle-secret"))

        # The feature files into the bucket the training run reads.
        bucket = recipe["bucket"]
        files = sorted(p for p in (recipe["store"] / bucket).rglob("*.npz"))
        t1 = time.perf_counter()
        with ThreadPoolExecutor(16) as pool:
            list(pool.map(lambda p: s3.put_bytes(
                bucket, p.relative_to(recipe["store"] / bucket).as_posix(),
                p.read_bytes()), files))
        upload_s = time.perf_counter() - t1
        upload_bytes = sum(len(v) for (b, _), v in state.objects.items() if b == bucket)

        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(Path(__file__).resolve().parent), env.get("PYTHONPATH")) if p)
        env["OBJECT_STORE_ROOT"] = "s3://"

        def cli(name, *args, expect=0, timeout=600):
            argv = [sys.executable, "-m", f"mermaid_classifier_tpu_torch.scripts.{name}",
                    *map(str, args)]
            t = time.perf_counter()
            proc = subprocess.run(argv, cwd=base, env=env, capture_output=True,
                                  text=True, timeout=timeout)
            wall = time.perf_counter() - t
            if proc.returncode != expect:
                print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
                fail(f"lifecycle: {name} {' '.join(map(str, args[:2]))} exited"
                     f" {proc.returncode} (want {expect})")
            return proc, wall

        # 1. The manifest from the raw CoralNet export.
        annotations, images = coralnet_export(recipe["manifest"], recipe["mapping"])
        paths = base / "cn_annotations.parquet", base / "cn_images.parquet"
        for path, cols in zip(paths, (annotations, images)):
            pq.write_table(pa.table(cols), str(path))
        manifest_path = base / "manifest.parquet"
        proc, walls["build_coralnet_manifest"] = cli(
            "build_coralnet_manifest", "--annotations-parquet", paths[0],
            "--images-parquet", paths[1], "--output", manifest_path)
        built = read_parquet_columns(str(manifest_path))
        want = recipe["manifest"]
        if {c: built[c] for c in want} != want or len(built["s3_key"]) != len(
                want["image_id"]):
            fail("lifecycle: the built manifest's rows differ from the recipe's"
                 " hand-written manifest")
        summary = (f"manifest rows out: {len(want['image_id']):,}"
                   f" (1 sources, {len(set(want['image_id'])):,} images).")
        if summary not in proc.stderr or "4 bad header, 2 missing key" not in proc.stderr:
            print(proc.stderr[-4000:], file=sys.stderr)
            fail(f"lifecycle: build summary does not say '{summary}' with 4 bad"
                 " headers and 2 missing keys")

        # 2. The config directory from the counts and the taxonomy.
        fixture = base / "taxonomy"
        mermaid, counts, lc_ba = lifecycle_labels(recipe, fixture)
        mermaid_path = base / "mermaid.parquet"
        pq.write_table(pa.table(mermaid), str(mermaid_path))
        counts_csv = base / "counts.csv"
        counts_csv.write_text("ba_id,gf_id,count\n" + "".join(
            f"{b},{g},{n}\n" for b, g, n in counts))
        config_dir = base / "config"
        _, walls["generate_training_config"] = cli(
            "generate_training_config", "--counts-csv", counts_csv,
            "--output-dir", config_dir, "--top-n", 80, "--exclude", "Folded 0",
            "--exclude", "Folded 1", "--taxonomy-fixture-dir", fixture,
            "--total-annotations", LIFECYCLE_TOTAL, "--min-per-class",
            LIFECYCLE_MIN_PER_CLASS, "--epochs", LIFECYCLE_EPOCHS)
        with (config_dir / "included_labels.csv").open() as fh:
            included = list(csv.DictReader(fh))
        with (config_dir / "rollups.csv").open() as fh:
            rollup_rows = list(csv.DictReader(fh))
        folded = {r["from_ba_id"]: r["to_ba_id"] for r in rollup_rows
                  if r["from_ba_id"] != r["to_ba_id"]}
        if (len(included) != 80 or any(r["gf_id"] for r in included)
                or folded != {lc_ba[80]: lc_ba[0], lc_ba[81]: lc_ba[3]}):
            fail(f"lifecycle: the generated config includes {len(included)} labels"
                 f" (want 80 bare BAs) and folds {folded}")
        # The operator's edits to the generated YAML: the manifest, and the
        # card's training options and model name.
        yaml_path = config_dir / "training_config.yaml"
        text = yaml_path.read_text()
        text = text.replace("dataset:\n", "dataset:\n  coralnet_manifest_uri:"
                            f" '{manifest_path}'\n", 1)
        text = text.replace("training:\n", "training:\n  device_resident: true\n"
                            "  resident_dtype: bfloat16\n"
                            "  calibration_backend: device\n", 1)
        text = text.replace("tracking:\n", f"tracking:\n  model_name: {LIFECYCLE_MODEL}\n", 1)
        yaml_path.write_text(text)

        # 3. Train with the store on S3 and the tracking sync on.
        tracking_a = base / "tracking_a"
        env.update({
            "TRACKING_SYNC_BUCKET": "tracking", "CORALNET_TRAIN_DATA_BUCKET": bucket,
            "MERMAID_TRAIN_DATA_BUCKET": bucket,
            "MERMAID_ANNOTATIONS_PARQUET_PATTERN": str(mermaid_path),
            TAXONOMY_FIXTURE_ENV: str(fixture),
            "FEATURE_CACHE_DIR": str(base / "feature_cache"),
            "TRACKING_DIR": str(tracking_a)})
        proc, walls["classifier_train"] = cli(
            "classifier_train", "--config-dir", config_dir, "--run-name", "lifecycle",
            timeout=900)
        train_log = proc.stdout + proc.stderr
        if "tracking sync to bucket" in train_log:
            print(train_log[-6000:], file=sys.stderr)
            fail("lifecycle: the runner's tracking sync failed (its warning is in the log)")
        tracker = LocalTracker(tracking_a)
        experiment = next(p.name for p in tracking_a.iterdir() if p.name != "_models")
        run = tracker.runs(experiment)[-1]
        checked = check_cli_run(run, tracker, LIFECYCLE_MODEL, "lifecycle", train_log)
        metrics, params = checked["metrics"], checked["params"]
        parity, registered = metrics["export_parity_max_abs_diff"], checked["registered"]
        model_json = json.loads((registered / "model.json").read_text())
        if model_json["input_dim"] != 4096 or len(model_json["classes"]) != 80:
            fail(f"lifecycle: the registered head is {model_json['input_dim']} ->"
                 f" {len(model_json['classes'])} classes (want 4096 -> 80)")
        debug_log = max((base / "logs").glob("classifier_train_*.debug.log"))
        sync_s = log_seconds(debug_log.read_text(), "Registered model at",
                             "Final accuracy")

        # The bucket holds the run and the registry entry, key for key.
        def local(root: Path, prefix: str) -> dict:
            return {f"{prefix}/{p.relative_to(root).as_posix()}": p.read_bytes()
                    for p in sorted(root.rglob("*")) if p.is_file()}

        def remote(bucket_name: str, prefix: str = "") -> dict:
            return {k: v for (b, k), v in list(state.objects.items())
                    if b == bucket_name and k.startswith(prefix)}

        run_prefix = f"tracking/{experiment}/{run.run_id}"
        reg_prefix = f"tracking/_models/{LIFECYCLE_MODEL}/{registered.name}"
        for prefix, root in ((run_prefix, run.run_dir), (reg_prefix, registered)):
            got, want_objs = remote("tracking", prefix + "/"), local(root, prefix)
            if got != want_objs:
                fail(f"lifecycle: bucket 'tracking' under {prefix}/ holds"
                     f" {len(got)} objects, the local tree {len(want_objs)}, or"
                     " their bytes differ")
        sync_objects = len(remote("tracking"))

        # 4. The report, then the run pulled on a second root and its report.
        reports = base / "report_local.html", base / "report_pulled.html"
        _, walls["generate_report"] = cli(
            "generate_report", "--run-id", run.run_id, "--tracking-root", tracking_a,
            "--output", reports[0])
        tracking_b = base / "tracking_b"
        _, walls["sync_tracking pull"] = cli(
            "sync_tracking", "pull", "--bucket", "tracking", "--experiment", experiment,
            "--run-id", run.run_id, "--dest", tracking_b)
        _, walls["generate_report (pulled)"] = cli(
            "generate_report", "--run-id", run.run_id, "--tracking-root", tracking_b,
            "--output", reports[1])
        html = [p.read_bytes() for p in reports]
        if html[0] != html[1]:
            fail("lifecycle: the report of the pulled run differs from the local one")
        if b"Run report: lifecycle" not in html[0]:
            fail("lifecycle: the report does not name the run")

        # 5. The immutable release.
        release = ["--artifact", f"models:/{LIFECYCLE_MODEL}", "--bucket", "releases",
                   "--tracker-root", tracking_a]
        _, walls["release_artifact v1"] = cli("release_artifact", "--version", "v1",
                                              *release)
        v1 = remote("releases")
        want_v1 = {f"classifier/v1/{f}": (registered / f).read_bytes()
                   for f in ("model.json", "model.npz")}
        if v1 != want_v1:
            fail(f"lifecycle: bucket 'releases' holds {sorted(v1)}, want"
                 f" {sorted(want_v1)} with the registered bytes")
        _, walls["release_artifact v1 again"] = cli(
            "release_artifact", "--version", "v1", *release, expect=1)
        if remote("releases") != v1:
            fail("lifecycle: the refused v1 release changed the bucket")

        # 6. Serve from store:// through the annotate_image CLI, in this
        # process, against the same artifact from models:/.
        rng = np.random.default_rng(SEED + 31)
        h, w = IMAGE_HW
        image = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        image_path = base / "image.npy"
        np.save(image_path, image)
        pts = points(rng, 25)
        bundle = base / "b0_weights.npz"
        save_backbone_npz(str(bundle), variables, config)
        settings.tracking_dir = str(tracking_a)
        served = {}
        for spec in ("store://releases/classifier/v1", f"models:/{LIFECYCLE_MODEL}"):
            out = base / ("serve_store" if spec.startswith("store") else "serve_models")
            csv_path = base / f"{out.name}.csv"
            write_points(csv_path, pts)
            patch_crop.launches = 0
            fused_mbconv.launches = 0
            t = time.perf_counter()
            rc = annotate_image.main(["--image", str(image_path), "--points", str(csv_path),
                                      "--classifier", spec, "--output-dir", str(out),
                                      "--backbone-weights", str(bundle), "--device", "cuda"])
            torch.cuda.synchronize()
            walls[f"annotate_image {spec.split(':')[0]}:"] = time.perf_counter() - t
            launches = (patch_crop.launches, fused_mbconv.launches)
            if rc != 0:
                fail(f"lifecycle: annotate_image {spec} returned {rc}")
            if launches != (1, 11):
                fail(f"lifecycle: annotate_image {spec} launched (crop, fused)"
                     f" {launches}, want (1, 11)")
            with (out / "predictions.csv").open() as fh:
                served[spec] = (list(csv.DictReader(fh)), launches)
        (rows_s, launches_s), (rows_m, _) = served.values()
        cli_diff = max(abs(float(a[f"score_{i}"]) - float(b[f"score_{i}"]))
                       for a, b in zip(rows_s, rows_m) for i in (1, 2, 3))
        if len(rows_s) != 25 or [[a[f"pred_{i}"] for i in (1, 2, 3)] for a in rows_s] != \
                [[b[f"pred_{i}"] for i in (1, 2, 3)] for b in rows_m] or not cli_diff <= 2e-6:
            fail(f"lifecycle: annotate_image from store:// and models:/ disagree"
                 f" (score gap {cli_diff:.3e}, want <= 2e-6)")

        # The same request through the smoke's extractor, timed: store://
        # (download, load, request) against models:/.
        csv_path = base / "serve_timed.csv"
        write_points(csv_path, pts)
        ann_m = AnnotationRun(image, csv_path, f"models:/{LIFECYCLE_MODEL}",
                              extractor=extractor)
        ann_m.run()
        total_ms, run_ms = [], []
        for _ in range(LIFECYCLE_REQUESTS):
            t = time.perf_counter()
            ann = AnnotationRun(image, csv_path, "store://releases/classifier/v1",
                                extractor=extractor)
            t_run = time.perf_counter()
            patch_crop.launches = 0
            fused_mbconv.launches = 0
            ann.run()
            launches = (patch_crop.launches, fused_mbconv.launches)
            now = time.perf_counter()
            total_ms.append((now - t) * 1e3)
            run_ms.append((now - t_run) * 1e3)
            if launches != (1, 11):
                fail(f"lifecycle: the store:// request launched {launches}, want (1, 11)")
        diff = float(np.abs(ann.proba - ann_m.proba).max())
        if not diff <= 2e-6:
            fail(f"lifecycle: store:// scores {diff:.3e} from models:/ (want <= 2e-6)")
        traffic = fake_s3_traffic(state)
    finally:
        server.shutdown()
        server.server_close()
        tempfile.tempdir = saved_tempdir

    with run.artifact("profiled_sections.csv").open() as fh:
        sections = {r["name"]: float(r["seconds"]) for r in csv.DictReader(fh)}
    recipe_sections = {r["name"]: float(r["seconds"]) for r in recipe["sections"]}
    say(f"lifecycle: {len(files)} feature files ({upload_bytes / 1e9:.3f} GB) into the"
        f" fake S3 endpoint in {upload_s:.1f} s; build_coralnet_manifest: {summary}"
        f" the rows equal the recipe's hand-written manifest; generate_training_config:"
        f" 80 labels, {len(rollup_rows)} rollups, Folded 0/1 into {lc_ba[0]}/{lc_ba[3]}")
    say(f"lifecycle: classifier_train --config-dir (store s3://, TRACKING_SYNC_BUCKET"
        f" tracking): exit 0; accuracy {metrics['accuracy']}; export parity"
        f" {parity:.3e}; artifact_eval_inputs {params.get('artifact_eval_inputs')};"
        f" registered {registered.parent.name}/{registered.name}; the bucket holds"
        f" the run and the registry entry key for key ({sync_objects} objects)")
    say(f"lifecycle: report of the pulled run equals the local report"
        f" ({len(html[0]):,} bytes); release v1 exit 0, v1 again exit 1 with the"
        f" bucket unchanged")
    say(f"lifecycle: annotate_image from store://releases/classifier/v1 launches"
        f" crop={launches_s[0]} fused={launches_s[1]}, predictions equal models:/"
        f" (score gap {cli_diff:.1e}); store:// request vs models:/ max |dp| {diff:.3e}"
        f" (<= 2e-6)")
    numbers = {
        "cli_wall_s": {k: round(v, 3) for k, v in walls.items()},
        "profiled_sections_s": sections,
        "feature_downloads_s": {"s3": sections.get("Downloading feature vectors"),
                                "recipe_local": recipe_sections.get(
                                    "Downloading feature vectors")},
        "fake_s3": {**traffic, "upload_s": round(upload_s, 3)},
        "sync": {"objects": sync_objects, "seconds": sync_s},
        "release_s": {k.split(" ", 1)[1]: round(v, 3) for k, v in walls.items()
                      if k.startswith("release_artifact")},
        "store_request_p50_ms": round(sorted(total_ms)[len(total_ms) // 2], 3),
        "store_request_run_p50_ms": round(sorted(run_ms)[len(run_ms) // 2], 3),
        "phase_wall_s": round(time.perf_counter() - t0, 1),
    }
    say(f"time lifecycle on {smi}: {json.dumps(numbers)}")


WEIGHTS_POINTS, WEIGHTS_REQUESTS = 25, 7
REPO = Path(__file__).resolve().parent
# The JAX quality test's bands (tests/train/test_quality_parity.py:28-30):
# accuracy, balanced accuracy, log loss.
QUALITY_BANDS = (0.02, 0.04, 0.10)


class KeepFeatures:
    """An extractor that keeps the device features of its last call, so a
    phase can hold a served request's features against an oracle."""

    def __init__(self, extractor):
        self.extractor = extractor
        self.device = extractor.device
        self.features = None

    def extract_features_device(self, image, rowcols):
        self.features = self.extractor.extract_features_device(image, rowcols)
        return self.features


def small_head_artifact(out_dir: Path, dim: int) -> None:
    """A trained, calibrated and exported head (the release gate wants a
    ``trained_with`` block): 4096 -> 64 -> 10 on 4,000 seeded rows."""
    import numpy as np

    from mermaid_classifier_tpu_torch.inference import export_artifact
    from mermaid_classifier_tpu_torch.train.calibration import CalibratedClassifier
    from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier

    rng = np.random.default_rng(SEED + 21)
    means = (rng.standard_normal((10, dim)) * TRAIN_MEAN_STD).astype(np.float32)
    y = rng.integers(0, 10, 4000)
    X = rng.standard_normal((4000, dim), dtype=np.float32) + means[y]
    names = np.array([f"ba-{i}::gf-{i % 3}" for i in range(10)])
    clf = MLPClassifier((64,), learning_rate_init=1e-3, random_state=0,
                        device="cuda")
    for _ in range(3):
        clf.partial_fit(X, names[y], classes=list(names))
    cal = CalibratedClassifier.fit_from_scores(
        clf, clf.predict_proba(X[:1000]), names[y][:1000], device="cuda")
    export_artifact(cal, out_dir, X[:256])


def pyspacer_crops(image, pts, ps: int):
    """The pyspacer crops of ``pts``, written apart from the port's crop: the
    image in a ps // 2 zero border, a ps x ps window per point, ToTensor and
    Normalize (``tests/parity/foreign_checkpoints.pyspacer_transformation``),
    as one NCHW float32 batch."""
    import numpy as np
    import torch

    from tests.parity.foreign_checkpoints import pyspacer_transformation

    half = ps // 2
    padded = np.pad(image, ((half, half), (half, half), (0, 0)))
    return torch.stack([pyspacer_transformation(padded[r:r + ps, c:c + ps])
                        for r, c in pts])


def phase_weights(tmp: Path, smi: str):
    """The fidelity runbook on the card, at the full B0 224 width with
    feature_dim 4096: a pyspacer-lineage efficientnet.pt -> the port's
    diff_backbone (all green) -> release_artifact with the bundle, sidecar
    and record (accepted; a tampered bundle refused) -> 25-point requests
    over the released bundle through the crop and fused kernels, held
    against the lukemelas forward on the same crops."""
    import dataclasses
    import logging

    import numpy as np
    import torch

    from mermaid_classifier_tpu_torch.config.settings import override_settings
    from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
    from mermaid_classifier_tpu_torch.models.convert import load_backbone_bundle
    from mermaid_classifier_tpu_torch.models.extractor import build_extractor
    from mermaid_classifier_tpu_torch.ops import fused_mbconv, patch_crop
    from mermaid_classifier_tpu_torch.ops.fused_mbconv import full_f32
    from mermaid_classifier_tpu_torch.scripts import release_artifact
    from mermaid_classifier_tpu_torch.serve.annotation import AnnotationRun
    from tests.parity.foreign_checkpoints import (
        build_lukemelas_b0,
        save_pyspacer_efficientnet_pt,
    )

    phase_t0 = time.perf_counter()
    work = tmp / "weights"
    work.mkdir()
    model = build_lukemelas_b0(seed=SEED + 20)
    pt = work / "efficientnet.pt"
    save_pyspacer_efficientnet_pt(model, pt)
    npz, record_path = work / "backbone.npz", work / "fidelity.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mermaid_classifier_tpu_torch.scripts.diff_backbone",
         str(pt), "--device", "cuda", "--save-npz", str(npz),
         "--record", str(record_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    diff_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"weights: diff_backbone exit {proc.returncode}:\n{proc.stdout[-3000:]}"
             f"\n{proc.stderr[-2000:]}")
    record = json.loads(record_path.read_text())
    layers = []
    for line in proc.stdout.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[2] in ("ok", "FAIL"):
            layers.append((float(parts[1]), parts[0]))
    layers.sort(reverse=True)
    if not (record["all_green"] and record["naming_scheme"] == "lukemelas"
            and record["padding"] == "tf_same" and record["bn_eps"] == 1e-3
            and len(layers) == record["n_layers_compared"] == 212
            and layers[0][0] <= 5e-4 and record["feature_mae"] < 1e-4):
        fail(f"weights: fidelity record {record}, worst layers {layers[:3]}")
    say(f"weights: diff_backbone --device cuda on a pyspacer-lineage"
        f" efficientnet.pt ({{'net': {{'module.<key>'}}}}, lukemelas naming ->"
        f" tf_same, eps 1e-3): {record['n_layers_compared']} layers all green in"
        f" {diff_s:.1f} s (subprocess); per-layer worst |d| "
        + ", ".join(f"{name} {v:.3e}" for v, name in layers[:3])
        + f" (<= 5e-4); feature MAE {record['feature_mae']:.3e} (< 1e-4)")

    head = work / "head"
    small_head_artifact(head, 4096)
    sidecar = work / "backbone.config.json"
    store = LocalFSObjectStore(work / "store")
    tampered = work / "tampered" / "backbone.npz"
    tampered.parent.mkdir()
    data = bytearray(npz.read_bytes())
    data[len(data) // 2] ^= 1
    tampered.write_bytes(bytes(data))
    (tampered.parent / sidecar.name).write_bytes(sidecar.read_bytes())
    root = logging.getLogger()
    saved_logging = root.level, list(root.handlers)
    with override_settings(object_store_root=str(work / "store")):
        t0 = time.perf_counter()
        rc = release_artifact.main([
            "--version", "v1", "--artifact", str(head), "--bucket", "releases",
            "--extra-file", str(npz), "--extra-file", str(sidecar),
            "--fidelity-record", str(record_path), "--device", "cuda"])
        release_s = time.perf_counter() - t0
        rc_bad = release_artifact.main([
            "--version", "v2", "--artifact", str(head), "--bucket", "releases",
            "--extra-file", str(tampered),
            "--extra-file", str(tampered.parent / sidecar.name),
            "--fidelity-record", str(record_path), "--device", "cuda"])
        # The CLI configures the root logger; the phases after keep theirs.
        root.setLevel(saved_logging[0])
        root.handlers[:] = saved_logging[1]
        keys = sorted(store.list_keys("releases"))
        want = [f"classifier/v1/{n}" for n in
                ("backbone.config.json", "backbone.npz", "model.json", "model.npz")]
        if rc != 0 or rc_bad != 1 or keys != want:
            fail(f"weights: release exit {rc} (want 0), tampered exit {rc_bad}"
                 f" (want 1), keys {keys}")
        if store.get_bytes("releases", "classifier/v1/backbone.npz") != npz.read_bytes():
            fail("weights: the released bundle is not the diffed one")
        say(f"weights: release_artifact v1 with the bundle, its sidecar and the"
            f" record accepted in {release_s:.2f} s (in process); v2 with one byte"
            f" of the bundle flipped refused (exit 1, nothing written)")

        got = work / "released"
        got.mkdir()
        for name in ("backbone.npz", "backbone.config.json"):
            store.download("releases", f"classifier/v1/{name}", got / name)
        variables, config = load_backbone_bundle(str(got / "backbone.npz"))
        if (config.padding, config.bn_eps, config.feature_dim) != ("tf_same", 1e-3, 4096):
            fail(f"weights: released config {config}")
        rng = np.random.default_rng(SEED + 22)
        h, w = IMAGE_HW
        image = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        pts = points(rng, WEIGHTS_POINTS)
        csv_path = work / "points.csv"
        write_points(csv_path, pts)
        feats, launches, p50 = {}, {}, {}
        for dtype in ("float32", "bfloat16"):
            ext = KeepFeatures(build_extractor(
                variables, dataclasses.replace(config, compute_dtype=dtype),
                device="cuda", backbone_impl="fused"))
            run = AnnotationRun(image, csv_path, "store://releases/classifier/v1",
                                extractor=ext)
            patch_crop.launches = fused_mbconv.launches = 0
            run.run()
            launches[dtype] = (patch_crop.launches, fused_mbconv.launches)
            torch.cuda.synchronize()
            check_run(run, WEIGHTS_POINTS, list(run.predictor.classes_), run.top_n)
            feats[dtype] = ext.features.float().cpu().numpy()
            wall = []
            for _ in range(WEIGHTS_REQUESTS):
                t0 = time.perf_counter()
                run.run()
                wall.append((time.perf_counter() - t0) * 1e3)
            p50[dtype] = sorted(wall)[len(wall) // 2]
        if any(v != (1, 11) for v in launches.values()):
            fail(f"weights: (crop, fused) launches per request {launches}, want (1, 11)")

    crops = pyspacer_crops(image, pts, config.patch_size).cuda()
    with torch.no_grad(), full_f32():
        oracle = model.cuda().eval()(crops).float().cpu().numpy()
    mae = float(np.mean(np.abs(feats["float32"] - oracle)))
    cos = min_row_cosine(feats["bfloat16"], oracle)
    spread = float(np.std(oracle, axis=0).mean())
    if not (mae < 1e-4 and cos >= 0.999):
        fail(f"weights: served features against the lukemelas forward: f32 MAE"
             f" {mae} (< 1e-4), bf16 min row cosine {cos} (>= 0.999)")
    say(f"weights: 25-point AnnotationRun over the released bundle (store://),"
        f" launches crop / fused f32 {launches['float32']}, bf16"
        f" {launches['bfloat16']}; features against LukemelasEfficientNetB0.forward"
        f" on pyspacer's crops: f32 MAE {mae:.3e} (< 1e-4), bf16 min row cosine"
        f" {cos:.6f} (>= 0.999); the oracle's features spread {spread:.3e} across"
        f" points")
    say(f"time weights on {smi}: phase {time.perf_counter() - phase_t0:.1f} s;"
        f" request p50 (host clock, {WEIGHTS_REQUESTS} requests, predictor"
        f" loaded) f32 {p50['float32']:.3f} ms, bf16 {p50['bfloat16']:.3f} ms")
    del model, crops
    torch.cuda.empty_cache()


def phase_quality(smi: str):
    """The composed quality check: the port's chain (subsample, train,
    calibrate, export, load, score) at the CI spec on the card and on the
    CPU, held within the JAX test's bands; then the bench's repo side at its
    default scale on the card. sklearn is not on the card: the sklearn side
    runs in the CPU tests only."""
    import contextlib
    import io

    import numpy as np

    from mermaid_classifier_tpu_torch.scripts import quality_parity_bench
    from mermaid_classifier_tpu_torch.train import quality_parity as qp

    spec = qp.QualityRunSpec()
    X, y = qp.make_imbalanced_clusters(spec)
    train, ref, val = qp.split_stratified(X, y, spec)
    sub = qp.subsample_train(train, spec)
    out, wall = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[device] = qp.run_repo_pipeline(sub, ref, val, spec, device=device)
        wall[device] = time.perf_counter() - t0
    card, cpu = out["cuda"], out["cpu"]
    gaps = (abs(card.accuracy - cpu.accuracy),
            abs(card.balanced_accuracy - cpu.balanced_accuracy),
            abs(card.log_loss - cpu.log_loss))
    uniform = float(np.log(spec.n_classes))
    if not (gaps[0] <= QUALITY_BANDS[0] and gaps[1] <= QUALITY_BANDS[1]
            and gaps[2] <= QUALITY_BANDS[2] and card.log_loss < 0.7 * uniform):
        fail(f"quality: card {card} against cpu {cpu}: gaps {gaps} (bands"
             f" {QUALITY_BANDS}), card log loss against 0.7 x uniform {0.7 * uniform}")
    say(f"quality: CI spec ({len(sub[0])} train, {len(val[0])} val, {spec.n_classes}"
        f" classes): card accuracy {card.accuracy:.4f}, balanced"
        f" {card.balanced_accuracy:.4f}, log loss {card.log_loss:.4f} in"
        f" {wall['cuda']:.2f} s; CPU {cpu.accuracy:.4f} / {cpu.balanced_accuracy:.4f}"
        f" / {cpu.log_loss:.4f} in {wall['cpu']:.2f} s; gaps {gaps[0]:.4f} /"
        f" {gaps[1]:.4f} / {gaps[2]:.4f} (bands {QUALITY_BANDS[0]} / {QUALITY_BANDS[1]}"
        f" / {QUALITY_BANDS[2]}); log loss under 0.7 x uniform {0.7 * uniform:.4f}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = quality_parity_bench.main(["--repo-only", "--device", "cuda"])
    text = buf.getvalue().strip().splitlines()
    bench = json.loads(text[-1]) if rc == 0 and text else None
    if bench is None or not (0.0 < bench["repo_accuracy"] <= 1.0
                             and np.isfinite(bench["repo_log_loss"])):
        fail(f"quality: bench repo side exit {rc}: {text[-3:]}")
    say(f"time quality bench repo side on {smi} (default scale: 40,000 x 512,"
        f" 30 classes, {bench['n_train']} train rows, {bench['n_val']} val):"
        f" accuracy {bench['repo_accuracy']}, balanced"
        f" {bench['repo_balanced_accuracy']}, log loss {bench['repo_log_loss']},"
        f" {bench['repo_seconds']:.2f} s wall (host clock)")


JOBS_WORKERS = 2
JOBS_RUN_ID = "jobs"
_LAUNCHES_RE = r"kernel launches in this process: crop (\d+), fused_mbconv (\d+)"


def worker_rates(records, t_submit: float) -> dict:
    """A worker's rates from its progress records: steady (from its first
    image written to its last, over the images after the first) and from
    the launcher's submit (process start, imports, weights, gate included)."""
    times = sorted(r["time"] for r in records)
    points = [r["points"] for r in sorted(records, key=lambda r: r["time"])]
    span = times[-1] - times[0]
    return {"images": len(records), "points": sum(points),
            "steady_images_s": (len(times) - 1) / span if span > 0 else float("nan"),
            "steady_pf_s": sum(points[1:]) / span if span > 0 else float("nan"),
            "from_submit_images_s": len(times) / (times[-1] - t_submit),
            "from_submit_pf_s": sum(points) / (times[-1] - t_submit)}


def phase_jobs(bucket: dict, tmp: Path, smi: str):
    """The job layer on the card: ``launch_processing`` (a subprocess) fans
    the bucket phase's corpus out over JOBS_WORKERS workers of the port's
    bucket CLI (bf16, fused, the bucket's weights) sharing the card; every
    file equals the bucket phase's single-process file bit for bit, the
    worker whose shard holds the truncated object FAILED and named it, and
    each worker's log gives its kernel launches; the run relaunched rewrites
    nothing; then the port's ``e2e_smoke --production-backbone``, whose
    workers' logs give theirs."""
    import csv
    import re

    from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
    from mermaid_classifier_tpu_torch.jobs import chunk_items

    t0 = time.perf_counter()
    base = tmp / "jobs"
    base.mkdir()
    store = LocalFSObjectStore(bucket["root"])
    truth = bucket["truth"]
    sources = sorted({s for s, _ in truth})
    (base / "sources.csv").write_text("source_id\n" + "".join(f"{s}\n" for s in sources))
    progress, errors = base / "progress.jsonl", base / "errors.csv"
    entry = REPO / "mermaid_classifier_tpu_torch" / "scripts" / "build_feature_bucket.py"
    args = ["--source-bucket", "src", "--target-bucket", "jobs", "--backbone-weights",
            str(bucket["weights"]), "--compute-dtype", "bfloat16", "--progress-log",
            str(progress), "--error-log", str(errors), "--device", "cuda"]
    (base / "run.yaml").write_text(
        f"job:\n  entrypoint: '{entry}'\n"
        f"  env: {{OBJECT_STORE_ROOT: '{bucket['root']}'}}\n"
        f"processing:\n  container_args: {json.dumps(args)}\n"
        f"  shard: {{items_csv: sources.csv, workers: {JOBS_WORKERS}}}\n")
    shards = chunk_items(sources, JOBS_WORKERS)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)

    def worker_launches(logs: dict) -> dict:
        launches = {}
        for i, text in logs.items():
            found = re.findall(_LAUNCHES_RE, text)
            if len(found) != 1:
                print(text[-4000:], file=sys.stderr)
                fail(f"jobs: worker {i} logged no kernel launch counts")
            launches[i] = tuple(map(int, found[0]))
        return launches

    def launch(log_dir: Path):
        argv = [sys.executable, "-m", "mermaid_classifier_tpu_torch.scripts.launch_processing",
                "--run-config", str(base / "run.yaml"), "--run-id", JOBS_RUN_ID,
                "--log-dir", str(log_dir)]
        t_submit = time.time()
        t1 = time.perf_counter()
        proc = subprocess.run(argv, cwd=base, env=env, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t1
        logs = {i: (log_dir / f"{JOBS_RUN_ID}-w{i}-{i}.log").read_text()
                for i in range(len(shards))}
        return proc, wall, t_submit, logs, worker_launches(logs)

    # 1. The fan-out: the worker holding the truncated object fails, the
    # launcher exits 1, every other image lands bit for bit.
    corrupt_source = "1"  # image BUCKET_CORRUPT of write_bucket_sources
    bad_worker = next(i for i, shard in enumerate(shards) if corrupt_source in shard)
    proc, wall, t_submit, logs, launches = launch(base / "logs")
    want_failed = f"1/{len(shards)} jobs failed: ['{JOBS_RUN_ID}-w{bad_worker}-{bad_worker}']"
    if proc.returncode != 1 or want_failed not in proc.stderr:
        print(proc.stderr[-6000:], file=sys.stderr)
        fail(f"jobs: launch_processing exited {proc.returncode} (want 1, {want_failed!r})")
    if f"source {corrupt_source} image {BUCKET_CORRUPT} failed" not in logs[bad_worker]:
        print(logs[bad_worker][-4000:], file=sys.stderr)
        fail(f"jobs: worker {bad_worker}'s log does not name image {BUCKET_CORRUPT}")
    with open(errors, newline="") as fh:
        error_rows = [(r["source_id"], r["image_id"]) for r in csv.DictReader(fh)]
    if error_rows != [(corrupt_source, BUCKET_CORRUPT)]:
        fail(f"jobs: error log {error_rows}, want [({corrupt_source!r}, {BUCKET_CORRUPT!r})]")
    keys = sorted(k for k in store.list_keys("jobs") if k.endswith(".features.npz"))
    want_keys = sorted(k for k in store.list_keys("bf16") if k.endswith(".features.npz"))
    if keys != want_keys or len(keys) != len(truth):
        fail(f"jobs: {len(keys)} feature files, the bucket phase's {len(want_keys)}")
    for source, image_id in truth:
        (rc_a, f_a), (rc_b, f_b) = (bucket_features(store, b, source, image_id)
                                    for b in ("jobs", "bf16"))
        if f_a.dtype != f_b.dtype or rc_a.tobytes() != rc_b.tobytes() \
                or f_a.tobytes() != f_b.tobytes():
            fail(f"jobs: {source}/{image_id} differs from the bucket phase's file")
    # Each worker's launches: one crop per image it extracted, 11 fused per
    # 128-patch chunk plus 11 for its numerics gate.
    for i, shard in enumerate(shards):
        mine = [rc for (s, _), (_, rc, _) in truth.items() if s in shard]
        want = (len(mine), 11 * sum(-(-len(rc) // 128) for rc in mine) + 11)
        if launches[i] != want:
            fail(f"jobs: worker {i} launched (crop, fused) {launches[i]}, want {want}")
    records = [json.loads(line) for line in progress.read_text().splitlines()]
    rates = {i: worker_rates([r for r in records if r["source_id"] in shard], t_submit)
             for i, shard in enumerate(shards)}
    say(f"jobs: launch_processing with {len(shards)} workers (shards {shards}) exit 1:"
        f" worker {bad_worker} FAILED and its log and the error log name image"
        f" {BUCKET_CORRUPT}; {len(keys)} feature files equal the bucket phase's"
        f" single-process files bit for bit (bf16); launches (crop, fused) per worker"
        f" {[launches[i] for i in range(len(shards))]}")

    # 2. Relaunch the run: every done image skipped, nothing rewritten.
    paths = [store._path("jobs", k) for k in keys]
    before = [(p.stat().st_mtime_ns, p.read_bytes()) for p in paths]
    proc2, wall2, _, logs2, launches2 = launch(base / "logs_relaunch")
    after = [(p.stat().st_mtime_ns, p.read_bytes()) for p in paths]
    n_records = len(progress.read_text().splitlines())
    if proc2.returncode != 1 or after != before or n_records != len(records):
        fail(f"jobs: relaunch exit {proc2.returncode} (want 1), files rewritten"
             f" {sum(a != b for a, b in zip(after, before))}, progress records"
             f" {n_records} (want {len(records)})")
    for i, shard in enumerate(shards):
        skipped = sum(s in shard for s, _ in truth)
        if f"0 images extracted (0 points), {skipped} skipped" not in logs2[i] \
                or launches2[i] != (0, 11):
            print(logs2[i][-4000:], file=sys.stderr)
            fail(f"jobs: relaunched worker {i} did not skip its {skipped} images"
                 f" (launches {launches2[i]}, want (0, 11): the gate only)")
    say(f"jobs: relaunch exit 1, every worker skipped every done image ({len(keys)}"
        f" files' bytes and mtime_ns unchanged, no new progress record), launches"
        f" (crop, fused) per worker {[launches2[i] for i in range(len(shards))]}"
        f" (the gate only)")

    # 3. The port's one-command drive at B0 224 / 4096 on the card, as the
    # README gives it: with --production-backbone it defaults to 8 images x
    # 64 points per source (at 4 x 16 the 4096-d head learns nothing and the
    # export gate rightly refuses it; ROADMAP C).
    t1 = time.perf_counter()
    e2e = subprocess.run(
        [sys.executable, "-m", "mermaid_classifier_tpu_torch.scripts.e2e_smoke",
         "--production-backbone", "--backbone-weights", str(bucket["weights"]),
         "--workdir", str(base / "e2e"), "--device", "cuda"],
        cwd=base, env=env, capture_output=True, text=True, timeout=900)
    e2e_s = time.perf_counter() - t1
    budget = [line for line in e2e.stdout.splitlines() if "stage budget:" in line]
    if e2e.returncode != 0 or "[e2e] PASS in " not in e2e.stdout or len(budget) != 1:
        print(e2e.stdout[-6000:], e2e.stderr[-6000:], file=sys.stderr)
        fail(f"jobs: e2e_smoke --production-backbone exited {e2e.returncode}")
    # The drive's workers ran the kernels too: one crop per image each
    # extracted, at least 11 fused launches per image, every image once.
    e2e_logs = {f.name: f.read_text()
                for f in sorted((base / "e2e" / "logs").glob("e2e-smoke-w*.log"))}
    if not e2e_logs:
        fail("jobs: the E2E drive left no worker logs")
    e2e_launches = worker_launches(e2e_logs)
    extracted = {}
    for name, text in e2e_logs.items():
        # The builder and its CLI each log the run's summary.
        found = set(re.findall(r"(\d+) images extracted \(\d+ points\)", text))
        if len(found) != 1:
            fail(f"jobs: E2E worker log {name} gives no one extracted-image count")
        extracted[name] = int(found.pop())
        crop, fused = e2e_launches[name]
        if extracted[name] == 0 or crop != extracted[name] or fused < 11 * crop:
            print(text[-4000:], file=sys.stderr)
            fail(f"jobs: E2E worker {name} extracted {extracted[name]} images and"
                 f" launched (crop, fused) {(crop, fused)}: want one crop per image"
                 f" and at least 11 fused per image")
    want_images = int(re.search(r"synthesized (\d+) images", e2e.stdout).group(1))
    if sum(extracted.values()) != want_images:
        fail(f"jobs: E2E workers extracted {sum(extracted.values())} images of"
             f" {want_images}")
    say(f"jobs: e2e_smoke --production-backbone --device cuda: PASS in {e2e_s:.1f} s;"
        f" workers' launches (crop, fused) {list(e2e_launches.values())} over"
        f" {list(extracted.values())} images")

    single_wall, single_ims, single_pfs, _ = bucket["rate"]
    say(f"time jobs on {smi}: fan-out of {len(truth) + 1} images over {len(shards)}"
        f" workers, launch_processing subprocess {wall:.2f} s from submit to all"
        f" terminal (polls every 2 s); relaunch {wall2:.2f} s")
    for i in range(len(shards)):
        r = rates[i]
        say(f"time jobs on {smi}: worker {i} ({r['images']} images, {r['points']}"
            f" points): steady {r['steady_images_s']:.2f} images/s,"
            f" {r['steady_pf_s']:.1f} patch-features/s (first image to last);"
            f" from submit {r['from_submit_images_s']:.2f} images/s,"
            f" {r['from_submit_pf_s']:.1f} patch-features/s")
    # The workers' windows need not overlap, so their rates' sum is not a
    # rate they reached together: the combined rate counts every image
    # after the first written by any worker over the union window, from
    # that first image to the last written by any.
    ordered = sorted(records, key=lambda r: r["time"])
    union = ordered[-1]["time"] - ordered[0]["time"]
    firsts = [min(r["time"] for r in records if r["source_id"] in shard) for shard in shards]
    lasts = [max(r["time"] for r in records if r["source_id"] in shard) for shard in shards]
    say(f"time jobs on {smi}: combined {len(ordered) - 1} images,"
        f" {sum(r['points'] for r in ordered[1:])} points over the union window"
        f" {union:.3f} s: {(len(ordered) - 1) / union:.2f} images/s,"
        f" {sum(r['points'] for r in ordered[1:]) / union:.1f} patch-features/s;"
        f" the workers' windows overlap {min(lasts) - max(firsts):.3f} s")
    say(f"time jobs on {smi}: sum of the workers' steady rates"
        f" {sum(r['steady_images_s'] for r in rates.values()):.2f} images/s,"
        f" {sum(r['steady_pf_s'] for r in rates.values()):.1f} patch-features/s,"
        f" beside the bucket phase's single-process bf16 builder run"
        f" {single_ims:.2f} images/s, {single_pfs:.1f} patch-features/s"
        f" ({single_wall:.3f} s)")
    say(f"time jobs on {smi}: e2e {budget[0].split('] ', 1)[-1]}; phase"
        f" {time.perf_counter() - t0:.1f} s")


DRIVE_BUCKET = ("--images", "24", "--points", "200", "--sources", "4", "--kill-frac",
                "0.4", "--compute-dtype", "bfloat16")
# 60,000 pool rows: below about 60,000 at seed 0 the rarest class has too few
# rows for one to land in the ref split, and the recipe (the JAX package's
# as well) refuses a training label the ref split lacks.
DRIVE_RECIPE = ("--pool-rows", "60000", "--classes", "80", "--dim", "4096",
                "--points-per-image", "100", "--sources", "20", "--epochs", "5",
                "--patience", "3", "--resident-dtype", "int8")


def run_drives(base: Path, drives) -> dict:
    """The port's at-scale drives as their users run them (``-m``
    subprocesses on the card), all started at once: {name: record} with each
    drive's wall seconds, or the phase fails. Every drive runs in a session
    of its own, so a failure stops it and the processes it started."""
    import signal

    procs = {}
    try:
        for name, module, args in drives:
            log = (base / f"{name}.log").open("w")
            procs[name] = (module, log, time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", f"mermaid_classifier_tpu_torch.scripts.{module}",
                 *args, "--workdir", str(base / name), "--output-json",
                 str(base / f"{name}.json")],
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT, start_new_session=True))
        walls, deadline = {}, time.perf_counter() + 600
        while len(walls) < len(procs) and time.perf_counter() < deadline \
                and all(procs[name][3].returncode == 0 for name in walls):
            for name, (_, _, t, proc) in procs.items():
                if name not in walls and proc.poll() is not None:
                    walls[name] = time.perf_counter() - t
            time.sleep(0.2)
        # A drive that failed first, else one still running at the deadline.
        for name, (module, log, _, proc) in sorted(
                procs.items(), key=lambda item: item[1][3].returncode is None):
            if proc.returncode != 0 or not (base / f"{name}.json").is_file():
                log.close()
                print((base / f"{name}.log").read_text()[-8000:], file=sys.stderr)
                fail(f"drives: {module} exited {proc.returncode}"
                     + (" (still running after 600 s)" if proc.returncode is None else ""))
        return {name: {**json.loads((base / f"{name}.json").read_text()),
                       "wall_seconds": walls[name]} for name in procs}
    finally:
        for _, log, _, proc in procs.values():
            log.close()
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


def phase_drives(results, tmp: Path, smi: str):
    """The port's at-scale drives at full width and reduced depth: the
    kill-and-resume bulk build (24 production-sized JPEGs x 200 points over 4
    sources, bf16 on the fused trunk, SIGKILL at 40%) and the C2 recipe drive
    (60,000 pool rows x 4096, 80 classes, 5 epochs + patience 3, resident
    int8), each a subprocess as its user runs it, the two at once."""
    import math

    base = tmp / "drives"
    base.mkdir()

    # The two drives share the card at once (most of each is its processes'
    # starts); their times are read with the other one running.
    records = run_drives(base, (("bucket", "feature_bucket_drive", DRIVE_BUCKET),
                                ("recipe", "full_recipe_drive", DRIVE_RECIPE)))
    fb, fr = records["bucket"], records["recipe"]

    # 1. The bulk build: the kill landed mid-run, the resume rewrote nothing
    # and matches the clean build byte for byte, and each build process
    # launched one crop per image it wrote and 11 fused blocks per 128-patch
    # chunk plus 11 for its numerics gate, as its own log gives them.
    kr = fb["kill_resume"]
    if not (fb["ok"] and kr["killed_mid_run"] and kr["rewrites_after_resume"] == 0
            and kr["identical_to_uninterrupted"] and kr["stray_part_files"] == 0
            and kr["failures_logged"] == 0 and kr["featsB_complete"]):
        fail(f"drives: the bucket drive's proof failed: ok {fb['ok']}, {kr}")
    if not (fb["kernel_library"] or {}).get("unchanged_by_the_builds"):
        fail(f"drives: a build process rebuilt the kernels: {fb['kernel_library']}")
    chunks = -(-200 // 128)
    launches = fb["kernel_launches"]
    want_images = {"uninterrupted": 24, "resume": kr["resumed_images"]}
    for name, got in launches.items():
        n = got["images_written"]
        if n == 0 or want_images.get(name, n) != n \
                or (got["crop"], got["fused_mbconv"]) != (n, 11 * chunks * n + 11):
            fail(f"drives: build process {name} wrote {n} images and logged (crop,"
                 f" fused) {(got['crop'], got['fused_mbconv'])}, want"
                 f" {(n, 11 * chunks * n + 11)}")
    results["patch_crop"]["launches"] += sum(g["crop"] for g in launches.values())
    results["fused_mbconv"]["launches"] += sum(g["fused_mbconv"] for g in launches.values())
    say(f"drives: feature_bucket_drive ok: SIGKILL at {kr['files_at_kill']}/24 images,"
        f" {kr['done_before_resume']} done before the resume, featsB byte-identical to"
        f" featsA, rewrites {kr['rewrites_after_resume']}, stray .part"
        f" {kr['stray_part_files']} (before the resume {kr['part_files_before_resume']});"
        f" launches (images, crop, fused) per process "
        + ", ".join(f"{k} {(g['images_written'], g['crop'], g['fused_mbconv'])}"
                    for k, g in launches.items()))
    say(f"time drives on {smi} (both drives at once): bucket drive"
        f" {fb['wall_seconds']:.1f} s, stages"
        f" {fb['stage_seconds']}; clean build start {fb['uninterrupted_stats']}"
        f" resume {fb['resume_stats']}")

    # 2. The C2 recipe drive at reduced depth.
    parity = fr["export_parity_max_abs_diff"]
    row = {k: fr[k] for k in ("accuracy", "balanced_accuracy", "log_loss", "f1_macro",
                              "mcc")}
    if parity is None or not parity <= 1e-6:
        fail(f"drives: the recipe drive's export parity {parity} (want <= 1e-6)")
    if not all(v is not None and math.isfinite(v) for v in row.values()) \
            or not fr["subsample_realized"] or fr["device"]["type"] != "cuda":
        fail(f"drives: the recipe drive's record {row}, subsample"
             f" {fr['subsample_realized']}, device {fr['device']}")
    say(f"drives: full_recipe_drive ok: subsample {fr['subsample_realized']:.0f},"
        f" splits {fr['splits']}, epochs {fr['final_epoch']:.0f} (best"
        f" {fr['best_val_epoch']:.0f}), parity {parity:.3e}, {row}")
    say(f"time drives on {smi} (both drives at once): recipe drive"
        f" {fr['wall_seconds']:.1f} s, stages"
        f" {fr['stage_seconds']}; resident {fr['train_stage_breakdown']}")


def phase_parallel(variables, config, results, tmp: Path, smi: str):
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from mermaid_classifier_tpu_torch.inference import load_predictor
    from mermaid_classifier_tpu_torch.models.extractor import build_extractor
    from mermaid_classifier_tpu_torch.ops import patch_crop
    from mermaid_classifier_tpu_torch.parallel.mesh import make_mesh
    from mermaid_classifier_tpu_torch.parallel.preflight import (
        C2_GEOMETRY,
        production_geometry_report,
    )
    from mermaid_classifier_tpu_torch.parallel.sharded_serve import (
        load_sharded_predictor,
    )
    from mermaid_classifier_tpu_torch.parallel.sharded_train import (
        ShardedHeadTrainer,
    )
    from mermaid_classifier_tpu_torch.train.mlp_classifier import (
        MLPClassifier,
        classifier_from_arrays,
    )

    device = "cuda"
    mesh = make_mesh(device=device)
    try:
        if dist.get_backend() != "nccl" or mesh.device != torch.device("cuda", 0):
            fail(f"parallel: mesh {mesh} over {dist.get_backend()}, want nccl on cuda:0")
        rng = np.random.default_rng(SEED + 17)
        h, w = IMAGE_HW

        # Sharded extraction at full width: one crop per image per rank.
        t0 = time.perf_counter()
        image = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        pts = points(rng, 2 * PATCHES)
        crop_total = 0
        extract = []
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(config, compute_dtype=dtype)
            meshed = build_extractor(variables, cfg, device=device,
                                     backbone_impl="folded", mesh=mesh)
            single = build_extractor(variables, cfg, device=device,
                                     backbone_impl="folded")
            patch_crop.launches = 0
            got = meshed.extract_features(image, pts)
            launches = patch_crop.launches
            want = single.extract_features(image, pts)
            if launches != 1:
                fail(f"parallel: {launches} crop launches for one {dtype} image")
            crop_total += launches
            mae = float(np.abs(got - want).mean())
            bitwise = bool(np.array_equal(got, want))
            if got.shape != (len(pts), 4096) or not (bitwise or mae <= 1e-4):
                fail(f"parallel: mesh extractor {dtype} {got.shape}, MAE {mae}")
            took = {name: cuda_ms(lambda e=e: e.extract_features_device(image, pts),
                                  iters=5, warmup=1)
                    for name, e in (("mesh", meshed), ("single", single))}
            extract.append(f"{dtype} {'bitwise' if bitwise else f'MAE {mae:.2e}'}"
                           f" ({took['mesh']:.2f} ms vs {took['single']:.2f} ms)")
        results["patch_crop"]["launches"] += crop_total
        say(f"parallel extract: {mesh}, B0 224 folded, {len(pts)} points:"
            f" {', '.join(extract)}; crop launches {crop_total}"
            f" ({time.perf_counter() - t0:.1f} s)")

        # Sharded serving over the serve phase's artifact.
        t0 = time.perf_counter()
        art = tmp / "parallel_head"
        art.mkdir()
        write_head_artifact(art)
        feats = rng.standard_normal((1001, 4096), dtype=np.float32)
        a = load_sharded_predictor(art, mesh).predict_proba(feats)
        b = load_predictor(art, device=device).predict_proba(feats)
        serve_diff = float(np.abs(a - b).max())
        if a.shape != (1001, 80) or not serve_diff <= 1e-6:
            fail(f"parallel: sharded predictor {a.shape}, max |dp| {serve_diff}")
        say(f"parallel serve: 1001 rows, max |dp| vs load_predictor {serve_diff:.2e}"
            f" ({time.perf_counter() - t0:.1f} s)")

        # ShardedHeadTrainer at (1, 1) against one classifier step.
        t0 = time.perf_counter()
        sizes = (4096, *TRAIN_HIDDEN, TRAIN_CLASSES)
        init = MLPClassifier(TRAIN_HIDDEN, random_state=0, device="cpu")
        init._first_fit(sizes[0], None, np.arange(TRAIN_CLASSES))
        x = rng.standard_normal((200, 4096), dtype=np.float32)
        y = rng.integers(0, TRAIN_CLASSES, 200)
        trainer = ShardedHeadTrainer(mesh, sizes, learning_rate=TRAIN_LR)
        params = trainer.shard_params({"W": init.coefs_, "b": init.intercepts_})
        params, _, loss = trainer.train_step(
            params, trainer.init_opt_state(params),
            *trainer.place_batch(x, y, np.ones(200, np.float32)), 200.0)
        clf = classifier_from_arrays(init.coefs_, init.intercepts_,
                                     classes=list(range(TRAIN_CLASSES)),
                                     learning_rate_init=TRAIN_LR, batch_size=200,
                                     shuffle=False, device=device)
        clf.partial_fit(x, y)
        loss_rel = abs(loss / clf.loss_curve_[-1] - 1.0)
        frob = max(float(np.linalg.norm(u - v) / np.linalg.norm(v))
                   for u, v in zip(trainer.unshard_params(params)["W"], clf.coefs_))
        if not (loss_rel <= 1e-5 and frob <= 1e-5):
            fail(f"parallel: ShardedHeadTrainer vs classifier loss rel {loss_rel},"
                 f" weights rel Frobenius {frob}")
        say(f"parallel head trainer (1, 1): loss rel {loss_rel:.2e}, weights rel"
            f" Frobenius {frob:.2e} vs one MLPClassifier step"
            f" ({time.perf_counter() - t0:.1f} s)")

        # Resident training on the mesh against the single-device run.
        t0 = time.perf_counter()
        means = (rng.standard_normal((TRAIN_CLASSES, 4096))
                 * TRAIN_MEAN_STD).astype(np.float32)
        X, y_idx = train_features(rng, means, TRAIN_ROWS)
        idx = np.arange(TRAIN_ROWS)
        call = idx[:TRAIN_CHUNK]

        def call_step_ms(clf, batch):
            """Median and least ms per step of one captured resident call."""
            clf.partial_fit_resident(call, y_idx[:TRAIN_CHUNK])  # capture
            times = []
            for _ in range(7):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                clf.partial_fit_resident(call, y_idx[:TRAIN_CHUNK])
                ev[1].record()
                ev[1].synchronize()
                times.append(ev[0].elapsed_time(ev[1]) / (TRAIN_CHUNK // batch))
            times.sort()
            return times[len(times) // 2], times[0]

        step_ms = {}
        gaps = []
        for dtype in ("float32", "int8"):
            runs = {}
            for name, m in (("mesh", mesh), ("single", None)):
                clf = MLPClassifier(TRAIN_HIDDEN, learning_rate_init=TRAIN_LR,
                                    random_state=0, device=device, mesh=m)
                clf.set_resident_features(X, dtype=dtype)
                clf.partial_fit_resident(idx, y_idx, classes=list(range(TRAIN_CLASSES)))
                runs[name] = clf
            mm, ss = runs["mesh"], runs["single"]
            loss_gap = max(abs(p - q) for p, q in zip(mm.loss_curve_, ss.loss_curve_))
            w_gap = max(float(np.abs(p - q).max()) for p, q in zip(mm.coefs_, ss.coefs_))
            close = all(np.allclose(p, q, rtol=1e-5, atol=1e-6)
                        for p, q in zip(mm.coefs_, ss.coefs_))
            if not (loss_gap <= 1e-6 and close):
                fail(f"parallel: resident {dtype} mesh vs single loss gap"
                     f" {loss_gap}, weights max |dW| {w_gap}")
            gaps.append(f"{dtype} loss {loss_gap:.1e}, weights max |dW| {w_gap:.1e}")
            if dtype == "float32":
                for name, clf in runs.items():
                    step_ms[name] = call_step_ms(clf, 200)
                # The single-device step at the rows one rank of a 2- and a
                # 4-rank mesh would take if batches were regrouped by owner.
                for batch in (100, 50):
                    ss.set_params(batch_size=batch)
                    step_ms[f"single, batch {batch}"] = call_step_ms(ss, batch)
            del runs, mm, ss
        say(f"parallel resident ({TRAIN_ROWS} rows, captured steps): "
            + "; ".join(gaps) + f" ({time.perf_counter() - t0:.1f} s)")
        say(f"time parallel step on: {smi}")
        say(f"time parallel step ({TRAIN_CHUNK}-row resident call, Adam steps of"
            " 200 unless named, median of 7 calls, CUDA events around one call):"
            + ";".join(f" {name} {med:.4f} ms per step (min {low:.4f})"
                       for name, (med, low) in step_ms.items()))

        # The preflight at C2 against a real int8 buffer of that size.
        t0 = time.perf_counter()
        report = production_geometry_report(mesh)
        pre_s = time.perf_counter() - t0
        n = C2_GEOMETRY["n_rows"]
        stored = np.zeros((n, C2_GEOMETRY["dim"]), np.int8)
        before = torch.cuda.memory_allocated()
        real = MLPClassifier(TRAIN_HIDDEN, device=device, mesh=mesh)
        real.set_resident_features_storage(stored, np.ones(n, np.float32))
        real_gb = (real._resident_X.numel() * real._resident_X.element_size()) / 1e9
        alloc_gb = (torch.cuda.memory_allocated() - before) / 1e9
        want_gb = report["resident_epoch"]["buffer_gb_per_device"]
        if round(real_gb, 2) != want_gb:
            fail(f"parallel: preflight buffer {want_gb} GB, real buffer {real_gb} GB")
        del real, stored
        say(f"parallel preflight at C2 ({pre_s:.1f} s on meta): extract"
            f" {report['extract_b0']}, resident {report['resident_epoch']}, serve"
            f" {report['serve_head']}; real int8 buffer {real_gb:.4f} GB"
            f" (allocated {alloc_gb:.4f} GB with its scales) vs {want_gb} GB")
    finally:
        dist.destroy_process_group()

    # The multi-process dryrun: 2 x 2 gloo CPU ranks in a subprocess.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mermaid_classifier_tpu_torch.scripts.dryrun_multihost",
         "--processes", "4", "--local-ranks", "2", "--timeout", "120"],
        capture_output=True, text=True, timeout=180,
        env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)))
    if proc.returncode != 0 or "MULTIHOST_DRYRUN_OK: 4 processes" not in proc.stdout:
        fail(f"parallel: dryrun_multihost exit {proc.returncode}:"
             f" {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    say(f"parallel dryrun: 4 gloo ranks, 2 per host, OK"
        f" ({time.perf_counter() - t0:.1f} s)")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    from mermaid_classifier_tpu_torch.common.taxonomy import TAXONOMY_FIXTURE_ENV
    from mermaid_classifier_tpu_torch.models.efficientnet import EfficientNetConfig
    from mermaid_classifier_tpu_torch.ops import fused_mbconv as fm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    config = EfficientNetConfig()
    results = {}
    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        say(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    timed("build", phase_build)
    timed("crop", phase_crop, config, results)
    variables = perturbed_b0_variables(config)
    folded = fm.to_device(fm.fold_backbone(variables, config), "cuda")
    timed("fused", phase_fused, config, folded, results)
    timed("depthwise", phase_depthwise, config, results)
    timed("trunk", phase_trunk, variables, config)
    with tempfile.TemporaryDirectory() as tmp:
        extractor, run25 = timed("serve", phase_serve, variables, config, results,
                                 Path(tmp))
        # The kernels' profiler readings (times, bucket) come before any
        # CUDA graph is profiled: after the training phases traced graph
        # replays, later profiles in the process read device times below
        # the kernels' bounds (PERF.md, the training lane).
        trunk_rates = timed("times", phase_times, config, folded, results, extractor,
                            run25, smi)
        with restored_settings("object_store_root"):
            bucket = timed("bucket", phase_bucket, variables, config, Path(tmp), smi,
                           trunk_rates)
        # After the bucket phase's profile: this phase captures a CUDA graph
        # (its head's Adam step), and profiles after one can miss kernels.
        timed("weights", phase_weights, Path(tmp), smi)
        timed("train", phase_train, extractor, Path(tmp), smi)
        timed("trainer", phase_trainer, extractor, Path(tmp), smi)
        timed("quality", phase_quality, smi)
        with restored_env(TAXONOMY_FIXTURE_ENV):
            recipe = timed("recipe", phase_recipe, extractor, Path(tmp), smi)
        timed("trunk_ab", phase_trunk_ab, variables, config, results)
        with restored_env(TAXONOMY_FIXTURE_ENV, *PROXY_VARS, *S3_VARS), \
                restored_settings("object_store_root", "tracking_dir"):
            timed("lifecycle", phase_lifecycle, variables, config, extractor, recipe,
                  Path(tmp), smi)
        timed("jobs", phase_jobs, bucket, Path(tmp), smi)
        timed("drives", phase_drives, results, Path(tmp), smi)
        timed("parallel", phase_parallel, variables, config, results, Path(tmp), smi)
    say(f"phases: {time.perf_counter() - t_start:.1f} s in all")

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
