"""Kernel-against-plain tests that need a CUDA card (and nvcc to build the
kernels). They skip where there is none; ``python3 chip_smoke.py`` runs the
same comparisons, at the serve path's full shapes, on the card. This file
imports no jax, so it runs on a card machine without jax, skipping the
repo's jax-pinning conftest:
``python -m pytest --noconftest tests/test_torch_cuda.py -m requires_cuda``."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from mermaid_classifier_tpu_torch.models.efficientnet import (
    EfficientNetConfig,
    init_backbone_params,
)
from mermaid_classifier_tpu_torch.models.extractor import build_extractor
from mermaid_classifier_tpu_torch.ops import fused_mbconv as fm
from mermaid_classifier_tpu_torch.ops import patch_crop
from mermaid_classifier_tpu_torch.ops import patch_ops

pytestmark = pytest.mark.requires_cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


# Geometries beyond B0 at 224 px: odd map sizes (60 px -> 15, 8) and mid
# widths that are not multiples of the kernel's 32-channel tile (72, 120);
# depthwise k 7 and 1 (the fused kernel's run-time-k instance) at mid widths
# that are not multiples of 4 (15, 21; 42).
CONFIGS = {
    "b0_224": EfficientNetConfig(),
    "b0_60px": EfficientNetConfig(patch_size=60, feature_dim=128),
    "narrow_36px": EfficientNetConfig(
        stem_channels=8, stages=((1, 8, 1, 1, 3), (6, 12, 2, 2, 3),
                                 (6, 20, 2, 2, 5)),
        head_channels=32, feature_dim=48, patch_size=36),
    "odd_k_30px": EfficientNetConfig(
        stem_channels=8, stages=((1, 5, 1, 1, 3), (3, 7, 2, 1, 7),
                                 (6, 9, 1, 1, 1)),
        head_channels=16, feature_dim=16, patch_size=30),
}


def _perturbed_variables(config, rng):
    """Seeded variables with non-trivial BN statistics, so folding matters."""

    def perturb(tree):
        for key, val in tree.items():
            if key == "mean":
                tree[key] = (rng.standard_normal(val.shape) * 0.1).astype(np.float32)
            elif key == "var":
                tree[key] = (rng.random(val.shape) * 0.5 + 0.75).astype(np.float32)
            else:
                perturb(val)

    variables = init_backbone_params(0, config)
    perturb(variables["batch_stats"])
    return variables


@pytest.mark.parametrize("ps", [224, 33])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_crop_kernel_equals_plain_bitwise(cuda, out_dtype, ps):
    rng = np.random.default_rng(0)
    image = torch.from_numpy(
        rng.integers(0, 256, size=(700, 900, 3), dtype=np.uint8)).to(cuda)
    starts = np.stack([rng.integers(0, 700 - ps, 37),
                       rng.integers(0, 900 - ps, 37)], 1).astype(np.int32)
    starts[:2] = [[0, 0], [700 - ps, 900 - ps]]
    scale, bias = patch_ops.channel_scale_bias((0.485, 0.456, 0.406),
                                               (0.229, 0.224, 0.225))
    before = patch_crop.launches
    got = patch_crop.extract_patches(image, starts, ps, scale, bias, out_dtype)
    assert patch_crop.launches == before + 1
    want = patch_ops.extract_patches_plain(
        image, torch.from_numpy(starts).to(cuda), ps,
        torch.from_numpy(scale).to(cuda), torch.from_numpy(bias).to(cuda),
        out_dtype)
    assert torch.equal(got, want)


MEAN_STD = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def _crop_image(cuda, rng, h, w, kind):
    """A random (h, w, 3) uint8 image on the card: contiguous, or a view at
    an odd byte offset inside a larger buffer (``odd_offset``)."""
    image = torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    if kind != "odd_offset":
        return image.to(cuda)
    flat = torch.from_numpy(rng.integers(0, 256, image.numel() + 64,
                                         dtype=np.uint8)).to(cuda)
    view = flat[13:13 + image.numel()].view(h, w, 3).copy_(image.to(cuda))
    assert view.data_ptr() % 2 == 1
    return view


def _crop_points(rng, h, w, n):
    """n points of an (h, w) image, its four corners and four edge
    midpoints first."""
    edges = [[0, 0], [0, w - 1], [h - 1, 0], [h - 1, w - 1], [h // 2, 0],
             [h // 2, w - 1], [0, w // 2], [h - 1, w // 2]]
    pts = np.stack([rng.integers(0, h, n), rng.integers(0, w, n)], 1)
    pts[:min(n, len(edges))] = edges[:n]
    return pts.astype(np.int32)


# (h, w) per image kind: a full image, the same at an odd byte offset, and
# an image narrower than every patch size (the crop is mostly zeros).
CROP_IMAGES = {"full": (300, 460), "odd_offset": (300, 460), "narrow": (90, 6)}


@pytest.mark.parametrize("kind", sorted(CROP_IMAGES))
@pytest.mark.parametrize("pad_mode", ["padded", "raw"])
@pytest.mark.parametrize("ps", [224, 33, 16, 8])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_crop_kernel_cases_bitwise(cuda, out_dtype, ps, pad_mode, kind):
    """The crop kernel equals its plain version bit for bit at 1, 32 and
    128 points with every edge and corner among them: on the host-padded
    image at pad 0 and on the raw image at pad ps//2, where it also equals
    the pad-0 crop of the host-padded image."""
    rng = np.random.default_rng(ps)
    h, w = CROP_IMAGES[kind]
    raw = _crop_image(cuda, rng, h, w, kind)
    padded = patch_ops.pad_image(raw, ps).contiguous()
    scale, bias = patch_ops.channel_scale_bias(*MEAN_STD)
    s_dev, b_dev = torch.from_numpy(scale).to(cuda), torch.from_numpy(bias).to(cuda)
    for n in (1, 32, 128):
        starts = _crop_points(rng, h, w, n)
        image, pad = (raw, ps // 2) if pad_mode == "raw" else (padded, 0)
        before = patch_crop.launches
        got = patch_crop.extract_patches(image, starts, ps, scale, bias,
                                         out_dtype, pad=pad)
        assert patch_crop.launches == before + 1
        want = patch_ops.extract_patches_plain(
            image, torch.from_numpy(starts).to(cuda), ps, s_dev, b_dev,
            out_dtype, pad=pad)
        assert torch.equal(got, want), (n, float((got.float() - want.float()).abs().max()))
        if pad:
            assert torch.equal(got, patch_crop.extract_patches(
                padded, starts, ps, scale, bias, out_dtype))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_crop_launch_entry(cuda, out_dtype):
    """The launch-only entry counts one launch and fills its output as the
    wrapper does, also into an output that is not 16-byte aligned (the
    scalar-store instance)."""
    rng = np.random.default_rng(1)
    ps = 224
    raw = _crop_image(cuda, rng, 500, 700, "full")
    starts = _crop_points(rng, 500, 700, 32)
    scale, bias = patch_ops.channel_scale_bias(*MEAN_STD)
    affine = (*map(float, scale), *map(float, bias))
    want = patch_crop.extract_patches(raw, starts, ps, scale, bias, out_dtype,
                                      pad=ps // 2)
    starts_dev = torch.from_numpy(starts).to(cuda)
    n_out = want.numel()
    for offset in (0, 1):  # elements into the buffer: aligned, then not
        flat = torch.empty(n_out + 8, dtype=out_dtype, device=cuda)
        out = flat[offset:offset + n_out].view(want.shape)
        before = patch_crop.launches
        got = patch_crop.launch(raw, starts_dev, out, affine, ps // 2)
        assert got is out and patch_crop.launches == before + 1
        assert torch.equal(out, want), offset


def _fused_rels(cuda, name, dtype, patches, only=None):
    """Max rel of the fused kernel against its plain version, on
    ``patches`` seeded patches, for each fusable block of the config, or
    for the blocks of (Cin, Cmid, Cout) ``only``, run at stride 1 on their
    input map."""
    config = CONFIGS[name]
    rng = np.random.default_rng(1)
    folded = fm.to_device(
        fm.fold_backbone(_perturbed_variables(config, rng), config), cuda)
    rels = []
    for blk in folded["blocks"]:
        meta = blk["meta"]
        if only is not None:
            if only != (meta.in_channels, meta.mid_channels, meta.out_channels):
                continue
            meta = replace(meta, stride=1, residual=False)
            blk = {**blk, "meta": meta}
        if not fm.fusable(meta):
            continue
        x = torch.from_numpy(rng.standard_normal(
            (patches, meta.h, meta.w, meta.in_channels)).astype(np.float32)).to(cuda, dtype)
        before = fm.launches
        got = fm.fused_mbconv(x, blk)
        assert fm.launches == before + 1
        with fm.full_f32():
            want = fm.fused_mbconv_reference(x, blk)
        assert got.shape == want.shape and torch.isfinite(got.float()).all()
        rels.append((float((got.float() - want.float()).abs().max()
                           / want.float().abs().max()), meta))
    return rels


# (config, patches, blocks): the four configs at 9 patches; the narrow
# config's 9^2 k5 block whose K and N are no multiple of the mma tile (Cin
# 12, Cmid 72, Cout 20; stride 2 in the config, run at stride 1); 1 and 3
# patches for the M tails (49 and 196 positions of a 64-position tile at B0
# 224).
FUSED_CASES = {
    "b0_224": ("b0_224", 9, None),
    "b0_60px": ("b0_60px", 9, None),
    "narrow_36px": ("narrow_36px", 9, None),
    "odd_k_30px": ("odd_k_30px", 9, None),
    "narrow_12_72_20": ("narrow_36px", 9, (12, 72, 20)),
    "b0_224_1_patch": ("b0_224", 1, None),
    "b0_224_3_patches": ("b0_224", 3, None),
    "narrow_36px_1_patch": ("narrow_36px", 1, None),
}


# bf16: the plain version rounds where the kernel does, so the two differ
# by a bf16 rounding of the expanded map or of m moved by a sum order
# (3.6e-3 at B0 224), and the limit is 1e-2 rather than the 0.05 of the
# comparison with the JAX kernel, which rounds elsewhere.
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5),
                                         (torch.bfloat16, 1e-2)])
def test_fused_kernel_matches_plain(cuda, case, dtype, bound):
    name, patches, only = FUSED_CASES[case]
    rels = _fused_rels(cuda, name, dtype, patches, only)
    assert rels
    print(f"fused {case} {dtype}: max rel {max(r for r, _ in rels):.3e}")
    for rel, meta in rels:
        assert rel <= bound, (meta, rel)


def test_fused_kernel_f32_at_every_b0_224_block(cuda):
    """Split TF32 keeps f32 accuracy: rel <= 1e-5 at all 11 fusable B0 224
    blocks (9 patches)."""
    rels = _fused_rels(cuda, "b0_224", torch.float32, 9)
    assert len(rels) == 11
    assert max(r for r, _ in rels) <= 1e-5, rels


def test_fused_kernel_rejects_even_k(cuda):
    """SAME taps are symmetric only for an odd k: an even k on the card
    raises before any launch."""
    config = CONFIGS["narrow_36px"]
    folded = fm.to_device(fm.fold_backbone(
        _perturbed_variables(config, np.random.default_rng(6)), config), cuda)
    blk = next(b for b in folded["blocks"] if fm.fusable(b["meta"]))
    meta = replace(blk["meta"], kernel=4)
    x = torch.zeros((1, meta.h, meta.w, meta.in_channels), device=cuda)
    before = fm.launches
    with pytest.raises(ValueError, match="odd depthwise k"):
        fm.fused_mbconv(x, {**blk, "meta": meta})
    assert fm.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pass1_smem_formula_matches_kernel(cuda, dtype):
    """The wrapper's copy of pass 1's shared-memory formula and budget,
    which picks the rows per tile, equals the kernel's own, over every
    fusable block of the configs and a sweep of Cin, k and map widths."""
    from mermaid_classifier_tpu_torch import _build

    lib = _build.load()
    bf16 = dtype == torch.bfloat16
    assert lib.mct_fused_pass1_smem_budget() == fm._PASS1_SMEM_BUDGET
    geoms = {(m.w, m.in_channels, m.kernel)
             for config in CONFIGS.values() for m in fm.block_metas(config)
             if fm.fusable(m)}
    geoms |= {(w, cin, k) for w in (7, 15, 56) for cin in range(1, 200)
              for k in (1, 3, 5, 7)}
    for w, cin, k in sorted(geoms):
        for rows in (1, 5, 16):
            assert lib.mct_fused_pass1_smem_bytes(int(bf16), rows, w, cin, k) \
                == 4 * fm._pass1_smem_floats(rows, w, cin, k, bf16), (w, cin, k)


@pytest.mark.parametrize("name", ["b0_60px", "narrow_36px", "odd_k_30px"])
def test_fused_extractor_matches_cpu_module(cuda, name):
    """The whole f32 serve-path extractor on the card (crop kernel, fused
    kernel, cuDNN blocks) against the f32 nn.Module path on the CPU."""
    config = CONFIGS[name]
    variables = _perturbed_variables(config, np.random.default_rng(2))
    card = build_extractor(variables, config, device=cuda, backbone_batch=8,
                           point_bucket=4, image_bucket=64)
    cpu = build_extractor(variables, config, device="cpu",
                          backbone_impl="module")
    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, size=(90, 70, 3), dtype=np.uint8)
    pts = np.stack([rng.integers(0, 90, 11), rng.integers(0, 70, 11)], 1)
    pts[:2] = [[0, 0], [89, 69]]
    got = card.extract_features(image, pts)
    want = cpu.extract_features(image, pts)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-4, rel


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_kernel_equals_plain_bitwise(cuda, name, dtype):
    """Every stride-1 depthwise geometry of the config (odd maps, widths
    that are not multiples of the kernel's 32-channel tile): the kernel
    equals its plain version bit for bit."""
    from mermaid_classifier_tpu_torch.ops import depthwise as dw

    rng = np.random.default_rng(4)
    geoms = {(m.h, m.mid_channels, m.kernel)
             for m in fm.block_metas(CONFIGS[name]) if m.stride == 1}
    assert geoms
    for h, c, k in sorted(geoms):
        x = torch.from_numpy(rng.standard_normal((9, h, h, c)).astype(
            np.float32)).to(cuda, dtype)
        w = torch.from_numpy((rng.standard_normal((k, k, c)) * 0.2).astype(
            np.float32)).to(cuda)
        b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(cuda)
        before = dw.launches
        got = dw.depthwise_conv(x, w, b, kernel=k)
        assert dw.launches == before + 1
        want = dw.depthwise_conv_reference(x, w, b, kernel=k)
        assert torch.equal(got, want), (h, c, k)


# (batch, map, channels, k, misaligned): widths that are not multiples of
# the kernel's 8 outputs per thread (1, 7, 13, 113), channel counts that
# are not multiples of its 32-channel group or of the 16-byte vector (5,
# 20 for bf16, 72) and the widest B0 group (1152), k 1 to 7 (1 and 7 take
# the run-time-k instance), one and three maps, and views one element into
# their storage (not 16-byte aligned: the scalar-load instance).
DEPTHWISE_CASES = {
    "w1": (3, 1, 24, 3, False),
    "w7": (3, 7, 24, 5, False),
    "w13": (3, 13, 24, 3, False),
    "w113": (3, 113, 24, 3, False),
    "c5": (3, 13, 5, 3, False),
    "c20": (3, 13, 20, 5, False),
    "c72": (3, 13, 72, 3, False),
    "c1152": (3, 7, 1152, 5, False),
    "k1": (3, 13, 40, 1, False),
    "k3": (3, 13, 40, 3, False),
    "k5": (3, 13, 40, 5, False),
    "k7": (3, 13, 40, 7, False),
    "n1": (1, 28, 240, 5, False),
    "n3": (3, 56, 144, 3, False),
    "misaligned_k3": (3, 13, 32, 3, True),
    "misaligned_k5": (2, 14, 480, 5, True),
    "misaligned_k7": (3, 9, 24, 7, True),
}


@pytest.mark.parametrize("case", sorted(DEPTHWISE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_kernel_cases_bitwise(cuda, case, dtype):
    """The depthwise kernel equals its plain version bit for bit on the
    shapes that reach each of its instances and masks."""
    from mermaid_classifier_tpu_torch.ops import depthwise as dw

    n, h, c, k, misaligned = DEPTHWISE_CASES[case]
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((n, h, h, c)).astype(
        np.float32)).to(cuda, dtype)
    if misaligned:
        flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
        x = flat[1:].view(x.shape).copy_(x)
        assert x.data_ptr() % 16 != 0
    w = torch.from_numpy((rng.standard_normal((k, k, c)) * 0.2).astype(
        np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(cuda)
    vector = not misaligned and c % (8 if dtype == torch.bfloat16 else 4) == 0
    assert dw.tile_plan(n, h, h, c, k, dtype, x.data_ptr()).vector_loads is vector
    before = dw.launches
    got = dw.depthwise_conv(x, w, b, kernel=k)
    assert dw.launches == before + 1
    want = dw.depthwise_conv_reference(x, w, b, kernel=k)
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_smem_formula_matches_kernel(cuda, dtype):
    """The wrapper's copy of the depthwise kernel's shared-memory formula,
    which picks the band and strip, equals the kernel's own over a sweep of
    widths, k, bands and strips (one strip and a ring of strips)."""
    from mermaid_classifier_tpu_torch import _build
    from mermaid_classifier_tpu_torch.ops import depthwise as dw

    lib = _build.load()
    bf16 = dtype == torch.bfloat16
    for w in (1, 7, 8, 13, 14, 28, 56, 112, 113, 300):
        for k in (1, 3, 5, 7):
            for band, strip in ((1, 1), (15, 3), (15, 15), (37, 8), (49, 64)):
                assert lib.mct_depthwise_smem_bytes(int(bf16), band, strip, w, k) \
                    == dw._smem_bytes(band, strip, w, k, 2 if bf16 else 4), (w, k)


def test_fused_w8_schedule_launches_and_passes_gate(cuda):
    """``folded+fused+w8`` (int8 triples into the fused kernel's wrapper)
    launches the fused kernel once per fusable block and agrees with
    ``folded`` at the 0.999 cosine gate."""
    from mermaid_classifier_tpu_torch.experiments import trunk_ab as ta

    config = CONFIGS["b0_60px"]
    variables = _perturbed_variables(config, np.random.default_rng(5))
    f_ref, w_ref = ta.build_forward("folded", None, variables, config,
                                    device=cuda)
    f_w8, w_w8 = ta.build_forward("folded+fused+w8", None, variables, config,
                                  device=cuda)
    before = fm.launches
    cos = ta.gate_cosine(f_ref, w_ref, f_w8, w_w8, config, device=cuda,
                         chunk=16)
    assert fm.launches - before == sum(map(fm.fusable, fm.block_metas(config)))
    assert cos >= 0.999, cos


# --- the head-training lane on the card ------------------------------------


def _train_data(n, d, k, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, size=n)
    means = rng.normal(0.0, 0.3, size=(k, d)).astype(np.float32)
    X = rng.standard_normal((n, d), dtype=np.float32) + means[y]
    return X, np.array([f"c{i:02d}" for i in range(k)])[y]


def test_training_on_cuda_matches_cpu(cuda):
    """One partial_fit from the same weights on each device (d 1024, hidden
    (256, 64), 20 classes, 2,000 rows): loss within rel 1e-4, each weight
    matrix within 1e-4 relative Frobenius norm, probabilities within 1e-4."""
    from mermaid_classifier_tpu_torch.train.mlp_classifier import (
        MLPClassifier,
        classifier_from_arrays,
    )

    X, y = _train_data(2000, 1024, 20, seed=0)
    kw = dict(random_state=0, learning_rate_init=1e-4)
    init = MLPClassifier((256, 64), device="cpu", **kw)
    init.classes_, init.n_features_in_ = np.unique(y), X.shape[1]
    init._init_params()
    clfs = [classifier_from_arrays(init.coefs_, init.intercepts_,
                                   classes=np.unique(y), device=dev, **kw)
            for dev in ("cpu", cuda)]
    for clf in clfs:
        clf.partial_fit(X, y)
    cpu, gpu = clfs
    assert gpu.loss_curve_[0] == pytest.approx(cpu.loss_curve_[0], rel=1e-4)
    for got, want in zip(gpu.coefs_, cpu.coefs_):
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
    assert np.abs(gpu.predict_proba(X[:500]) - cpu.predict_proba(X[:500])).max() <= 1e-4


def test_device_calibration_matches_scipy_on_cuda(cuda):
    """The batched Newton solve on the card against the scipy fits: rtol
    2e-3, atol 2e-4 (the JAX test's bounds)."""
    from mermaid_classifier_tpu_torch.train.calibration import (
        fit_sigmoid_calibration,
        fit_sigmoid_calibration_batch,
    )

    rng = np.random.default_rng(10)
    n, k = 4000, 12
    raw = rng.random((n, k))
    proba = raw / raw.sum(axis=1, keepdims=True)
    y = np.argmax(proba + rng.normal(0, 0.2, (n, k)), axis=1)
    targets = (y[:, None] == np.arange(k)).astype(np.float64)
    a, b = fit_sigmoid_calibration_batch(proba, targets, device=cuda)
    for col in range(k):
        a_ref, b_ref = fit_sigmoid_calibration(proba[:, col], targets[:, col])
        assert a[col] == pytest.approx(a_ref, rel=2e-3, abs=2e-4)
        assert b[col] == pytest.approx(b_ref, rel=2e-3, abs=2e-4)


def test_export_gate_on_cuda(cuda, tmp_path):
    """A head trained on the card passes the 1e-6 gate with the torch pin
    enforced, and the artifact serves on the card."""
    from mermaid_classifier_tpu_torch.inference import export_artifact, load_predictor
    from mermaid_classifier_tpu_torch.train.calibration import CalibratedClassifier
    from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier

    X, y = _train_data(2000, 256, 10, seed=1)
    clf = MLPClassifier((64, 32), random_state=0, learning_rate_init=1e-3,
                        device=cuda)
    for _ in range(3):
        clf.partial_fit(X, y, classes=np.unique(y))
    model = CalibratedClassifier.fit_from_scores(
        clf, clf.predict_proba(X[:1000]), y[:1000], backend="device", device=cuda)
    _, _, diff = export_artifact(model, tmp_path, X[1000:])
    assert diff <= 1e-6
    pred = load_predictor(tmp_path, device=cuda)
    assert np.abs(pred.predict_proba(X[1000:]) - model.predict_proba(X[1000:])).max() <= 1e-6


# --- the fixed-shape Adam step, captured as a CUDA graph ---------------------


def _same_weights(a, b) -> bool:
    return all(np.array_equal(u, v) for u, v in
               zip(a.coefs_ + a.intercepts_, b.coefs_ + b.intercepts_))


def _resident_clf(cuda, X, dtype="float32", **kw):
    from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier

    clf = MLPClassifier((256, 64), random_state=0, learning_rate_init=1e-3,
                        device=cuda, **kw)
    return clf.set_resident_features(X, dtype=dtype)


def test_captured_step_equals_eager_step(cuda):
    """Two calls (3,000 rows, a padded tail), the step captured against the
    same step run eagerly on the card from the same state: weights, biases
    and losses bitwise equal."""
    X, y = _train_data(3000, 1024, 20, seed=2)
    captured = _resident_clf(cuda, X)
    eager = _resident_clf(cuda, X)
    eager.capture_step = False
    for clf in (captured, eager):
        for _ in range(2):
            clf.partial_fit_resident(np.arange(3000), y, classes=np.unique(y))
    assert captured._runners and all(r.graph is not None
                                     for r in captured._runners.values())
    assert all(r.graph is None for r in eager._runners.values())
    assert captured.loss_curve_ == eager.loss_curve_
    assert _same_weights(captured, eager)


@pytest.mark.parametrize("class_weight", [None, "ramp"])
def test_resident_equals_streamed_on_cuda(cuda, class_weight):
    """partial_fit_resident and partial_fit on the gathered rows, both
    captured, bitwise equal on the card (n 2,130: a tail of 130)."""
    X, y = _train_data(2130, 1024, 20, seed=3)
    weights = (None if class_weight is None else
               {c: 1.0 + 0.1 * i for i, c in enumerate(np.unique(y))})
    resident = _resident_clf(cuda, X, class_weight=weights)
    from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier

    streamed = MLPClassifier((256, 64), random_state=0, learning_rate_init=1e-3,
                             class_weight=weights, device=cuda)
    order = np.random.default_rng(0).permutation(2130)
    for start in (0, 1000, 2000):
        idx = order[start:start + 1000]
        resident.partial_fit_resident(idx, y[idx], classes=np.unique(y))
        streamed.partial_fit(X[idx], y[idx], classes=np.unique(y))
    assert resident.loss_curve_ == streamed.loss_curve_
    assert _same_weights(resident, streamed)


def test_graph_recaptured_after_set_state_and_snapshot_restore(cuda):
    """New parameter tensors (``_set_state``, a restored deepcopy snapshot)
    drop the old graphs; the next call captures anew and trains exactly as a
    twin built from the same state."""
    import copy

    from mermaid_classifier_tpu_torch.train.mlp_classifier import (
        classifier_from_arrays,
    )

    X, y = _train_data(2000, 512, 10, seed=4)
    clf = _resident_clf(cuda, X)
    idx = np.arange(2000)
    clf.partial_fit_resident(idx, y, classes=np.unique(y))
    old = list(clf._runners.values())
    snapshot = copy.deepcopy(clf)
    assert not getattr(snapshot, "_runners", None)
    assert snapshot._resident_X is clf._resident_X
    clf.partial_fit_resident(idx, y)  # moves clf on; the snapshot stays

    state = (clf.coefs_, clf.intercepts_, {
        "count": clf._adam_state()["count"],
        **{k: {p: [t.cpu().numpy() for t in v[p]] for p in ("W", "b")}
           for k, v in clf._adam_state().items() if k != "count"}})
    clf._set_state(*state)
    assert clf._runners == {}
    twin = classifier_from_arrays(state[0], state[1], classes=np.unique(y),
                                  adam=state[2], device=cuda, random_state=0,
                                  learning_rate_init=1e-3)
    twin._resident_X, twin._resident_scale = clf._resident_X, None
    twin._resident_n_rows, twin._resident_dtype = 2000, "float32"
    twin.capture_step = False
    clf.partial_fit_resident(idx, y)
    twin.partial_fit_resident(idx, y)
    assert all(r not in old for r in clf._runners.values())
    assert _same_weights(clf, twin)

    restored = copy.deepcopy(snapshot)
    restored.capture_step = False
    snapshot.partial_fit_resident(idx, y)  # captures its own graph
    restored.partial_fit_resident(idx, y)
    assert _same_weights(snapshot, restored)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_reduced_storage_against_f32_on_cuda(cuda, dtype):
    """The repo's reduced-precision gate on the card: the same trained
    params over the stored rows against the f32 rows, min row cosine >=
    0.999; the model trained on stored rows against the f32-trained one,
    min row cosine >= 0.999 on these separable data."""
    X, y = _train_data(4000, 1024, 20, seed=5)
    f32, low = _resident_clf(cuda, X), _resident_clf(cuda, X, dtype=dtype)
    for clf in (f32, low):
        for _ in range(3):
            clf.partial_fit_resident(np.arange(4000), y, classes=np.unique(y))

    def min_cosine(a, b):
        num = np.sum(a * b, axis=1)
        return float(np.min(num / np.maximum(np.linalg.norm(a, axis=1)
                                             * np.linalg.norm(b, axis=1), 1e-12)))

    rows = np.arange(1000)
    assert min_cosine(low.predict_proba_resident(rows), low.predict_proba(X[rows])) >= 0.999
    assert min_cosine(low.predict_proba(X[rows]), f32.predict_proba(X[rows])) >= 0.999


def test_eval_counts_and_indices_on_cuda(cuda):
    """The fused eval and the device argmax against the host metrics on the
    card: the count exact, the loss within rel 1e-5."""
    from mermaid_classifier_tpu_torch.train.trainer import log_loss

    X, y = _train_data(3000, 512, 10, seed=6)
    clf = _resident_clf(cuda, X, dtype="int8")
    idx = np.arange(3000)
    clf.partial_fit_resident(idx, y, classes=np.unique(y))
    proba = clf.predict_proba_resident(idx)
    np.testing.assert_array_equal(clf.predict_indices_resident(idx), proba.argmax(1))
    y_idx = np.searchsorted(clf.classes_, y)
    counts = clf.eval_counts_resident(idx, y_idx)
    assert counts[0] == (proba.argmax(1) == y_idx).sum()
    assert counts[1] / 3000 == pytest.approx(log_loss(y, proba, labels=clf.classes_),
                                             rel=1e-5)


def test_trainer_resident_equals_streamed_on_cuda(cuda, tmp_path):
    """MermaidTrainer on the card, resident f32 and streamed: the same
    weights bit for bit, the same accuracies and early-stop record."""
    from mermaid_classifier_tpu_torch.data.features_io import write_feature_file
    from mermaid_classifier_tpu_torch.data.labels import ImageLabels, preprocess_labels
    from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier
    from mermaid_classifier_tpu_torch.train.trainer import MermaidTrainer

    X, y = _train_data(3000, 256, 8, seed=7)
    labels = ImageLabels()
    rowcols = np.stack([np.arange(20) * 3, np.arange(20) * 7], 1).astype(np.int32)
    for i in range(150):
        path = str(tmp_path / f"img_{i:03d}.features.npz")
        write_feature_file(path, rowcols, X[i * 20:(i + 1) * 20])
        labels.add_image(path, [(int(r), int(c), str(lab)) for (r, c), lab in
                                zip(rowcols, y[i * 20:(i + 1) * 20])])
    task = preprocess_labels(labels, split_ratios=(0.15, 0.15))

    class Small(MermaidTrainer):
        def _make_classifier(self, class_weight):
            return MLPClassifier((64,), learning_rate_init=1e-3, random_state=0,
                                 class_weight=class_weight, device=cuda)

    out = []
    for resident in (False, True):
        trainer = Small(batch_size=500, early_stopping_patience=2, device=cuda,
                        device_resident=resident, calibration_backend="device")
        out.append((trainer, *trainer(task, nbr_epochs=3, pc_models=[])))
    (ta, ca, va, ma), (tb, cb, vb, mb) = out
    assert ma.ref_accs == mb.ref_accs
    assert _same_weights(ca.estimator, cb.estimator)
    assert ta._early_stop_info["best_val_epoch"] == tb._early_stop_info["best_val_epoch"]
    assert va.est == vb.est


def test_capture_failure_raises(cuda, monkeypatch):
    """A step that cannot be captured raises; the eager loop is not run in
    its place, and the state is the one before the call."""
    from mermaid_classifier_tpu_torch.train import mlp_classifier as tmlp

    X, y = _train_data(1000, 256, 5, seed=8)
    clf = _resident_clf(cuda, X)
    clf.partial_fit_resident(np.arange(1000), y, classes=np.unique(y))
    before = clf.coefs_
    real = tmlp.mlp_logits

    def refuses_capture(*args):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("no capture here")
        return real(*args)

    monkeypatch.setattr(tmlp, "mlp_logits", refuses_capture)
    clf.learning_rate_init = 2e-3  # a new hyperparameter: a new capture
    with pytest.raises(RuntimeError, match="capture of the Adam step failed"):
        clf.partial_fit_resident(np.arange(1000), y)
    assert all(np.array_equal(u, v) for u, v in zip(clf.coefs_, before))
    assert len(clf.loss_curve_) == 1
    monkeypatch.setattr(tmlp, "mlp_logits", real)
    clf.partial_fit_resident(np.arange(1000), y)
    assert len(clf.loss_curve_) == 2 and np.isfinite(clf.loss_curve_[-1])


def _npy_bytes(array) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, array)
    return buf.getvalue()


def test_bucket_on_cuda_equals_per_image_extraction(cuda, tmp_path):
    """The feature-bucket builder on the card (decode-ahead, the event
    hand-off, the writer thread) writes each image's features bit for bit
    as a per-image ``extract_features`` call computes them; ragged point
    counts span one to three 8-patch chunks."""
    import io

    from mermaid_classifier_tpu_torch.data.feature_bucket import (
        FeatureBucketBuilder,
        annotations_key,
        feature_key,
    )
    from mermaid_classifier_tpu_torch.data.features_io import read_feature_file
    from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore

    config = CONFIGS["b0_60px"]
    extractor = build_extractor(
        _perturbed_variables(config, np.random.default_rng(2)), config,
        device=cuda, backbone_batch=8, point_bucket=4)
    store = LocalFSObjectStore(tmp_path / "store")
    rng = np.random.default_rng(4)
    lines, images = ["image_id,image_key,row,col"], {}
    for i, n in enumerate((1, 8, 9, 23, 5)):
        h, w = 70 + 7 * i, 90 - 5 * i
        images[str(i)] = image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        store.put_bytes("src", f"s1/{i}.npy", _npy_bytes(image))
        pts = np.stack([rng.integers(0, h, n), rng.integers(0, w, n)], 1)
        pts[0] = (h - 1, 0)
        lines += [f"{i},s1/{i}.npy,{r},{c}" for r, c in pts]
    store.put_bytes("src", annotations_key("1"), "\n".join(lines).encode())
    result = FeatureBucketBuilder(store, "src", "dst", extractor,
                                  decode_workers=2, prefetch=3).run(["1"])
    assert (result.exit_code, result.sources[0].images_done) == (0, 5)
    for image_id, image in images.items():
        rowcols, features = read_feature_file(io.BytesIO(
            store.get_bytes("dst", feature_key("1", image_id))))
        want = extractor.extract_features(image, rowcols)
        assert features.dtype == np.float32
        np.testing.assert_array_equal(features, want)


def test_readback_waits_for_its_own_image_only(cuda):
    """``FeatureReadback.wait`` returns image A's features without waiting
    for the stream: image B and a one-second spin queued after A on the
    same stream are still running when it returns; then B's own wait
    returns B's features. (The spin goes after B: B's pageable upload
    waits for the stream before it is queued.)"""
    config = CONFIGS["b0_60px"]
    extractor = build_extractor(
        _perturbed_variables(config, np.random.default_rng(2)), config,
        device=cuda, backbone_batch=8, point_bucket=4)
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, (80, 96, 3), dtype=np.uint8) for _ in range(2)]
    points = [np.stack([rng.integers(0, 80, n), rng.integers(0, 96, n)], 1)
              for n in (13, 6)]
    want = [extractor.extract_features(im, pts) for im, pts in zip(images, points)]
    torch.cuda.synchronize()
    a = extractor.extract_features_async(images[0], points[0])
    b = extractor.extract_features_async(images[1], points[1])
    torch.cuda._sleep(2_000_000_000)  # about one second of spinning
    got_a = a.wait()
    assert not torch.cuda.current_stream(cuda).query()  # the stream still runs
    np.testing.assert_array_equal(got_a, want[0])
    np.testing.assert_array_equal(b.wait(), want[1])


def _recipe_store(root, rng, classes, dim, images=60, pts=20):
    """A small seeded recipe environment with no parquet: MERMAID-layout
    feature files (a class mean plus noise) and the annotation table as an
    .npz of columns."""
    from mermaid_classifier_tpu_torch.data.features_io import write_feature_file

    means = rng.standard_normal((len(classes), dim)).astype(np.float32)
    rowcols = np.stack([np.arange(pts) * 3, np.arange(pts) * 7], 1).astype(np.int32)
    cols = {k: [] for k in ("image_id", "row", "col", "benthic_attribute_id",
                            "growth_form_id")}
    for i in range(images):
        y = rng.integers(0, len(classes), pts)
        x = rng.standard_normal((pts, dim)).astype(np.float32) * 0.3 + means[y]
        write_feature_file(root / "store" / "b" / "mermaid" / f"m{i:03d}.features.npz",
                           rowcols, x)
        for (r, c), k in zip(rowcols, y):
            cols["image_id"].append(f"m{i:03d}")
            cols["row"].append(int(r))
            cols["col"].append(int(c))
            cols["benthic_attribute_id"].append(classes[k])
            cols["growth_form_id"].append("None")
    np.savez(root / "mermaid.npz", **{k: np.asarray(v) for k, v in cols.items()})


def test_recipe_runner_on_cuda_serves_models_spec(cuda, tmp_path, monkeypatch):
    """TrackingTrainingRunner on the card, resident bf16: the artifact eval
    takes the resident gather (``artifact_eval_inputs``), the export gate
    passes, the four ported metric groups log, and the registered version
    serves through ``models:/`` with the crop and fused kernels launched as
    for a local predictor, at the same probabilities."""
    import json

    from mermaid_classifier_tpu_torch.common import relational, taxonomy
    from mermaid_classifier_tpu_torch.config.options import (
        DatasetOptions,
        TrackingOptions,
        TrainingOptions,
    )
    from mermaid_classifier_tpu_torch.config.settings import override_settings
    from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
    from mermaid_classifier_tpu_torch.inference import load_predictor
    from mermaid_classifier_tpu_torch.serve.annotation import AnnotationRun
    from mermaid_classifier_tpu_torch.tracking import LocalTracker
    from mermaid_classifier_tpu_torch.train.runner import TrackingTrainingRunner

    config = CONFIGS["b0_60px"]
    rng = np.random.default_rng(5)
    roots = [{"id": f"root{r}", "name": f"Root {r}", "parent": None} for r in range(2)]
    genera = [{"id": f"ba{i}", "name": f"Genus {i}", "parent": f"root{i % 2}"}
              for i in range(6)]
    fixture = tmp_path / "taxonomy"
    fixture.mkdir()
    (fixture / "benthic_attributes.json").write_text(json.dumps(roots + genera))
    (fixture / "growth_forms.json").write_text("{}")
    (fixture / "label_mappings.json").write_text("[]")
    monkeypatch.setenv(taxonomy.TAXONOMY_FIXTURE_ENV, str(fixture))
    taxonomy.get_benthic_attribute_library.cache_clear()
    taxonomy.get_growth_form_library.cache_clear()
    _recipe_store(tmp_path, rng, [g["id"] for g in genera], config.feature_dim)

    def read_npz(path):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k].tolist() for k in z.files}

    monkeypatch.setattr(relational, "read_parquet_columns", read_npz)
    tracker = LocalTracker(tmp_path / "tracking")
    with override_settings(mermaid_train_data_bucket="b",
                           mermaid_annotations_parquet_pattern=str(tmp_path / "mermaid.npz"),
                           feature_cache_dir=str(tmp_path / "cache"), batch_size=500):
        runner = TrackingTrainingRunner(
            DatasetOptions(),
            TrainingOptions(epochs=3, early_stopping_patience=2, device_resident=True,
                            resident_dtype="bfloat16", calibration_backend="device"),
            tracking_options=TrackingOptions(experiment_name="e", model_name="card"),
            tracker=tracker, store=LocalFSObjectStore(tmp_path / "store"), device=cuda)
        _, registered = runner.run()
    run = tracker.runs("e")[-1]
    assert run.params()["artifact_eval_inputs"] == "resident(bfloat16)"
    metrics = run.latest_metrics()
    assert metrics["export_parity_max_abs_diff"] <= 1e-6
    for name in ("balanced_accuracy", "mcc", "precision_macro", "recall_macro",
                 "f1_macro", "log_loss", "accuracy"):
        assert name in metrics
    assert registered.name == "v1"

    extractor = build_extractor(_perturbed_variables(config, rng), config, device=cuda)
    image = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    points = tmp_path / "points.csv"
    points.write_text("row,col\n" + "".join(f"{r},{c}\n" for r, c in
                                            zip(range(0, 240, 12), range(0, 320, 16))))
    runs = []
    for classifier in (load_predictor(registered, device=cuda), "models:/card"):
        ann = AnnotationRun(image, points, classifier, extractor=extractor,
                            tracker_root=tracker.root)
        patch_crop.launches = 0
        fm.launches = 0
        ann.run()
        torch.cuda.synchronize()
        runs.append((ann.proba, patch_crop.launches, fm.launches))
    (p0, c0, f0), (p1, c1, f1) = runs
    assert (c1, f1) == (c0, f0) and c0 == 1 and f0 > 0
    np.testing.assert_array_equal(p1, p0)


def test_classifier_train_cli_on_cuda(cuda, tmp_path, monkeypatch):
    """``classifier_train`` on the card from a YAML directory whose env block
    names the store, bucket, annotation table, taxonomy, feature cache and
    tracking dir: exit 0, all nine metric groups timed, the export gate
    passed with the torch pin enforced, the model registered, and each
    figure either written or named in ``figures_not_written``."""
    import json
    import os
    from pathlib import Path

    from mermaid_classifier_tpu_torch.common import relational, taxonomy
    from mermaid_classifier_tpu_torch.config import settings as tset
    from mermaid_classifier_tpu_torch.metrics import REPORT_ORDER
    from mermaid_classifier_tpu_torch.scripts import classifier_train
    from mermaid_classifier_tpu_torch.tracking import LocalTracker
    from mermaid_classifier_tpu_torch.utils import logging_config

    rng = np.random.default_rng(6)
    roots = [{"id": f"root{r}", "name": f"Root {r}", "parent": None} for r in range(2)]
    genera = [{"id": f"ba{i}", "name": f"Genus {i}", "parent": f"root{i % 2}"}
              for i in range(6)]
    fixture = tmp_path / "taxonomy"
    fixture.mkdir()
    (fixture / "benthic_attributes.json").write_text(json.dumps(roots + genera))
    (fixture / "growth_forms.json").write_text("{}")
    (fixture / "label_mappings.json").write_text("[]")
    _recipe_store(tmp_path, rng, [g["id"] for g in genera], 64)

    def read_npz(path):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k].tolist() for k in z.files}

    monkeypatch.setattr(relational, "read_parquet_columns", read_npz)
    monkeypatch.setattr(logging_config, "logging_config_for_script",
                        lambda *a, **k: Path("/dev/null"))
    config_dir = tmp_path / "config"
    config_dir.mkdir()
    env_block = {
        "OBJECT_STORE_ROOT": tmp_path / "store", "MERMAID_TRAIN_DATA_BUCKET": "b",
        "MERMAID_ANNOTATIONS_PARQUET_PATTERN": tmp_path / "mermaid.npz",
        taxonomy.TAXONOMY_FIXTURE_ENV: fixture, "FEATURE_CACHE_DIR": tmp_path / "cache",
        "TRACKING_DIR": tmp_path / "tracking", "BATCH_SIZE": "500"}
    (config_dir / "training_config.yaml").write_text(
        "training: {epochs: 3, early_stopping_patience: 2, device_resident: true,"
        " resident_dtype: bfloat16, calibration_backend: device}\n"
        "tracking: {experiment_name: cli, model_name: card-cli}\n"
        "env:\n" + "".join(f"  {k}: '{v}'\n" for k, v in env_block.items()))
    saved_env = dict(os.environ)
    saved = {n: getattr(tset.settings, n) for n in tset.Settings.field_names()}
    try:
        taxonomy.get_benthic_attribute_library.cache_clear()
        taxonomy.get_growth_form_library.cache_clear()
        assert classifier_train.main(["--config-dir", str(config_dir),
                                      "--device", str(cuda)]) == 0
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
        for name, value in saved.items():
            setattr(tset.settings, name, value)
        taxonomy.get_benthic_attribute_library.cache_clear()
        taxonomy.get_growth_form_library.cache_clear()
    tracker = LocalTracker(tmp_path / "tracking")
    run = tracker.runs("cli")[-1]
    seconds = json.loads(run.artifact("metrics_group_seconds.json").read_text())
    assert list(seconds) == list(REPORT_ORDER)
    metrics = run.latest_metrics()
    assert metrics["export_parity_max_abs_diff"] <= 1e-6
    assert run.params()["artifact_eval_inputs"] == "resident(bfloat16)"
    named = run.params().get("figures_not_written")
    pngs = [p for p in run.list_artifacts() if p.endswith(".png")]
    assert (named is None) == bool(pngs)
    assert "confusion_matrix/frequencies.png" in (pngs or named.split(", "))
    assert tracker.latest_model_version("card-cli").name == "v1"


# --- the release flow on the card ----------------------------------------------


def _card_artifact(cuda, out_dir, dim, k=6, seed=8):
    """A small head trained on the card, exported through the 1e-6 gate
    with the torch pin enforced."""
    from mermaid_classifier_tpu_torch.inference import export_artifact
    from mermaid_classifier_tpu_torch.train.calibration import CalibratedClassifier
    from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier

    X, y = _train_data(600, dim, k, seed=seed)
    clf = MLPClassifier((32,), random_state=0, learning_rate_init=1e-3, device=cuda)
    for _ in range(2):
        clf.partial_fit(X, y, classes=np.unique(y))
    model = CalibratedClassifier.fit_from_scores(
        clf, clf.predict_proba(X[:300]), y[:300], backend="device", device=cuda)
    export_artifact(model, out_dir, X[300:364])
    return out_dir


def test_validate_artifact_on_cuda(cuda, tmp_path):
    """``validate_artifact`` loads the artifact on the card; the release
    publishes once, refuses the same version, and a tampered manifest is
    refused before any write."""
    import json
    import shutil

    from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
    from mermaid_classifier_tpu_torch.serve.release import (
        ReleaseError,
        release_artifact,
        validate_artifact,
    )

    artifact = _card_artifact(cuda, tmp_path / "artifact", 64)
    manifest = validate_artifact(artifact, device=cuda)
    assert len(manifest["classes"]) == 6
    store = LocalFSObjectStore(tmp_path / "store")
    assert sorted(release_artifact(store, "rel", "v1", artifact, device=cuda)) == [
        "classifier/v1/model.json", "classifier/v1/model.npz"]
    with pytest.raises(ReleaseError, match="immutable"):
        release_artifact(store, "rel", "v1", artifact, device=cuda)
    bad = tmp_path / "bad"
    shutil.copytree(artifact, bad)
    data = json.loads((bad / "model.json").read_text())
    data["input_dim"] = 65
    (bad / "model.json").write_text(json.dumps(data))
    with pytest.raises(ReleaseError, match="load validation"):
        release_artifact(store, "rel", "v2", bad, device=cuda)
    assert sorted(store.list_keys("rel")) == [
        "classifier/v1/model.json", "classifier/v1/model.npz"]


def test_store_release_request_launches_on_cuda(cuda, tmp_path, monkeypatch):
    """A release published to an S3 bucket (the fake endpoint) serves a
    ``store://`` request on the card through 1 crop and 11 fused launches
    per 25-point request at B0 224, at the probabilities of the same
    artifact served from ``models:/``."""
    from mermaid_classifier_tpu_torch.config.settings import override_settings
    from mermaid_classifier_tpu_torch.data.store import get_default_store
    from mermaid_classifier_tpu_torch.serve.annotation import AnnotationRun
    from mermaid_classifier_tpu_torch.serve.release import release_artifact
    from mermaid_classifier_tpu_torch.tracking import LocalTracker
    from tests.data.fake_s3_server import make_server

    config = CONFIGS["b0_224"]
    artifact = _card_artifact(cuda, tmp_path / "artifact", config.feature_dim)
    tracker = LocalTracker(tmp_path / "tracking")
    tracker.register_model("card-release", [artifact / "model.npz",
                                            artifact / "model.json"])
    server, state, endpoint = make_server()
    try:
        for name, value in (("OBJECT_STORE_ENDPOINT", endpoint),
                            ("AWS_ACCESS_KEY_ID", "AK"), ("AWS_SECRET_ACCESS_KEY", "SK"),
                            ("NO_PROXY", "127.0.0.1,localhost")):
            monkeypatch.setenv(name, value)
        with override_settings(object_store_root="s3://"):
            release_artifact(get_default_store(), "releases", "v1", artifact,
                             device=cuda)
            assert sorted(k for (b, k) in state.objects if b == "releases") == [
                "classifier/v1/model.json", "classifier/v1/model.npz"]
            extractor = build_extractor(
                _perturbed_variables(config, np.random.default_rng(9)), config,
                device=cuda)
            rng = np.random.default_rng(10)
            image = rng.integers(0, 256, (1536, 2048, 3), dtype=np.uint8)
            points = tmp_path / "points.csv"
            points.write_text("row,col\n" + "".join(
                f"{r},{c}\n" for r, c in zip(rng.integers(0, 1536, 25),
                                             rng.integers(0, 2048, 25))))
            runs = []
            for spec in ("store://releases/classifier/v1", "models:/card-release"):
                ann = AnnotationRun(image, points, spec, extractor=extractor,
                                    tracker_root=tracker.root)
                patch_crop.launches = 0
                fm.launches = 0
                ann.run()
                torch.cuda.synchronize()
                runs.append((ann.proba, patch_crop.launches, fm.launches))
    finally:
        server.shutdown()
    (p0, c0, f0), (p1, c1, f1) = runs
    assert (c0, f0) == (c1, f1) == (1, 11)
    assert np.abs(p0 - p1).max() <= 2e-6


@pytest.mark.parametrize("ckpt", ["self_test", "lukemelas"])
def test_diff_backbone_on_cuda(cuda, tmp_path, ckpt):
    """The port's diff_backbone with both sides on the card (f32, TF32
    off): all green on the canonical self-test and on a pyspacer-lineage
    checkpoint, every layer under 5e-4 and the features' MAE under 1e-4."""
    import json

    from mermaid_classifier_tpu_torch.scripts import diff_backbone
    from tests.parity.foreign_checkpoints import (
        build_lukemelas_b0,
        save_pyspacer_efficientnet_pt,
    )

    args = ["--device", "cuda", "--probe-batch", "4",
            "--record", str(tmp_path / "r.json")]
    if ckpt == "self_test":
        args.append("--self-test")
    else:
        save_pyspacer_efficientnet_pt(build_lukemelas_b0(seed=2),
                                      tmp_path / "efficientnet.pt")
        args += [str(tmp_path / "efficientnet.pt"), "--save-npz",
                 str(tmp_path / "b.npz")]
    assert diff_backbone.main(args) == 0
    record = json.loads((tmp_path / "r.json").read_text())
    assert record["all_green"] and record["n_layers_compared"] == 212
    assert record["worst_layer_max_abs"] <= 5e-4 and record["feature_mae"] < 1e-4
    assert record["padding"] == ("tf_same" if ckpt == "lukemelas" else "symmetric")


def _packed_task(tmp_path):
    from mermaid_classifier_tpu_torch.data.features_io import write_feature_file
    from mermaid_classifier_tpu_torch.data.labels import ImageLabels, preprocess_labels

    X, y = _train_data(3000, 256, 8, seed=11)
    labels = ImageLabels()
    rowcols = np.stack([np.arange(20) * 3, np.arange(20) * 7], 1).astype(np.int32)
    for i in range(150):
        path = tmp_path / f"img_{i:03d}.features.npz"
        if not path.exists():
            write_feature_file(str(path), rowcols, X[i * 20:(i + 1) * 20])
        labels.add_image(str(path), [(int(r), int(c), str(lab)) for (r, c), lab in
                                     zip(rowcols[::-1], y[i * 20:(i + 1) * 20][::-1])])
    return preprocess_labels(labels, split_ratios=(0.15, 0.15))


def test_packed_streamed_equals_unpacked_on_cuda(cuda, tmp_path):
    """A streamed MermaidTrainer run on the card with ``packed_cache_dir``
    and without it: the native gather is in use, and the loss curve and
    every weight are the same bit for bit."""
    from mermaid_classifier_tpu_torch.native.fastbatch import native_available
    from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier
    from mermaid_classifier_tpu_torch.train.trainer import MermaidTrainer

    assert native_available()

    class Small(MermaidTrainer):
        def _make_classifier(self, class_weight):
            return MLPClassifier((64,), learning_rate_init=1e-3, random_state=0,
                                 class_weight=class_weight, device=cuda)

    out = []
    for packed in (False, True):
        task = _packed_task(tmp_path)
        trainer = Small(batch_size=500, device=cuda,
                        packed_cache_dir=str(tmp_path / "cache") if packed else None)
        out.append(trainer(task, nbr_epochs=3, pc_models=[]))
        assert (task.train.packed_cache is not None) == packed
        if packed:
            assert task.train.packed_cache.use_native
    (ca, va, ma), (cb, vb, mb) = out
    assert ca.estimator.loss_curve_ == cb.estimator.loss_curve_
    assert _same_weights(ca.estimator, cb.estimator)
    assert ma.ref_accs == mb.ref_accs and va.scores == vb.scores


def test_quality_repo_pipeline_on_cuda_within_bands_of_cpu(cuda):
    """The composed chain (train, calibrate, export, load, score) at the CI
    spec on the card and on the CPU: the card's numbers within the JAX
    test's bands of the CPU's (accuracy 0.02, balanced accuracy 0.04, log
    loss 0.10) and its log loss under 0.7 x uniform."""
    from mermaid_classifier_tpu_torch.train import quality_parity as qp

    spec = qp.QualityRunSpec()
    X, y = qp.make_imbalanced_clusters(spec)
    train, ref, val = qp.split_stratified(X, y, spec)
    sub = qp.subsample_train(train, spec)
    card = qp.run_repo_pipeline(sub, ref, val, spec, device="cuda")
    cpu = qp.run_repo_pipeline(sub, ref, val, spec, device="cpu")
    assert abs(card.accuracy - cpu.accuracy) <= 0.02
    assert abs(card.balanced_accuracy - cpu.balanced_accuracy) <= 0.04
    assert abs(card.log_loss - cpu.log_loss) <= 0.10
    assert card.log_loss < 0.7 * float(np.log(spec.n_classes))


# --- the job layer on the card -------------------------------------------------

# The second stage's second block is stride 1 with an expansion: fusable.
JOBS_TINY = {
    "stem_channels": 8, "stages": [[1, 8, 1, 1, 3], [6, 16, 2, 2, 3]],
    "head_channels": 16, "se_ratio": 0.25, "feature_dim": 16, "patch_size": 32,
}


def _port_env(repo):
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(repo), env.get("PYTHONPATH")) if p)
    return env


def test_fanout_workers_on_cuda_equal_an_in_process_run(cuda, tmp_path):
    """Two ``LocalProcessBackend`` workers share the card, each running the
    port's bucket CLI as a file (tiny backbone, ``fused``, default
    ``--device cuda``); every feature file equals the in-process CLI run's
    bit for bit, and that run launched the crop and fused kernels."""
    import io
    import json
    from pathlib import Path

    from mermaid_classifier_tpu_torch.config import settings as tset
    from mermaid_classifier_tpu_torch.data.feature_bucket import annotations_key
    from mermaid_classifier_tpu_torch.data.features_io import read_feature_file
    from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
    from mermaid_classifier_tpu_torch.jobs import (
        JobStatus,
        LocalProcessBackend,
        launch_processing,
        parse_run_config,
        wait_for_completion,
    )
    from mermaid_classifier_tpu_torch.scripts import build_feature_bucket

    repo = Path(__file__).resolve().parents[1]
    root = tmp_path / "store"
    store = LocalFSObjectStore(root)
    rng = np.random.default_rng(9)
    for source in ("1", "2", "3"):
        lines = ["image_id,image_key,row,col"]
        for image_id, n in (("a", 5), ("b", 40)):
            image = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
            key = f"s{source}/{image_id}.npy"
            store.put_bytes("src", key, _npy_bytes(image))
            pts = np.stack([rng.integers(0, 90, n), rng.integers(0, 120, n)], 1)
            lines += [f"{image_id},{key},{r},{c}" for r, c in pts]
        store.put_bytes("src", annotations_key(source), "\n".join(lines).encode())
    (tmp_path / "tiny.json").write_text(json.dumps(JOBS_TINY))
    (tmp_path / "sources.csv").write_text("source_id\n1\n2\n3\n")
    entry = repo / "mermaid_classifier_tpu_torch" / "scripts" / "build_feature_bucket.py"
    common = ["--source-bucket", "src", "--backbone-config-json",
              str(tmp_path / "tiny.json")]
    (tmp_path / "run.yaml").write_text(
        f"job:\n  entrypoint: {entry}\n  env: {{OBJECT_STORE_ROOT: '{root}'}}\n"
        f"processing:\n  container_args: {json.dumps([*common, '--target-bucket', 'fan'])}\n"
        "  shard: {items_csv: sources.csv, workers: 2}\n")
    backend = LocalProcessBackend(log_dir=tmp_path / "logs")
    job_ids = launch_processing(parse_run_config(tmp_path / "run.yaml"), backend, "card")
    try:
        statuses = wait_for_completion(backend, job_ids, poll_seconds=0.2,
                                       timeout_seconds=600)
    finally:
        backend.terminate_all()
    assert set(statuses.values()) == {JobStatus.COMPLETED}, [
        (tmp_path / "logs" / f"{j}.log").read_text()[-2000:] for j in job_ids]

    saved = tset.settings.object_store_root
    tset.settings.object_store_root = str(root)
    try:
        before = (patch_crop.launches, fm.launches)
        assert build_feature_bucket.main(
            [*common, "--target-bucket", "one", "--source-ids", "1,2,3"]) == 0
        torch.cuda.synchronize()
        # Six images of one chunk each: one crop and one fused block apiece.
        assert (patch_crop.launches - before[0], fm.launches - before[1]) == (6, 6)
    finally:
        tset.settings.object_store_root = saved
    keys = sorted(k for k in store.list_keys("one") if k.endswith(".features.npz"))
    assert len(keys) == 6
    assert sorted(k for k in store.list_keys("fan") if k.endswith(".features.npz")) == keys
    for key in keys:
        (rc_a, f_a), (rc_b, f_b) = (read_feature_file(io.BytesIO(
            store.get_bytes(bucket, key))) for bucket in ("fan", "one"))
        assert f_a.dtype == f_b.dtype == np.float32
        assert rc_a.tobytes() == rc_b.tobytes() and f_a.tobytes() == f_b.tobytes()


def test_e2e_tiny_on_cuda(cuda, tmp_path):
    """The port's one-command drive on the card at its tiny backbone: two
    workers share the card, and classifier_train, the reload and
    predict_features run with ``--device cuda`` and the torch pin."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "mermaid_classifier_tpu_torch.scripts.e2e_smoke",
         "--workdir", str(tmp_path), "--images-per-source", "2", "--device", "cuda"],
        cwd=repo, env=_port_env(repo), capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "[e2e] PASS in " in proc.stdout and "stage budget:" in proc.stdout
    assert (tmp_path / "tracking" / "_models" / "mermaid-mlp-example" / "v1"
            / "model.npz").is_file()
