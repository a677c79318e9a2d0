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
