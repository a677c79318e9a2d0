"""Kernel-against-plain tests that need a CUDA card (and nvcc to build the
kernels). They skip where there is none; ``python3 chip_smoke.py`` runs the
same comparisons, at the serve path's full shapes, on the card. This file
imports no jax, so it runs on a card machine without jax, skipping the
repo's jax-pinning conftest:
``python -m pytest --noconftest tests/test_torch_cuda.py -m requires_cuda``."""

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
# widths that are not multiples of the kernel's 32-channel tile (72, 120).
CONFIGS = {
    "b0_224": EfficientNetConfig(),
    "b0_60px": EfficientNetConfig(patch_size=60, feature_dim=128),
    "narrow_36px": EfficientNetConfig(
        stem_channels=8, stages=((1, 8, 1, 1, 3), (6, 12, 2, 2, 3),
                                 (6, 20, 2, 2, 5)),
        head_channels=32, feature_dim=48, patch_size=36),
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


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5),
                                         (torch.bfloat16, 0.05)])
def test_fused_kernel_matches_plain(cuda, name, dtype, bound):
    config = CONFIGS[name]
    rng = np.random.default_rng(1)
    folded = fm.to_device(
        fm.fold_backbone(_perturbed_variables(config, rng), config), cuda)
    checked = 0
    for blk in folded["blocks"]:
        meta = blk["meta"]
        if not fm.fusable(meta):
            continue
        x = torch.from_numpy(rng.standard_normal(
            (9, meta.h, meta.w, meta.in_channels)).astype(np.float32)).to(cuda, dtype)
        got = fm.fused_mbconv(x, blk)
        with fm.full_f32():
            want = fm.fused_mbconv_reference(x, blk)
        rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        assert rel <= bound, (meta, rel)
        checked += 1
    assert checked


@pytest.mark.parametrize("name", ["b0_60px", "narrow_36px"])
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
