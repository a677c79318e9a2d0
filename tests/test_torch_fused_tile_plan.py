"""The fused-MBConv kernel's pass-1 tile plan over every compound-scaled
EfficientNet, and the fused route on B4's widths against the benchmark's
plain reference. CPU only: the plan is Python arithmetic on the kernel's
shared-memory formula (the card tests hold it to the kernel's own), and
on the CPU the fused wrapper runs its plain version."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mermaid_classifier_tpu_torch.models.efficientnet import (
    EfficientNetConfig,
    init_backbone_params,
    variant_config,
)
from mermaid_classifier_tpu_torch.ops import fused_mbconv as fm

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7")
# Fusable blocks whose rows of all Cin channels overflow the budget at one
# row, in f32 and in bf16: the sliced tile takes them.
SLICED = {"b0": (0, 0), "b1": (0, 0), "b2": (0, 0), "b3": (1, 0),
          "b4": (13, 13), "b5": (17, 17), "b6": (21, 21), "b7": (35, 35)}


def _whole_rows(meta, bf16):
    """The plan before the sliced tile existed: the most rows (up to 16)
    whose whole-Cin layout fits the budget, or None."""
    for rows in range(min(meta.h, 16), 0, -1):
        if 4 * fm._pass1_smem_floats(rows, meta.w, meta.in_channels,
                                     meta.kernel, bf16) <= fm._PASS1_SMEM_BUDGET:
            return rows
    return None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", VARIANTS)
def test_every_fusable_block_gets_a_tile(variant, dtype):
    """Every block the route takes gets a plan inside the budget; the
    whole-Cin tile wherever one fits, exactly as before the sliced tile;
    the sliced tile only where none fits, within its staged positions."""
    bf16 = dtype == torch.bfloat16
    sliced = 0
    for meta in fm.block_metas(variant_config(variant)):
        if not fm.fusable(meta):
            continue
        plan = fm.tile_plan(meta, dtype)
        assert 1 <= plan.rows <= min(meta.h, 16)
        assert 4 * fm._pass1_smem_floats(plan.rows, meta.w, meta.in_channels,
                                         meta.kernel, bf16, plan.sliced) \
            <= fm._PASS1_SMEM_BUDGET
        whole = _whole_rows(meta, bf16)
        if whole is not None:
            assert plan == fm.TilePlan(whole, False), meta
        else:
            assert plan.sliced, meta
            assert (plan.rows + meta.kernel - 1) * meta.w <= fm._SLICED_POSITIONS
            # One row more would not fit, unless the tile is 16 rows or the map.
            if plan.rows < min(meta.h, 16):
                assert not fm._tile_fits(plan.rows + 1, meta, bf16, True)
            sliced += 1
    assert sliced == SLICED[variant][int(bf16)]


def test_sliced_layout_is_independent_of_cin():
    """The sliced tile's ring holds kStages slices of kKC input channels, so
    its shared memory is the same at any Cin, and below the whole tile's
    from Cin 72 on (two 32-channel slices and their weights)."""
    for cin in (33, 72, 160, 448, 640):
        for bf16 in (False, True):
            sliced = fm._pass1_smem_floats(4, 24, cin, 5, bf16, True)
            assert sliced == fm._pass1_smem_floats(4, 24, fm._KKC, 5, bf16, True)
            if cin >= 72:
                assert sliced < fm._pass1_smem_floats(4, 24, cin, 5, bf16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_tile_takes_k3_and_k5_only(dtype):
    """The kernel builds its sliced pass 1 for EfficientNet's k 3 and 5
    alone: a k-7 block that no whole tile fits gets no plan, where the same
    block at k 5 takes the sliced tile."""
    k5 = fm.BlockMeta(448, 2688, 448, 5, 1, True, True, 12, 12)
    k7 = fm.BlockMeta(448, 2688, 448, 7, 1, True, True, 12, 12)
    assert fm.tile_plan(k5, dtype).sliced
    assert not any(fm._tile_fits(r, k7, dtype == torch.bfloat16, True)
                   for r in range(1, 13))
    with pytest.raises(ValueError, match="does not fit"):
        fm.tile_plan(k7, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_tile_takes_whole_16_byte_vectors_of_cin(dtype):
    """The ring copies 16-byte vectors of the input (8 bf16 or 4 f32
    channels): the sliced tile is offered only where Cin is a multiple of
    the vector, and a block whose Cin is not, and that no whole tile fits,
    gets no plan."""
    bf16 = dtype == torch.bfloat16
    vec = 8 if bf16 else 4
    for cin in range(440, 457):
        meta = fm.BlockMeta(cin, 6 * cin, 448, 3, 1, True, False, 12, 12)
        fits = any(fm._tile_fits(r, meta, bf16, True) for r in range(1, 13))
        assert fits == (cin % vec == 0), cin
        if cin % vec:
            with pytest.raises(ValueError, match="does not fit"):
                fm.tile_plan(meta, dtype)
        else:
            assert fm.tile_plan(meta, dtype).sliced


def test_cpu_tensors_count_no_sliced_launch():
    """A CPU tensor takes the plain version: neither counter moves, even for
    a block whose plan is the sliced tile."""
    config = variant_config("b4")
    meta = next(m for m in fm.block_metas(config)
                if fm.fusable(m) and fm.tile_plan(m, torch.float32).sliced)
    folded = fm.to_device(fm.fold_backbone(
        init_backbone_params(3, config), config), "cpu")
    blk = next(b for b in folded["blocks"] if b["meta"] == meta)
    before = (fm.launches, fm.sliced_launches)
    out = fm.fused_mbconv(torch.zeros((1, meta.h, meta.w, meta.in_channels)), blk)
    assert out.shape == (1, meta.h, meta.w, meta.out_channels)
    assert (fm.launches, fm.sliced_launches) == before


def _b4_backbone(patch_size):
    """The benchmark's B4 configuration at f32 and a CPU test's patch size:
    B4's widths, depth and kernels, a smaller map."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "effnet_b4_380.json").read_text())
    return {**cfg["backbone"], "patch_size": patch_size, "compute_dtype": "float32"}, cfg


def test_b4_fused_route_matches_the_plain_reference():
    """The port's fused-route trunk on B4's stage layout (32 blocks; at
    96 px the route takes all 26 stride-1 expanding ones, 23 at 380), 2
    patches, the benchmark's seeded and calibrated weights, against
    ``benchmark/reference/efficientnet.py`` at f32: the feature gap the
    benchmark's own tiny-config test holds (1e-5), as both sides compute in
    f32 and differ by sum order only. 96 px, not less: at 64 px the last
    stages' 2x2 maps give the calibration too few values per channel, the
    features read in the thousands, and every route of the port, the
    module too, reads 1e-2 from the reference."""
    from benchmark import compare, weights
    from benchmark.corpus import smooth_field
    from benchmark.reference import efficientnet as ref_en
    from mermaid_classifier_tpu_torch.models.extractor import FeatureExtractor

    ps = 96
    bb, cfg = _b4_backbone(ps)
    variables = weights.backbone_variables(bb, cfg["init"], 11, "cpu")
    rng = np.random.default_rng(4)
    image = smooth_field(rng, 2 * ps, 2 * ps)
    rowcols = np.array([[10, 20], [ps, ps + 10]], np.int32)
    want = ref_en.EfficientNet(variables, bb, "cpu").features(
        ref_en.crop(image, rowcols, ps, bb["mean_rgb"], bb["std_rgb"])).numpy()
    config = EfficientNetConfig.from_dict(bb)
    assert sum(map(fm.fusable, fm.block_metas(config))) == 26
    ex = FeatureExtractor(variables, config, device="cpu", backbone_impl="fused")
    got = ex.extract_features(image, rowcols)
    assert np.isfinite(got).all() and got.shape == (2, 4096)
    assert compare.feature_gap([got], [want]) < 1e-5
