"""The benchmark's work counts (``benchmark/costs.py``)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import costs

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def backbone(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())["backbone"]


@pytest.mark.parametrize("name, gflop", [("effnet_b0_224", 0.7796), ("effnet_b2_260", 1.9958)])
def test_trunk_flops_per_patch(name, gflop):
    from mermaid_classifier_tpu_torch.bench import trunk_cost
    from mermaid_classifier_tpu_torch.models.efficientnet import EfficientNetConfig

    bb = backbone(name)
    flops = costs.trunk_flops_per_patch(bb)
    assert round(flops / 1e9, 4) == gflop
    # The port bench's geometry walk counts the same trunk.
    assert flops == trunk_cost(EfficientNetConfig.from_dict(bb))[1]


@pytest.mark.parametrize("name, variant", [("effnet_b0_224", "b0"), ("effnet_b2_260", "b2")])
def test_config_files_are_the_published_variants(name, variant):
    from mermaid_classifier_tpu_torch.models.efficientnet import variant_config

    assert backbone(name) == variant_config(variant, compute_dtype="bfloat16").to_dict()


@pytest.mark.parametrize("name, fused", [("effnet_b0_224", 11), ("effnet_b2_260", 15)])
def test_fused_blocks_match_the_routes_rule(name, fused):
    from mermaid_classifier_tpu_torch.models.efficientnet import EfficientNetConfig
    from mermaid_classifier_tpu_torch.ops.fused_mbconv import block_metas, fusable

    bb = backbone(name)
    ours = costs.blocks(bb)
    metas = block_metas(EfficientNetConfig.from_dict(bb))
    assert sum(b.fusable for b in ours) == fused
    assert [b.fusable for b in ours] == [fusable(m) for m in metas]
    assert [(b.in_channels, b.mid_channels, b.out_channels, b.h) for b in ours] == \
        [(m.in_channels, m.mid_channels, m.out_channels, m.h) for m in metas]


def _block_shapes(impl: str, bb: dict) -> list:
    """(input shape, output shape) of every stride-1 expanding block as the
    ``impl`` route runs it on the CPU."""
    from mermaid_classifier_tpu_torch.models import efficientnet as en
    from mermaid_classifier_tpu_torch.models.extractor import FeatureExtractor
    from mermaid_classifier_tpu_torch.ops import fused_mbconv as fm

    config = en.EfficientNetConfig.from_dict(bb)
    variables = en.init_backbone_params(0, config)
    seen = []
    mp = pytest.MonkeyPatch()

    def record(fn):
        def wrapped(x, *args, **kwargs):
            y = fn(x, *args, **kwargs)
            seen.append((tuple(x.shape), tuple(y.shape)))
            return y
        return wrapped

    if impl == "fused":
        mp.setattr(fm, "fused_mbconv", record(fm.fused_mbconv))
    elif impl == "folded":
        mp.setattr(fm, "_block_plain", record(fm._block_plain))
    else:
        def forward(self, x, _orig=en.MBConv.forward):
            y = _orig(self, x)
            seen.append((tuple(x.permute(0, 2, 3, 1).shape), tuple(y.permute(0, 2, 3, 1).shape)))
            return y
        mp.setattr(en.MBConv, "forward", forward)
    try:
        ex = FeatureExtractor(variables, config, device="cpu", backbone_impl=impl)
        ps = bb["patch_size"]
        ex.features_for_patches(torch.zeros((3, ps, ps, 3)))
    finally:
        mp.undo()
    return seen


def test_fused_block_count_is_the_same_under_every_route():
    bb = dict(backbone("effnet_b0_224"), patch_size=64, compute_dtype="float32")
    fusable = [b for b in costs.blocks(bb) if b.fusable]
    counts = {}
    for impl in ("fused", "folded", "module"):
        shapes = _block_shapes(impl, bb)
        if impl != "fused":  # the other routes run every block: keep the fusable ones
            shapes = [s for s, b in zip(shapes, costs.blocks(bb)) if b.fusable]
        assert len(shapes) == len(fusable)
        work = []
        for (x_shape, y_shape), blk in zip(shapes, fusable):
            n, h, _w, cin = x_shape
            assert (h, cin, y_shape[-1]) == (blk.h, blk.in_channels, blk.out_channels)
            work.append(costs.fused_block_work(n, blk, "bfloat16"))
        counts[impl] = work
    assert counts["fused"] == counts["folded"] == counts["module"]


def test_crop_covers_pixels_once_and_caps_at_the_image():
    rng = np.random.default_rng(0)
    h, w, ps = 70, 90, 32
    rowcols = np.stack([rng.integers(0, h, 40), rng.integers(0, w, 40)], 1)
    mask = np.zeros((h, w), bool)
    for r, c in rowcols:
        mask[max(r - 16, 0):r + 16, max(c - 16, 0):c + 16] = True
    assert costs.covered_pixels(h, w, rowcols, ps) == mask.sum()
    work = costs.crop_work(h, w, rowcols, ps, "bfloat16")
    assert work.bytes == 3 * mask.sum() + 8 * 40 + 40 * ps * ps * 3 * 2
    assert work.bound_s() == work.bytes / costs.HBM_BYTES_PER_S


def test_train_flops_per_sample():
    assert costs.mlp_matmul_params([4096, 500, 300, 100, 80]) == 2_236_000
    assert costs.train_flops_per_sample([4096, 500, 300, 100, 80]) == 6 * 2_236_000
