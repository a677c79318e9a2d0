"""The B4 configuration (``configs/effnet_b4_380.json``) and the reader of
``fused_sliced_share_pct``."""

import json
from pathlib import Path

import pytest

from benchmark import costs
from benchmark.manifest import load_module

HERE = Path(__file__).resolve().parents[1]


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_backbone_is_the_published_b4():
    from mermaid_classifier_tpu_torch.models.efficientnet import variant_config

    assert config("effnet_b4_380")["backbone"] == \
        variant_config("b4", compute_dtype="bfloat16").to_dict()


def test_everything_but_the_backbone_is_b2s():
    b4, b2 = config("effnet_b4_380"), config("effnet_b2_260")
    for key in ("extractor", "builder", "head", "init", "assumed"):
        assert b4[key] == b2[key], key


def test_the_sliced_blocks_carry_most_of_the_fused_route():
    """8.80 GFLOP per patch; the 13 blocks whose whole-Cin tile overflows
    (Cin 160 to 448) are 4.49 of the fused route's 6.60 GFLOP."""
    import torch

    from mermaid_classifier_tpu_torch.models.efficientnet import EfficientNetConfig
    from mermaid_classifier_tpu_torch.ops import fused_mbconv as fm

    bb = config("effnet_b4_380")["backbone"]
    assert round(costs.trunk_flops_per_patch(bb) / 1e9, 2) == 8.80
    metas = [m for m in fm.block_metas(EfficientNetConfig.from_dict(bb)) if fm.fusable(m)]
    fused = [b for b in costs.blocks(bb) if b.fusable]
    assert len(fused) == len(metas) == 23

    def gflop(blocks):
        return sum(w.tc_flops + w.other_flops
                   for w in (costs.fused_block_work(1, b, "bfloat16") for b in blocks)) / 1e9

    sliced = [b for b, m in zip(fused, metas) if fm.tile_plan(m, torch.bfloat16).sliced]
    assert len(sliced) == 13
    assert round(gflop(sliced), 2) == 4.49 and round(gflop(fused), 2) == 6.60


def _reader():
    return load_module(HERE / "metrics" / "fused_sliced_share_pct.py", "fused_sliced_share_pct")


NS = "void (anonymous namespace)::"


@pytest.mark.parametrize("flag", ["true", "(bool)1"])
def test_share_reads_the_sliced_instance(flag):
    kernels = [(f"{NS}expand_dw_kernel<__nv_bfloat16, 5, {flag}>(__nv_bfloat16 const*, int)", 3.0),
               (f"{NS}expand_dw_kernel<__nv_bfloat16, 3, false>(__nv_bfloat16 const*, int)", 1.0),
               (f"{NS}se_kernel(float const*, int)", 0.5),
               (f"void {NS[5:]}project_kernel<__nv_bfloat16>(__nv_bfloat16 const*)", 1.5),
               ("void at::native::elementwise_kernel<128, 4>(int)", 9.0)]
    assert _reader().read({"trace": {"kernels": kernels}}) == pytest.approx(50.0)


def test_share_reads_nothing_without_a_sliced_instance():
    kernels = [(f"{NS}expand_dw_kernel<__nv_bfloat16, 5, false>(int)", 1.0),
               (f"{NS}expand_dw_kernel<__nv_bfloat16, 5>(int)", 1.0),
               (f"{NS}se_kernel(float const*, int)", 0.5)]
    assert _reader().read({"trace": {"kernels": kernels}}) is None
    assert _reader().read({}) is None
