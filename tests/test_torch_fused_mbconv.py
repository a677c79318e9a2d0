"""The port's BN folding, folded trunk and fused-MBConv block against the
JAX package's (Pallas in interpret mode, as its own tests run it), on the
64-px full-B0-topology config and the odd 60-px geometry of
tests/ops/test_fused_mbconv.py. Bounds are that file's: rel 1e-5 at f32,
rel 0.05 per block at bf16. On the CPU the port's fused wrapper runs its
plain version."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mermaid_classifier_tpu.models.efficientnet import EfficientNetConfig
from mermaid_classifier_tpu.ops import fused_mbconv as jfm
from mermaid_classifier_tpu_torch.ops import fused_mbconv as tfm
from tests.test_torch_efficientnet import (
    jax_variables_numpy,
    perturbed,
    port_config,
)

CONFIG = EfficientNetConfig(compute_dtype="float32", patch_size=64, feature_dim=128)
ODD = replace(CONFIG, patch_size=60)  # 60 -> 30 -> 15 -> 8 -> 4 -> 2


def _bundle(config):
    variables = perturbed(jax_variables_numpy(config), seed=5)
    jf = jfm.fold_backbone(variables, config)
    tf = tfm.fold_backbone(variables, port_config(config))
    return jf, tf, tfm.to_device(tf, "cpu")


@pytest.fixture(scope="module")
def bundle():
    return _bundle(CONFIG)


@pytest.fixture(scope="module", params=[CONFIG, ODD], ids=["64px", "60px"])
def trunk_bundle(request):
    return request.param, _bundle(request.param)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _fusable_indices(config):
    return [i for i, m in enumerate(jfm.block_metas(config)) if jfm.fusable(m)]


class TestFold:
    def test_metas_and_routing_match_jax(self):
        for config in (CONFIG, ODD, EfficientNetConfig()):
            jm = jfm.block_metas(config)
            tm = tfm.block_metas(port_config(config))
            assert [vars(m) for m in tm] == [vars(m) for m in jm]
            assert [tfm.fusable(m) for m in tm] == [jfm.fusable(m) for m in jm]
        # At 224 px, 11 of B0's 16 blocks take the fused kernel.
        assert sum(tfm.fusable(m) for m in tfm.block_metas(
            port_config(EfficientNetConfig()))) == 11

    def test_fold_matches_jax(self, bundle):
        jf, tf, _ = bundle

        def leaves(folded):
            out = [*folded["stem"], *folded["head"], *folded["proj"]]
            for blk in folded["blocks"]:
                for key in ("expand", "depthwise", "se_reduce", "se_expand",
                            "project"):
                    if key in blk:
                        out.extend(blk[key])
            return out

        want, got = leaves(jf), leaves(tf)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)


class TestFoldedTrunk:
    @pytest.mark.parametrize("fused", [False, True])
    def test_matches_jax_fused_interpret(self, trunk_bundle, fused):
        config, (jf, _, dev) = trunk_bundle
        x = np.random.default_rng(1).standard_normal(
            (2, config.patch_size, config.patch_size, 3)).astype(np.float32)
        want = np.asarray(jfm.apply_folded(
            jf, config, jnp.asarray(x), fused=True, interpret=True))
        got = tfm.apply_folded(dev, port_config(config), torch.from_numpy(x),
                               fused=fused).numpy()
        assert got.shape == want.shape
        assert _rel(got, want) < 1e-5

    def test_prefix_suffix_split_equals_full(self, bundle):
        _, _, dev = bundle
        cfg = port_config(CONFIG)
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (2, 64, 64, 3)).astype(np.float32))
        full = tfm.apply_folded(dev, cfg, x, fused=True)
        for k in (0, 3, len(dev["blocks"])):
            got = tfm.apply_folded_suffix(
                dev, cfg, tfm.apply_folded_prefix(dev, cfg, x, k, fused=True),
                k, fused=True)
            torch.testing.assert_close(got, full, rtol=0, atol=0)


class TestFusedBlock:
    @pytest.mark.parametrize("index", _fusable_indices(CONFIG))
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_jax_kernel(self, bundle, index, dtype):
        jf, _, dev = bundle
        jblk, tblk = jf["blocks"][index], dev["blocks"][index]
        meta = jblk["meta"]
        x = np.random.default_rng(index).standard_normal(
            (3, meta.h, meta.w, meta.in_channels)).astype(np.float32)
        jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        tdt = torch.float32 if dtype == "float32" else torch.bfloat16
        want = np.asarray(jfm.fused_mbconv(jnp.asarray(x, jdt), jblk,
                                           interpret=True), np.float32)
        out = tfm.fused_mbconv(torch.from_numpy(x).to(tdt), tblk)
        assert out.dtype == tdt and out.shape == (3, meta.h, meta.w, meta.out_channels)
        bound = 1e-5 if dtype == "float32" else 0.05
        assert _rel(out.float().numpy(), want) < bound

    def test_plain_block_matches_jax_xla_block(self, bundle):
        """The unfused plain block (the fused=False path) against the JAX
        _block_xla, every block including stride 2."""
        jf, _, dev = bundle
        rng = np.random.default_rng(9)
        for jblk, tblk in zip(jf["blocks"], dev["blocks"]):
            meta = jblk["meta"]
            x = rng.standard_normal((2, meta.h, meta.w, meta.in_channels)).astype(np.float32)
            want = np.asarray(jfm._block_xla(jnp.asarray(x), jblk, jnp.float32))
            got = tfm._block_plain(torch.from_numpy(x), tblk, torch.float32).numpy()
            assert _rel(got, want) < 1e-5, meta

    def test_rejects_stride2(self, bundle):
        _, _, dev = bundle
        blk = next(b for b in dev["blocks"] if b["meta"].stride == 2)
        m = blk["meta"]
        with pytest.raises(ValueError, match="stride-1"):
            tfm.fused_mbconv(torch.zeros((1, m.h, m.w, m.in_channels)), blk)

    def test_rejects_block_without_expansion(self, bundle):
        _, _, dev = bundle
        blk = dev["blocks"][0]  # stage 0: stride 1, expand ratio 1
        m = blk["meta"]
        assert m.stride == 1 and not m.has_expand
        with pytest.raises(ValueError, match="with an expansion"):
            tfm.fused_mbconv(torch.zeros((1, m.h, m.w, m.in_channels)), blk)

    def test_rejects_shape_mismatch(self, bundle):
        _, _, dev = bundle
        blk = dev["blocks"][_fusable_indices(CONFIG)[0]]
        m = blk["meta"]
        with pytest.raises(ValueError, match="does not match block meta"):
            tfm.fused_mbconv(torch.zeros((1, m.h + 1, m.w, m.in_channels)), blk)

    def test_cpu_tensors_launch_no_kernel(self, bundle):
        _, _, dev = bundle
        before = tfm.launches
        blk = dev["blocks"][_fusable_indices(CONFIG)[0]]
        m = blk["meta"]
        tfm.fused_mbconv(torch.zeros((1, m.h, m.w, m.in_channels)), blk)
        assert tfm.launches == before

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_rows_per_tile_fits_shared_memory_at_224(self, dtype):
        """Every fusable B0 block at 224 px gets a tile of >= 5 rows inside
        the pass-1 shared-memory budget (the kernel's own formula, with the
        activation type's padded row strides)."""
        bf16 = dtype == torch.bfloat16
        checked = 0
        for meta in tfm.block_metas(port_config(EfficientNetConfig())):
            if tfm.fusable(meta):
                rows = tfm.rows_per_tile(meta, dtype)
                assert 5 <= rows <= meta.h
                smem = 4 * tfm._pass1_smem_floats(rows, meta.w, meta.in_channels,
                                                  meta.kernel, bf16)
                assert smem <= tfm._PASS1_SMEM_BUDGET
                # One row more would not fit, unless the tile is the map.
                if rows < min(meta.h, 16):
                    assert 4 * tfm._pass1_smem_floats(
                        rows + 1, meta.w, meta.in_channels, meta.kernel,
                        bf16) > tfm._PASS1_SMEM_BUDGET
                checked += 1
        assert checked == 11

    def test_smem_row_strides_avoid_bank_conflicts(self):
        """The staged input's row stride is >= Cin and is 8 mod 16 for bf16
        (pairs read by 4 rows x 4 lanes) and 4 mod 8 for f32 (singles read
        by 8 rows x 4 lanes)."""
        for cin in range(1, 300):
            a_bf16, a_f32 = tfm._a_stride(cin, True), tfm._a_stride(cin, False)
            assert a_bf16 >= cin and a_bf16 % 16 == 8 and a_bf16 - cin < 16
            assert a_f32 >= cin and a_f32 % 8 == 4 and a_f32 - cin < 8

    @pytest.mark.parametrize("case", ["rounded_weights_bitwise", "composition"])
    def test_bf16_plain_rounds_1x1_weights(self, bundle, case):
        """In bf16 the plain version feeds its 1x1 products the weights
        rounded to bf16, as the kernel's tensor-core operands are: its output
        is unchanged when those weights arrive pre-rounded, and it agrees
        with a hand-written composition (einsum 1x1s, grouped conv2d
        depthwise) that rounds them. In f32 nothing is rounded."""
        _, _, dev = bundle
        index = _fusable_indices(CONFIG)[1]
        blk = dev["blocks"][index]
        meta = blk["meta"]
        x = torch.from_numpy(np.random.default_rng(11).standard_normal(
            (2, meta.h, meta.w, meta.in_channels)).astype(np.float32))
        rounded = dict(blk)
        for key in ("expand", "project"):
            w, b = blk[key]
            rounded[key] = (w.to(torch.bfloat16).float(), b)
        xb = x.to(torch.bfloat16)
        got = tfm.fused_mbconv_reference(xb, blk)
        if case == "rounded_weights_bitwise":
            assert torch.equal(got, tfm.fused_mbconv_reference(xb, rounded))
            assert not torch.equal(tfm.fused_mbconv_reference(x, blk),
                                   tfm.fused_mbconv_reference(x, rounded))
            return
        wexp = rounded["expand"][0][0, 0]
        wproj = rounded["project"][0][0, 0]
        bexp, (wdw, bdw) = blk["expand"][1], blk["depthwise"]
        (w1, b1), (w2, b2) = blk["se_reduce"], blk["se_expand"]
        k = meta.kernel
        z = F.silu(torch.einsum("nhwc,cm->nhwm", xb.float(), wexp) + bexp)
        z = z.to(torch.bfloat16).float().permute(0, 3, 1, 2)
        dconv = F.conv2d(z, wdw.permute(2, 0, 1).unsqueeze(1), bdw,
                         padding=(k - 1) // 2, groups=meta.mid_channels)
        d = F.silu(dconv).permute(0, 2, 3, 1)
        e = torch.sigmoid(F.silu(d.mean(dim=(1, 2)) @ w1 + b1) @ w2 + b2)
        m = (d * e[:, None, None, :]).to(torch.bfloat16).float()
        want = torch.einsum("nhwm,mo->nhwo", m, wproj) + blk["project"][1]
        if meta.residual:
            want = want + xb.float()
        diff = (got.float() - want.to(torch.bfloat16).float()).abs().max()
        # Sums in another order may move a bf16 rounding by one ulp.
        assert float(diff) <= 2.0 ** -7 * float(want.abs().max())
