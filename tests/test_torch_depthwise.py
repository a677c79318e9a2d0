"""The port's depthwise conv (its wrapper on CPU tensors, which runs the
kernel's plain version) against the JAX package's Pallas kernel in
interpret mode, as tests/ops/test_depthwise.py runs it, on that file's
geometries and the same numpy inputs. Bounds: 2e-5 abs/rel at f32 (the
Pallas kernel's own bound), and one bf16 ulp of the JAX output at bf16: both
round an f32 accumulator once, and the two f32 sums may differ in their last
bits (XLA may contract a multiply-add). Where a sum cancels to far below its
terms, that f32 difference alone can exceed a bf16 ulp of the result, so
there the f32 bound's 2e-5 absolute is the floor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.ops.depthwise import depthwise_conv_pallas
from mermaid_classifier_tpu_torch.models.efficientnet import EfficientNetConfig
from mermaid_classifier_tpu_torch.ops import depthwise as dw
from mermaid_classifier_tpu_torch.ops import fused_mbconv as tfm
from tests.ops.test_depthwise import GEOMETRIES


def _inputs(h, c, k, n=4):
    rng = np.random.default_rng(h * c + k)
    x = rng.standard_normal((n, h, h, c)).astype(np.float32)
    w = (rng.standard_normal((k, k, c)) * 0.2).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    return x, w, b


def _bf16_ulp(v):
    """Spacing of bfloat16 values at magnitude |v| (8 significand bits)."""
    m = np.maximum(np.abs(v), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(m)) - 7)


@pytest.mark.parametrize("h,c,k", GEOMETRIES)
def test_f32_matches_pallas_interpret(h, c, k):
    x, w, b = _inputs(h, c, k)
    want = np.asarray(depthwise_conv_pallas(jnp.asarray(x), w, b, kernel=k,
                                            interpret=True))
    got = dw.depthwise_conv(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), kernel=k)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("h,c,k", GEOMETRIES)
def test_bf16_within_one_ulp_of_pallas_interpret(h, c, k):
    x, w, b = _inputs(h, c, k)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(depthwise_conv_pallas(
        jnp.asarray(xb, jnp.bfloat16), w, b, kernel=k, interpret=True,
    ).astype(jnp.float32))
    got = dw.depthwise_conv(torch.from_numpy(xb).to(torch.bfloat16),
                            torch.from_numpy(w), torch.from_numpy(b), kernel=k)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    diff = np.abs(got - want)
    assert (diff <= np.maximum(ulp, 2e-5)).all(), (diff / ulp).max()
    assert (diff <= ulp).mean() > 0.999


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("h,c,k", [(14, 480, 3), (15, 72, 5)])
def test_plain_version_equals_tap_sum_bitwise(h, c, k, stride):
    """At stride 1 the plain version is the folded trunk's tap-sum schedule
    (``_dw_taps``) cast to x.dtype, bit for bit; the tap sum also takes
    stride 2, where it agrees with the stride-1 map subsampled."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(h, c, k, n=2))
    taps = tfm._dw_taps(x, w, b, k, stride)
    full = dw.depthwise_conv_reference(x, w, b, kernel=k)
    assert torch.equal(taps, full[:, ::stride, ::stride, :])


@pytest.mark.parametrize("case", ["w_shape", "even_k", "bf16_acc", "b_shape",
                                  "int_input"])
def test_rejects(case):
    x = torch.zeros((1, 7, 7, 16))
    w, b = torch.zeros((5, 5, 16)), torch.zeros(16)
    kwargs = {"kernel": 5}
    if case == "w_shape":
        w = torch.zeros((5, 5, 15))
    elif case == "even_k":
        w, kwargs = torch.zeros((4, 4, 16)), {"kernel": 4}
    elif case == "bf16_acc":
        kwargs["acc_dtype"] = torch.bfloat16
    elif case == "b_shape":
        b = torch.zeros(8)
    else:
        x = torch.zeros((1, 7, 7, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        dw.depthwise_conv(x, w, b, **kwargs)


def test_cpu_tensors_launch_no_kernel_and_empty_batch():
    before = dw.launches
    x, w, b = (torch.from_numpy(a) for a in _inputs(7, 40, 3, n=2))
    out = dw.depthwise_conv(x, w, b, kernel=3)
    assert torch.equal(out, dw.depthwise_conv_reference(x, w, b, kernel=3))
    empty = dw.depthwise_conv(x[:0], w, b, kernel=3)
    assert empty.shape == (0, 7, 7, 40)
    assert dw.launches == before


def test_rows_per_tile_fits_every_b0_geometry():
    """Every stride-1 depthwise of B0 at 224 px gets a row tile inside the
    96 KB budget; the 112^2 x 32 map (262 KB as one 16-row tile) is cut."""
    metas = [m for m in tfm.block_metas(EfficientNetConfig()) if m.stride == 1]
    assert len(metas) == 12
    for m in metas:
        rows = dw.rows_per_tile(m.h, m.w, m.kernel)
        assert 1 <= rows <= min(m.h, 16)
        assert 4 * dw._smem_floats(rows, m.w, m.kernel) <= dw._SMEM_BUDGET
    assert dw.rows_per_tile(112, 112, 3) < 16
    # A map too wide for the budget (B7's 300^2) takes the hardware limit.
    assert 4 * dw._smem_floats(1, 300, 3) > dw._SMEM_BUDGET
    rows = dw.rows_per_tile(300, 300, 3)
    assert 4 * dw._smem_floats(rows, 300, 3) <= dw._SMEM_MAX
    with pytest.raises(ValueError, match="does not fit"):
        dw.rows_per_tile(2000, 2000, 3)
