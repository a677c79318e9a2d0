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
    """Every stride-1 depthwise of B0 at 224 px, at the trunk's 128 patches
    in f32 and bf16, gets a plan inside the shared-memory budget; the
    112^2 x 32 map (a 114-row band would take 456 KB at f32) is cut into
    bands walked through a ring of strips; a map too wide for the budget
    (B7's 300^2) takes the hardware limit, and one too wide for that
    raises."""
    metas = [m for m in tfm.block_metas(EfficientNetConfig()) if m.stride == 1]
    assert len(metas) == 12
    for m in metas:
        for dtype, item in ((torch.float32, 4), (torch.bfloat16, 2)):
            plan = dw.tile_plan(128, m.h, m.w, m.mid_channels, m.kernel, dtype, 0)
            assert 1 <= plan.strip and 1 <= plan.band <= 128 * (m.h + m.kernel - 1)
            assert plan.vector_loads
            smem = dw._smem_bytes(plan.band, plan.strip, m.w, m.kernel, item)
            assert smem <= dw._SMEM_BUDGET, (m, dtype, plan)
    plan = dw.tile_plan(128, 112, 112, 32, 3, torch.float32, 0)
    assert plan.band < 112 and plan.strip < plan.band
    for dtype, item in ((torch.float32, 4), (torch.bfloat16, 2)):
        plan = dw.tile_plan(128, 300, 300, 32, 3, dtype, 0)
        smem = dw._smem_bytes(plan.band, plan.strip, 300, 3, item)
        assert smem <= dw._SMEM_MAX
    assert dw._smem_bytes(1, 1, 300, 3, 4) > dw._SMEM_BUDGET
    with pytest.raises(ValueError, match="does not fit"):
        dw.tile_plan(1, 2000, 2000, 32, 3, torch.float32, 0)


@pytest.mark.parametrize("case,ptr,c,dtype,vector", [
    ("aligned_f32", 0, 32, torch.float32, True),
    ("aligned_bf16", 4096, 1152, torch.bfloat16, True),
    ("c20_f32", 0, 20, torch.float32, True),
    ("c20_bf16", 0, 20, torch.bfloat16, False),
    ("odd_c_f32", 0, 5, torch.float32, False),
    ("odd_c_bf16", 0, 73, torch.bfloat16, False),
    ("misaligned_4", 4, 32, torch.float32, False),
    ("misaligned_8", 8, 32, torch.bfloat16, False),
])
def test_plan_picks_vector_or_scalar_staging(case, ptr, c, dtype, vector):
    """16-byte copies only for a 16-byte aligned pointer and C a multiple
    of the vector width (4 f32, 8 bf16); the scalar instance otherwise."""
    assert dw.tile_plan(3, 13, 13, c, 3, dtype, ptr).vector_loads is vector


def test_plan_sees_a_misaligned_view():
    """A view one element into its storage is not 16-byte aligned even
    when its storage is, so the plan takes the scalar instance."""
    base = torch.zeros(3 * 13 * 13 * 32 + 1)
    whole = base[:-1].view(3, 13, 13, 32)
    view = base[1:].view(3, 13, 13, 32)
    assert whole.data_ptr() % 16 == 0
    assert dw.tile_plan(3, 13, 13, 32, 3, torch.float32, whole.data_ptr()).vector_loads
    assert not dw.tile_plan(3, 13, 13, 32, 3, torch.float32, view.data_ptr()).vector_loads


def _walk(n, h, k, band, strip):
    """The kernel's walk of the stack, in Python: for every block, stage
    its rows into ring slots as the kernel does (the next strip's copies
    counted as landed before the current strip is read, the worst case)
    and check that every tap row read holds the row it should. Returns the
    (map, row) of every output row computed."""
    p = (k - 1) // 2
    hv = h + 2 * p
    rows = n * hv - 2 * p
    ring = (band if strip >= band else 2 * strip) + k - 1
    done = []
    for v0 in range(0, rows, band):
        vend = min(v0 + band, rows)
        slots = {}

        def stage(a, b):
            for v in range(a, b):
                slots[(v - v0) % ring] = v

        stage(v0, min(v0 + strip, vend) + 2 * p)
        for vs in range(v0, vend, strip):
            ve = min(vs + strip, vend)
            if ve < vend:
                stage(ve + 2 * p, min(ve + strip, vend) + 2 * p)
            for v in range(vs, ve):
                for dy in range(k):
                    assert slots[(v - v0 + dy) % ring] == v + dy, (v0, v, dy)
                if v % hv < h:
                    done.append((v // hv, v % hv))
    return done


@pytest.mark.parametrize("n,h,c,k", [
    (128, 112, 32, 3), (128, 56, 144, 3), (128, 28, 240, 5), (128, 14, 480, 3),
    (128, 14, 672, 5), (128, 7, 1152, 5), (128, 7, 1152, 3), (3, 13, 40, 7),
    (3, 1, 24, 3), (1, 113, 20, 5), (3, 13, 40, 1),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_walk_reads_every_tap_row_and_each_output_once(n, h, c, k, dtype):
    """The stacked-band plan as the kernel walks it: every tap reads the
    input row it needs from the ring (halo rows loaded once per band), and
    the bands together compute each output row of each map exactly once."""
    plan = dw.tile_plan(n, h, h, c, k, dtype, 0)
    done = _walk(n, h, k, plan.band, plan.strip)
    assert sorted(done) == [(q, y) for q in range(n) for y in range(h)]
    # The ring walk itself, with strips shorter than the band.
    done = _walk(n, h, k, max(plan.band, 3), 1)
    assert sorted(done) == [(q, y) for q in range(n) for y in range(h)]
