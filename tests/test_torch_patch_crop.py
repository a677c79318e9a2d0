"""The port's crop + normalize against the JAX package's: the Pallas kernel
in interpret mode (f32) and the XLA gather (f32 and bf16), at arbitrary and
edge offsets, on the host-padded image (pad 0) and on the raw image with the
pad folded into the crop (pad ps//2). Bounds are the JAX tests' own
(tests/models/test_patch_ops.py): atol 1e-6 at f32, and one bf16 ulp at
bf16. On the CPU the wrapper runs its plain version and launches nothing; a
numpy walk of the CUDA kernel's thread map holds its addressing to the
plain version bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.experiments.pallas_crop import (
    extract_patches_pallas,
    make_affine_rows,
)
from mermaid_classifier_tpu.ops import patch_ops as jpo
from mermaid_classifier_tpu_torch.ops import patch_crop
from mermaid_classifier_tpu_torch.ops import patch_ops as tpo

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _case(ps, h, w, n, seed):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    rowcols = np.stack([rng.integers(0, h, n), rng.integers(0, w, n)], 1)
    # Corners and edges: crops reaching into the zero padding on each side.
    edges = [[0, 0], [h - 1, w - 1], [0, w - 1], [h - 1, 0], [h // 2, 0],
             [0, w // 2]]
    return image, np.concatenate([edges, rowcols]).astype(np.int32), ps


CASES = {
    "ps16": _case(16, 40, 56, 10, 0),
    "ps8_many": _case(8, 64, 64, 25, 1),
    "ps32_odd": _case(32, 37, 45, 7, 2),
    "ps9_odd_ps": _case(9, 30, 41, 8, 3),
    "ps8_strip_w1": _case(8, 40, 1, 5, 4),
}


def _port(image, rowcols, ps, out_dtype, raw=False):
    """The port's crop: of the host-padded image at pad 0, or of the raw
    image with the pad folded in (``raw``)."""
    scale, bias = tpo.channel_scale_bias(MEAN, STD)
    starts = tpo.rowcols_to_starts(rowcols, ps).numpy()
    if raw:
        return patch_crop.extract_patches(torch.from_numpy(image), starts, ps,
                                          scale, bias, out_dtype, pad=ps // 2)
    padded = tpo.pad_image(torch.from_numpy(image), ps)
    return patch_crop.extract_patches(padded, starts, ps, scale, bias, out_dtype)


def _jax_xla(image, rowcols, ps, out_dtype):
    scale, bias = jpo.channel_scale_bias(MEAN, STD)
    padded = jpo.pad_image(jnp.asarray(image), ps)
    return np.asarray(jpo.extract_patches_xla(
        padded, jnp.asarray(rowcols), ps, jnp.asarray(scale),
        jnp.asarray(bias), out_dtype=out_dtype,
    ).astype(jnp.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_matches_pallas_interpret(case):
    image, rowcols, ps = CASES[case]
    scale, bias = jpo.channel_scale_bias(MEAN, STD)
    scale_row, bias_row = make_affine_rows(scale, bias, ps)
    want = np.asarray(extract_patches_pallas(
        jpo.pad_image(jnp.asarray(image), ps), jnp.asarray(rowcols), ps,
        jnp.asarray(scale_row), jnp.asarray(bias_row), interpret=True,
    ))
    got = _port(image, rowcols, ps, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (len(rowcols), ps, ps, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_matches_xla(case):
    image, rowcols, ps = CASES[case]
    got = _port(image, rowcols, ps, torch.float32).numpy()
    np.testing.assert_allclose(got, _jax_xla(image, rowcols, ps, jnp.float32),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_matches_xla_to_one_ulp(case):
    image, rowcols, ps = CASES[case]
    got = _port(image, rowcols, ps, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = _jax_xla(image, rowcols, ps, jnp.bfloat16)
    # One bf16 ulp at the value's magnitude: 2^(floor(log2|x|) - 7).
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp)


def test_affine_is_mul_then_add_in_f32():
    """The plain version is x.float() * scale + bias with no contraction:
    what the CUDA kernel reproduces bit for bit with __fmul_rn/__fadd_rn."""
    image, rowcols, ps = CASES["ps16"]
    scale, bias = tpo.channel_scale_bias(MEAN, STD)
    got = _port(image, rowcols, ps, torch.float32).numpy()
    padded = np.pad(image, ((ps // 2,) * 2, (ps // 2,) * 2, (0, 0)))
    for i, (r, c) in enumerate(rowcols):
        crop = padded[r:r + ps, c:c + ps].astype(np.float32)
        want = (crop * scale).astype(np.float32) + bias
        np.testing.assert_array_equal(got[i], want)


def test_starts_are_validated():
    image = torch.zeros((40, 40, 3), dtype=torch.uint8)
    scale, bias = tpo.channel_scale_bias(MEAN, STD)
    for bad in ([[-1, 0]], [[0, 25]], [[25, 0]]):
        with pytest.raises(ValueError, match="leaves"):
            patch_crop.extract_patches(image, np.array(bad), 16, scale, bias)
    with pytest.raises(ValueError, match=r"\(P, 2\)"):
        patch_crop.extract_patches(image, np.zeros((3,)), 16, scale, bias)
    with pytest.raises(ValueError, match="uint8"):
        patch_crop.extract_patches(image.float(), np.zeros((1, 2)), 16, scale, bias)
    # The last in-bounds start is accepted.
    out = patch_crop.extract_patches(image, np.array([[24, 24]]), 16, scale, bias)
    assert out.shape == (1, 16, 16, 3)


def test_cpu_image_launches_no_kernel():
    before = patch_crop.launches
    image, rowcols, ps = CASES["ps8_many"]
    _port(image, rowcols, ps, torch.float32)
    assert patch_crop.launches == before


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_pad_equals_host_padded(case, out_dtype):
    """The plain crop of the raw image with pad ps//2 is the plain crop of
    the host-padded image, bit for bit, zeros' affine included."""
    image, rowcols, ps = CASES[case]
    scale, bias = (torch.from_numpy(a) for a in tpo.channel_scale_bias(MEAN, STD))
    raw = torch.from_numpy(image)
    starts = tpo.rowcols_to_starts(rowcols, ps)
    got = tpo.extract_patches_plain(raw, starts, ps, scale, bias, out_dtype,
                                    pad=ps // 2)
    want = tpo.extract_patches_plain(tpo.pad_image(raw, ps), starts, ps, scale,
                                     bias, out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_raw_f32_matches_pallas_interpret(case):
    image, rowcols, ps = CASES[case]
    scale, bias = jpo.channel_scale_bias(MEAN, STD)
    scale_row, bias_row = make_affine_rows(scale, bias, ps)
    want = np.asarray(extract_patches_pallas(
        jpo.pad_image(jnp.asarray(image), ps), jnp.asarray(rowcols), ps,
        jnp.asarray(scale_row), jnp.asarray(bias_row), interpret=True,
    ))
    got = _port(image, rowcols, ps, torch.float32, raw=True)
    assert got.shape == (len(rowcols), ps, ps, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_raw_f32_matches_xla(case):
    image, rowcols, ps = CASES[case]
    got = _port(image, rowcols, ps, torch.float32, raw=True).numpy()
    np.testing.assert_allclose(got, _jax_xla(image, rowcols, ps, jnp.float32),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_raw_bf16_matches_xla_to_one_ulp(case):
    image, rowcols, ps = CASES[case]
    got = _port(image, rowcols, ps, torch.bfloat16, raw=True)
    assert got.dtype == torch.bfloat16
    want = _jax_xla(image, rowcols, ps, jnp.bfloat16)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp)


@pytest.mark.parametrize("pad", [0, 8])
def test_starts_are_validated_with_pad(pad):
    """Starts are checked against the image padded by ``pad``: a 16-px crop
    of a 40x40 image fits at starts 0..24 + 2 pad."""
    image = torch.zeros((40, 40, 3), dtype=torch.uint8)
    scale, bias = tpo.channel_scale_bias(MEAN, STD)
    last = 24 + 2 * pad
    for bad in ([[-1, 0]], [[0, -1]], [[0, last + 1]], [[last + 1, 0]]):
        with pytest.raises(ValueError, match="leaves"):
            patch_crop.extract_patches(image, np.array(bad), 16, scale, bias,
                                       pad=pad)
    out = patch_crop.extract_patches(image, np.array([[last, last]]), 16,
                                     scale, bias, pad=pad)
    assert out.shape == (1, 16, 16, 3)
    with pytest.raises(ValueError, match="pad"):
        patch_crop.extract_patches(image, np.array([[0, 0]]), 16, scale, bias,
                                   pad=-1)


@pytest.mark.parametrize("out_dtype", DTYPES)
def test_launch_entry_on_cpu_runs_plain(out_dtype):
    """``launch`` fills a preallocated output; on a CPU image it runs the
    plain version and counts no launch."""
    image, rowcols, ps = CASES["ps16"]
    scale, bias = tpo.channel_scale_bias(MEAN, STD)
    raw = torch.from_numpy(image)
    starts = tpo.rowcols_to_starts(rowcols, ps)
    out = torch.empty((len(rowcols), ps, ps, 3), dtype=out_dtype)
    before = patch_crop.launches
    got = patch_crop.launch(raw, starts, out, (*map(float, scale),
                                               *map(float, bias)), ps // 2)
    assert got is out and patch_crop.launches == before
    assert torch.equal(out, _port(image, rowcols, ps, out_dtype, raw=True))


# -- the CUDA kernel's map, walked in numpy -----------------------------------

# csrc/patch_crop.cu's launch geometry.
K_THREADS, K_PIX, K_GROUPS_PER_THREAD = 256, 8, 2


def _kernel_walk(buf, off, h, w, starts, ps, pad, scale, bias, out_dtype):
    """The crop as csrc/patch_crop.cu computes it, thread by thread: the
    image is the (h, w, 3) bytes at ``off`` in the flat buffer ``buf``
    (whose other bytes are noise); each thread's groups of 8 pixels read the
    aligned 16-byte words that hold in-image bytes of their row (every word
    inside the buffer), select and funnel-shift them into 6 little-endian
    words, zero the pixels outside the image, run the f32 affine and store
    the row's live pixels (at element 24 g when ps % 8 == 0)."""
    gpr = -(-ps // K_PIX)
    n_groups = len(starts) * ps * gpr
    per_block = K_THREADS * K_GROUPS_PER_THREAD
    out = np.full(len(starts) * ps * ps * 3, np.nan, np.float32)
    seen = np.zeros(n_groups, np.int64)
    s24, b24 = np.tile(scale, K_PIX), np.tile(bias, K_PIX)
    pixel_of_byte = np.arange(3 * K_PIX) // 3
    for block in range(-(-n_groups // per_block)):
        for t in range(K_THREADS):
            for k in range(K_GROUPS_PER_THREAD):
                g = block * per_block + t + k * K_THREADS
                if g >= n_groups:
                    continue
                seen[g] += 1
                row, gx = divmod(g, gpr)
                p, i = divmod(row, ps)
                y = int(starts[p, 0]) - pad + i
                x0 = int(starts[p, 1]) - pad + gx * K_PIX
                lo, hi = max(0, -x0), min(K_PIX, w - x0)
                valid = 0 <= y < h and lo < hi
                words = np.zeros(48, np.uint8)
                shift = 0
                if valid:
                    a = off + (y * w + x0) * 3
                    a0 = a & ~15
                    shift = a - a0
                    for m in range(3):
                        wa = a0 + 16 * m
                        if wa < a + 3 * hi and wa + 16 > a + 3 * lo:
                            assert 0 <= wa and wa + 16 <= len(buf)
                            words[16 * m:16 * m + 16] = buf[wa:wa + 16]
                u = words.view("<u4").astype(np.uint64)
                q, sh = shift >> 2, (shift & 3) * 8
                v = u[q:q + 7]
                o = ((v[1:] << np.uint64(32) | v[:-1]) >> np.uint64(sh)) \
                    & np.uint64(0xFFFFFFFF)
                x = o.astype("<u4").view(np.uint8).copy()
                pix = np.arange(K_PIX)
                live = valid & (pix >= lo) & (pix < hi)
                x[~live[pixel_of_byte]] = 0
                vals = x.astype(np.float32) * s24 + b24
                n_pix = min(K_PIX, ps - gx * K_PIX)
                dst = (row * ps + gx * K_PIX) * 3
                if ps % K_PIX == 0:
                    assert dst == 3 * K_PIX * g
                out[dst:dst + 3 * n_pix] = vals[:3 * n_pix]
    assert (seen == 1).all()
    assert not np.isnan(out).any()
    return torch.from_numpy(out.reshape(len(starts), ps, ps, 3)).to(out_dtype)


WALK_CASES = {
    **{name: (*case, "raw") for name, case in CASES.items()},
    "ps33_narrow": (*_case(33, 50, 20, 4, 5), "raw"),
    "ps16_padded": (*CASES["ps16"], "padded"),
    "ps9_padded": (*CASES["ps9_odd_ps"], "padded"),
}


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("off", [0, 1, 7, 13])
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_kernel_walk_equals_plain(case, off, out_dtype):
    """The kernel's thread -> (row, byte range, shift) map with its
    aligned-word loads and zero mask equals the plain crop, for the raw
    image at pad ps//2 and the host-padded image at pad 0, at image offsets
    that put every shift in play."""
    image, rowcols, ps, mode = WALK_CASES[case]
    if mode == "padded":
        image = np.pad(image, ((ps // 2,) * 2, (ps // 2,) * 2, (0, 0)))
    pad = ps // 2 if mode == "raw" else 0
    h, w, _ = image.shape
    rng = np.random.default_rng(off)
    buf = rng.integers(0, 256, -(-(off + image.size) // 16) * 16, np.uint8)
    buf[off:off + image.size] = image.reshape(-1)
    scale, bias = tpo.channel_scale_bias(MEAN, STD)
    starts = np.asarray(rowcols, np.int32)
    got = _kernel_walk(buf, off, h, w, starts, ps, pad, scale, bias, out_dtype)
    want = tpo.extract_patches_plain(
        torch.from_numpy(image), torch.from_numpy(starts), ps,
        torch.from_numpy(scale), torch.from_numpy(bias), out_dtype, pad=pad)
    assert torch.equal(got, want)
