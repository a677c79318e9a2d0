"""The port's crop + normalize against the JAX package's: the Pallas kernel
in interpret mode (f32) and the XLA gather (f32 and bf16), at arbitrary and
edge offsets. Bounds are the JAX tests' own (tests/models/test_patch_ops.py):
atol 1e-6 at f32, and one bf16 ulp at bf16. On the CPU the wrapper runs its
plain version and launches nothing."""

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
}


def _port(image, rowcols, ps, out_dtype):
    scale, bias = tpo.channel_scale_bias(MEAN, STD)
    padded = tpo.pad_image(torch.from_numpy(image), ps)
    starts = tpo.rowcols_to_starts(rowcols, ps).numpy()
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
