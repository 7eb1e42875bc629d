"""The port's colour conversions (`sam_pt_torch/ops/color.py`) and
`patch_sample` (`sam_pt_torch/ops/sampling.py`) against the JAX package's,
float32 on the CPU.

Tolerances: LAB 1e-4 absolute on values of order 100 (cube roots and
powers in another order); grey 1e-4; patches 1e-5 (two bilinear weights a
tap, summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_pt_torch.ops import color as t_color
from sam_pt_torch.ops.sampling import patch_sample as t_patch_sample
from sam_pt_tpu.ops import color as j_color
from sam_pt_tpu.ops.sampling import patch_sample as j_patch_sample

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_rgb_to_lab_matches_jax(dtype):
    rng = np.random.default_rng(0)
    if dtype == "uint8":
        rgb = rng.integers(0, 256, (40, 50, 3)).astype(np.uint8)
        rgb[0, :3] = [[0, 0, 0], [255, 255, 255], [10, 10, 10]]
    else:
        rgb = rng.random((40, 50, 3)).astype(np.float32)
    got = t_color.rgb_to_lab(torch.from_numpy(rgb)).numpy()
    ref = np.asarray(j_color.rgb_to_lab(jnp.asarray(rgb)))
    assert got.dtype == np.float32 and got.shape == (40, 50, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_srgb_to_linear_and_gray_match_jax():
    x = np.linspace(0, 1, 1001, dtype=np.float32)  # both branches
    np.testing.assert_allclose(
        t_color._srgb_to_linear(torch.from_numpy(x)).numpy(),
        np.asarray(j_color._srgb_to_linear(jnp.asarray(x))), atol=1e-6,
        rtol=0)
    rgb = np.random.default_rng(1).integers(0, 256, (7, 9, 3)).astype(
        np.uint8)
    np.testing.assert_allclose(
        t_color.rgb_to_gray(torch.from_numpy(rgb)).numpy(),
        np.asarray(j_color.rgb_to_gray(jnp.asarray(rgb))), atol=1e-4,
        rtol=0)


@pytest.mark.parametrize("patch_size", [1, 3, 4, 5])
def test_patch_sample_matches_jax(patch_size):
    """Points inside, on and beyond the border (zero padding), at
    fractional positions; (dy, dx) order as the JAX function's."""
    rng = np.random.default_rng(patch_size)
    img = rng.standard_normal((20, 24, 3)).astype(np.float32)
    pts = rng.uniform(-3, 26, (9, 2)).astype(np.float32)
    pts[:3] = [[0, 0], [23, 19], [23.5, -0.5]]
    got = t_patch_sample(torch.from_numpy(img), torch.from_numpy(pts),
                         patch_size).numpy()
    ref = np.asarray(j_patch_sample(jnp.asarray(img), jnp.asarray(pts),
                                    patch_size))
    k = 2 * (patch_size // 2) + 1
    assert got.shape == ref.shape == (9, k * k, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_patch_sample_batched_over_frames():
    """Leading dims ride along: [T, H, W, C] frames with [T, N, 2] points
    give each frame's patches."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((4, 12, 16, 3)).astype(np.float32)
    pts = rng.uniform(0, 15, (4, 5, 2)).astype(np.float32)
    got = t_patch_sample(torch.from_numpy(img), torch.from_numpy(pts),
                         3).numpy()
    for f in range(4):
        ref = np.asarray(j_patch_sample(jnp.asarray(img[f]),
                                        jnp.asarray(pts[f]), 3))
        np.testing.assert_allclose(got[f], ref, atol=1e-5, rtol=0)
