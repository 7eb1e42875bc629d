"""The port's banded resizes, at the main path's real shapes, against the
dense weight matrices they are cut from and against the JAX package's
dense products (`sam_pt_tpu/ops/resize.py`), and its neighbourhood samples
(the hat-matrix products) against `sam_pt_tpu/ops/sampling.py`'s at the
trackers' real shapes, on the same numpy inputs.

Tolerances: the bands against the dense float32 matrices exactly (they are
cut from them); applied results 1e-3 absolute on the 0-255 scale of
frames, 1e-4 on mask logits of order 10 and 1e-5 on correlations of order
1-10, as the port's other parity tests of these ops hold them: both sides
apply the same float32 weights and differ in summation order only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_pt_torch.ops import resize as tres
from sam_pt_torch.ops import sampling as tsamp
from sam_pt_tpu.ops import resize as jres
from sam_pt_tpu.ops import sampling as jsamp

torch.set_num_threads(1)

# (in, out, mode, antialias) of the main path's resizes, axis by axis:
# the encode (480 x 854 -> 576 x 1024, antialiased), the logits (256 ->
# 1024, then 576 x 1024 -> 480 x 854), the tracker input (480 x 854 -> 384
# x 512), PIPS's align-corners feature resize, a rel-pos table, and a
# downscale by a non-integer factor.
AXES = [(480, 576, "half_pixel", True), (854, 1024, "half_pixel", True),
        (256, 1024, "half_pixel", False), (1024, 480, "half_pixel", False),
        (1024, 854, "half_pixel", False), (480, 384, "half_pixel", True),
        (854, 512, "half_pixel", True), (480, 384, "half_pixel", False),
        (60, 120, "align_corners", False), (27, 127, "half_pixel", False),
        (854, 193, "half_pixel", True)]


@pytest.mark.parametrize("in_size,out_size,mode,antialias", AXES)
def test_band_is_the_dense_matrix(in_size, out_size, mode, antialias):
    """Scattered back, the band is the dense float32 matrix, bit for bit;
    it is no wider than the filter's support needs."""
    dense = jres._resize_matrix(in_size, out_size, mode, antialias)
    index, weights = tres._band(in_size, out_size, mode, antialias)
    back = np.zeros_like(dense)
    np.add.at(back, (np.arange(out_size)[:, None], index), weights)
    np.testing.assert_array_equal(back, dense)
    scale = in_size / out_size
    support = max(scale, 1.0) if antialias and mode == "half_pixel" else 1.0
    assert index.shape[1] <= int(np.ceil(2 * support)) + 1


def _frames(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, shape).astype(np.float32)


@pytest.mark.parametrize("out_hw,antialias", [
    ((576, 1024), True),   # SAM's encode resize
    ((384, 512), False),   # the trackers' input resize (CoTracker)
    ((384, 512), True)])
def test_frames_at_real_shapes(out_hw, antialias):
    x = _frames(0, (2, 480, 854, 3))
    got = tres.resize_bilinear(torch.from_numpy(x), out_hw,
                               antialias=antialias)
    want = jres.resize_bilinear(jnp.asarray(x), out_hw, antialias=antialias)
    assert tuple(got.shape) == (2, *out_hw, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)


def test_logits_upscale_at_real_shapes():
    """256 x 256 low-res logits -> 1024, cropped to 576 x 1024, -> 480 x
    854: `SamPredictor.upscale_logits`' two resizes."""
    rng = np.random.default_rng(1)
    low = (5 * rng.standard_normal((3, 256, 256))).astype(np.float32)
    x = tres.resize_planes(torch.from_numpy(low), (1024, 1024),
                           crop_hw=(576, 1024))
    got = tres.resize_planes(x, (480, 854))
    y = jres.resize_bilinear(jnp.asarray(low)[..., None], (1024, 1024))
    want = jres.resize_bilinear(y[:, :576, :1024], (480, 854))[..., 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_align_corners_feature_resize():
    """PIPS's feature maps (channels-first) to the stride-4 grid of a 480 x
    854 frame, align-corners."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 60, 107)).astype(np.float32)
    got = tres.resize_bilinear(torch.from_numpy(x), (120, 213),
                               align_corners=True, h_axis=-2, w_axis=-1)
    want = jres.resize_bilinear(jnp.asarray(x), (120, 213),
                                align_corners=True, h_axis=-2, w_axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)


@pytest.mark.parametrize("name,plane_shape,radius,zero_pad", [
    ("pips", (8, 17, 120, 213), 3, True),    # PIPS level 0, 8 frames
    ("pips_l3", (8, 17, 15, 26), 3, True),   # PIPS level 3
    ("raft", (1, 256, 60, 107), 4, True),    # RAFT level 0, 256 positions
    ("clamped", (2, 9, 30, 40), 2, False)])
def test_neighborhood_sample_at_real_shapes(name, plane_shape, radius,
                                            zero_pad):
    """(2r+1)^2 bilinear taps around centres that reach past every border,
    against the JAX package's hat-matrix products."""
    rng = np.random.default_rng(3)
    plane = rng.standard_normal(plane_shape).astype(np.float32) * 4
    h, w = plane_shape[-2:]
    cx = rng.uniform(-radius - 2, w + radius + 1,
                     plane_shape[:-2]).astype(np.float32)
    cy = rng.uniform(-radius - 2, h + radius + 1,
                     plane_shape[:-2]).astype(np.float32)
    cx.flat[0], cy.flat[0] = 3.0, 5.0  # integer centres: exact taps
    d = np.linspace(-radius, radius, 2 * radius + 1).astype(np.float32)
    got = tsamp.separable_neighborhood_sample(
        torch.from_numpy(plane), torch.from_numpy(cx), torch.from_numpy(cy),
        torch.from_numpy(d), torch.from_numpy(d), zero_pad=zero_pad)
    want = jsamp.separable_neighborhood_sample(
        jnp.asarray(plane), jnp.asarray(cx), jnp.asarray(cy),
        jnp.asarray(d), jnp.asarray(d), zero_pad=zero_pad)
    assert tuple(got.shape) == (*plane_shape[:-2], 2 * radius + 1,
                                2 * radius + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)
    centre = plane[(0,) * (len(plane_shape) - 2)]
    np.testing.assert_array_equal(
        got.numpy()[(0,) * (len(plane_shape) - 2)][radius, radius],
        centre[5, 3])
