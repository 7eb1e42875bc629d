"""Port ops against the JAX package's ops on the same numpy inputs, in f32.

Tolerance 1e-5 absolute on O(1)-O(100) values: both sides apply the same
float32 weight matrices and taps, so only summation order differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_pt_torch.ops import posemb as tpe
from sam_pt_torch.ops import resize as tres
from sam_pt_torch.ops import sampling as tsamp
from sam_pt_torch.models.tracker.pips import model as tpips
from sam_pt_tpu.models.tracker.pips import model as jpips
from sam_pt_tpu.ops import posemb as jpe
from sam_pt_tpu.ops import resize as jres
from sam_pt_tpu.ops import sampling as jsamp

torch.set_num_threads(1)


def _close(got, want, atol=1e-5, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


class TestResize:
    @pytest.mark.parametrize("antialias", [True, False])
    def test_downscale_like_sam_preprocessing(self, antialias):
        """480 x 854 frames to SAM's longest side 1024 -> (575, 1024), and a
        down-scale, where the antialias filter matters."""
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 255, (2, 48, 86, 3)).astype(np.float32)
        for hw in ((58, 103), (20, 37)):
            _close(tres.resize_bilinear(torch.from_numpy(x), hw,
                                        antialias=antialias),
                   jres.resize_bilinear(jnp.asarray(x), hw,
                                        antialias=antialias), atol=1e-3)

    def test_align_corners_and_longest_side(self):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 3, 11, 13)).astype(np.float32)
        _close(tres.resize_bilinear(torch.from_numpy(x), (22, 26),
                                    align_corners=True, h_axis=-2, w_axis=-1),
               jres.resize_bilinear(jnp.asarray(x), (22, 26),
                                    align_corners=True, h_axis=-2, w_axis=-1))
        assert (tres.get_longest_side_target_hw(480, 854, 1024)
                == jres.get_longest_side_target_hw(480, 854, 1024))
        img = rng.uniform(0, 255, (30, 40, 3)).astype(np.float32)
        _close(tres.resize_longest_side(torch.from_numpy(img), 64),
               jres.resize_longest_side(jnp.asarray(img), 64), atol=1e-3)


class TestSampling:
    @pytest.mark.parametrize("pad_mode", ["clamp", "zeros"])
    def test_bilinear_sample(self, pad_mode):
        rng = np.random.default_rng(2)
        img = rng.standard_normal((9, 11, 5)).astype(np.float32)
        x = rng.uniform(-2, 13, (17,)).astype(np.float32)
        y = rng.uniform(-2, 11, (17,)).astype(np.float32)
        got = tsamp.bilinear_sample(torch.from_numpy(img)[None],
                                    torch.from_numpy(x)[None],
                                    torch.from_numpy(y)[None],
                                    pad_mode=pad_mode)[0]
        _close(got, jsamp.bilinear_sample(jnp.asarray(img), jnp.asarray(x),
                                          jnp.asarray(y), pad_mode=pad_mode))

    def test_correlation_pyramid_and_sampling(self):
        rng = np.random.default_rng(3)
        fmaps = rng.standard_normal((4, 16, 24, 8)).astype(np.float32)
        feats = rng.standard_normal((4, 5, 8)).astype(np.float32)
        coords = rng.uniform(-3, 26, (4, 5, 2)).astype(np.float32)
        jp = jpips.correlation_pyramid(jnp.asarray(fmaps), jnp.asarray(feats),
                                       4)
        tp = tpips.correlation_pyramid(torch.from_numpy(fmaps),
                                       torch.from_numpy(feats), 4)
        for a, b in zip(tp, jp):
            _close(a, b)
        _close(tpips.sample_corr_pyramid(tp, torch.from_numpy(coords), 3),
               jpips.sample_corr_pyramid(jp, jnp.asarray(coords), 3))


class TestPosEmb:
    def test_embeddings(self):
        rng = np.random.default_rng(4)
        xy = rng.uniform(-5, 5, (3, 4, 2)).astype(np.float32)
        xyz = rng.uniform(-5, 5, (3, 4, 3)).astype(np.float32)
        t = np.arange(6, dtype=np.float32)
        _close(tpe.get_2d_sincos_embedding(torch.from_numpy(xy), 64),
               jpe.get_2d_sincos_embedding(jnp.asarray(xy), 64))
        _close(tpe.get_3d_sincos_embedding(torch.from_numpy(xyz), 64),
               jpe.get_3d_sincos_embedding(jnp.asarray(xyz), 64))
        _close(tpe.get_1d_sincos_embedding(torch.from_numpy(t), 456),
               jpe.get_1d_sincos_embedding(jnp.asarray(t), 456))
        _close(tpe.sincos_pos_embed_2d_grid(456, (6, 8)),
               jpe.sincos_pos_embed_2d_grid(456, (6, 8)))


class TestHostCopies:
    """The port's copies of the JAX package's pure-numpy host modules give
    the same results from the same seed (exact: same numpy code)."""

    def test_query_point_samplers(self):
        from sam_pt_torch.utils import query_points as tqp
        from sam_pt_tpu.utils import query_points as jqp

        rng = np.random.default_rng(5)
        images = rng.integers(0, 255, (4, 48, 64, 3)).astype(np.uint8)
        masks = np.zeros((2, 48, 64), np.float32)
        masks[0, 5:30, 8:40] = 1
        masks[1, 20:45, 30:60] = 1
        ts = np.array([0, 2], np.float32)
        for name, call in (
                ("kmedoids", lambda qp, g: [qp.extract_kmedoid_points(
                    m, 8, rng=g) for m in masks]),
                ("random", lambda qp, g: [qp.extract_random_mask_points(
                    m, 8, rng=g) for m in masks]),
                ("shi-tomasi", lambda qp, g: [qp.extract_corner_points(
                    images[int(t)], m, 8, rng=g) for m, t in zip(masks, ts)]),
                ("mixed", lambda qp, g: qp.extract_mixed_points(
                    list(1.0 - masks), ts, images, 8, rng=g))):
            got = call(tqp, np.random.default_rng(72))
            want = call(jqp, np.random.default_rng(72))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b, err_msg=name)

    def test_point_visibility_type(self):
        from sam_pt_torch.utils.util import PointVisibilityType as T
        from sam_pt_tpu.utils.util import PointVisibilityType as J

        assert {m.name: int(m) for m in T} == {m.name: int(m) for m in J}
