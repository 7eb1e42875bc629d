"""The port's last host modules against the JAX package's on the same
numpy inputs (seeded): label propagation (`ops/label_propagation.py`),
`ops/basic.py`, and `utils/viz.py::{pca_feature_image, SummWriter}`.

Tolerances: float32 results 1e-5 (label propagation: its affinities are
exp(cos / 0.1), so 1e-5 relative); the neighbourhood mask, the 2-D argmax,
the masked median (numpy on both sides), the PCA images and the
summary PNGs equal. The port's functions run on the CPU here, as the
caller asks (`device="cpu"`, or CPU tensors).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_pt_torch.ops import basic as tbasic
from sam_pt_torch.ops import label_propagation as tlp
from sam_pt_torch.utils import viz as tviz
from sam_pt_torch.vos_eval.data.image_io import read_png
from sam_pt_tpu.ops import basic as jbasic
from sam_pt_tpu.ops import label_propagation as jlp

torch.set_num_threads(1)

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_restrict_neighborhood_matches_jax():
    got = tlp.restrict_neighborhood(6, 7, size=2, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jlp.restrict_neighborhood(6, 7, size=2)))


@pytest.mark.parametrize("size", [0, 2])
def test_label_propagation_matches_jax(size):
    rng = np.random.default_rng(size)
    h, w, dim, n, c = 6, 7, 16, 3, 4
    feat_tar = rng.standard_normal((h * w, dim)).astype(np.float32)
    feats = [rng.standard_normal((dim, h * w)).astype(np.float32)
             for _ in range(n)]
    segs = [rng.uniform(size=(1, c, h, w)).astype(np.float32)
            for _ in range(n)]
    got, mask = tlp.label_propagation(h, w, _t(feat_tar),
                                      [_t(f) for f in feats],
                                      [_t(s) for s in segs],
                                      neighborhood_size=size)
    ref, jmask = jlp.label_propagation(h, w, feat_tar, feats, segs,
                                       neighborhood_size=size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=ATOL)
    assert (mask is None) == (jmask is None) == (size == 0)


def test_norm_mask_matches_jax():
    m = np.random.default_rng(2).standard_normal((3, 5, 5)).astype(
        np.float32)
    m[1] = -np.abs(m[1])  # a channel whose max is not positive stays
    got = tlp.norm_mask(_t(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlp.norm_mask(m)), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(got[1], m[1])


def test_prep_frame_for_dino_matches_jax():
    pytest.importorskip("cv2")
    img = np.random.default_rng(3).integers(0, 255, (50, 90, 3)).astype(
        np.uint8)
    for scale in ((64,), (40, 64)):
        got = tlp.prep_frame_for_dino(img, scale)
        ref = jlp.prep_frame_for_dino(img, scale)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]


def test_basic_ops_match_jax():
    rng = np.random.default_rng(4)
    np.testing.assert_array_equal(
        tbasic.meshgrid2d(3, 5, device="cpu").numpy(),
        np.asarray(jbasic.meshgrid2d(3, 5)))
    np.testing.assert_array_equal(
        tbasic.meshgrid2d(3, 5, stack_dim=0, device="cpu").numpy(),
        np.asarray(jbasic.meshgrid2d(3, 5, stack_dim=0)))

    x = rng.standard_normal((4, 6)).astype(np.float32)
    mask = (rng.uniform(size=(4, 6)) > 0.4).astype(np.float32)
    mask[2] = 0  # a row with no element
    for dim in (None, 1):
        np.testing.assert_allclose(
            tbasic.reduce_masked_mean(_t(x), _t(mask), dim=dim).numpy(),
            np.asarray(jbasic.reduce_masked_mean(x, mask, axis=dim)),
            atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tbasic.reduce_masked_median(x, mask),
                                  jbasic.reduce_masked_median(x, mask))

    heat = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    heat[0, 0, 1, 2] = heat[0, 0, 3, 4] = 9.0  # a tie: the first wins
    for got, ref in zip(tbasic.argmax2d(_t(heat)), jbasic.argmax2d(heat)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    img = rng.uniform(0, 1, (2, 9, 11, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tbasic.gaussian_blur(_t(img), 5, 1.5).numpy(),
        np.asarray(jbasic.gaussian_blur(jnp.asarray(img), 5, 1.5)),
        atol=ATOL, rtol=0)


def test_pca_feature_image_and_summ_writer_match_jax(tmp_path):
    """The PCA image (numpy on both sides: equal), and the summary
    writer's PNGs, written by the port's codec, equal to the JAX writer's
    (Pillow)."""
    from sam_pt_tpu.utils import viz as jviz

    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 12, 16, 8)).astype(np.float32)
    valid = rng.uniform(size=(2, 12, 16)) > 0.3
    for f, v in ((feats, None), (feats, valid), (feats[0], valid[0])):
        np.testing.assert_array_equal(tviz.pca_feature_image(f, v),
                                      jviz.pca_feature_image(f, v))
    rgb = rng.uniform(0, 1, (12, 16, 3))
    written = {}
    for name, module in (("port", tviz), ("jax", jviz)):
        writer = module.SummWriter(str(tmp_path / name), global_step=3)
        writer.summ_rgb("a/rgb", rgb)
        writer.summ_feat("feat", feats[0])
        writer.summ_oned("oned", feats[0, ..., 0])
        written[name] = sorted(os.listdir(tmp_path / name))
        quiet = module.SummWriter(str(tmp_path / f"{name}_quiet"),
                                  global_step=3, log_freq=2)
        quiet.summ_rgb("rgb", rgb)
        assert not os.listdir(tmp_path / f"{name}_quiet")
    assert written["port"] == written["jax"] == [
        "000003_a_rgb.png", "000003_feat.png", "000003_oned.png"]
    for fname in written["port"]:
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "port" / fname))[0],
            read_png(str(tmp_path / "jax" / fname))[0])
