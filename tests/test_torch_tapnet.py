"""TapNet in the port (`sam_pt_torch/models/tracker/tapnet/`) against the
JAX package's, in float32, on the same random haiku checkpoint
(`torch_port_helpers.random_tapnet_haiku_checkpoint`: params and the
BatchNorm moving averages in its state, the published widths, written as an
.npy and read by each side's own reader).

Tolerances: blocks 1e-4 (float32 summation order); whole-model tracks
1e-3 raster px, occlusion logits 1e-3; the tracker's trajectories 1e-3 px
with equal visibilities; the SamPt pair as test_torch_default_model.py.
The tests assert the margins of the discontinuities on their own inputs:
the two largest heatmap logits of every (query, frame) lie further apart
than the two sides' logits differ, and no visibility score lies within
1e-3 of the threshold. The JAX model runs under `jax.jit`.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_pt_torch.models.tracker.tapir.tracker import (not_occluded,
                                                       raster_queries)
from sam_pt_torch.models.tracker.tapnet import model as tmodel
from sam_pt_torch.models.tracker.tapnet.tracker import TapNetPointTracker
from sam_pt_torch.utils import checkpoint as tckpt
from sam_pt_tpu.models.tracker.tapnet import model as jmodel
from sam_pt_tpu.utils import checkpoint as jckpt
from torch_port_helpers import (
    assert_argmax_margins, assert_sam_pt_pair, assert_visibility_margins,
    flax_params, haiku_tracker_pair, random_tapnet_haiku_checkpoint,
    sam_pt_video, save_npy, smooth_video, tiny_sam_pt_pair, tree_equal)

torch.set_num_threads(1)

ATOL = 1e-3
BLOCK_ATOL = 1e-4


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return save_npy(tmp_path_factory.mktemp("tapnet") / "tapnet.npy",
                    random_tapnet_haiku_checkpoint(seed=40))


def test_converter_copy_and_state_dict(checkpoint):
    """The port's copy of the haiku key map gives the JAX converter's tree
    (the Conv3D heads' leading 1 dropped, the BatchNorm affine flattened,
    the moving averages as mean and var); the port's model loads it whole,
    the averages as its running statistics."""
    raw = np.load(checkpoint, allow_pickle=True).item()
    jtree = jckpt.load_tapnet_checkpoint(checkpoint)
    tree_equal(tckpt.convert_tapnet_haiku_params(raw), jtree)
    model = tmodel.TAPNet()
    tckpt.load_tapnet_checkpoint(checkpoint, model)
    got = model.state_dict()
    ref = tckpt.tapnet_state_dict_from_jax(jtree)
    assert got.keys() == ref.keys() and len(got) == 74
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())
    bn = "tsm_resnet_video/~/tsm_resnet_unit_1/~/block_0/~/batch_norm"
    np.testing.assert_array_equal(
        got["tsm_resnet.unit1_block0.bn_pre.running_var"].numpy(),
        raw["state"][f"tap_net/~/{bn}/~/var_ema"]["average"].reshape(-1))
    assert tuple(got["cost_volume_regression_1.weight"].shape) == (16, 1, 3,
                                                                   3)


def test_temporal_shift_is_the_rolled_layout():
    x = np.arange(3 * 16 * 2 * 2, dtype=np.float32).reshape(3, 2, 2, 16)
    ref = np.asarray(jmodel.temporal_shift(jnp.asarray(x), 0.125))
    got = tmodel.temporal_shift(torch.from_numpy(x).permute(0, 3, 1, 2),
                                0.125).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[0, 0, 0, 0] == x[1, 0, 0, 14] and got[2, 0, 0, 0] == 0


@pytest.mark.parametrize("stride,shift", [(1, 0.125), (2, 0.125), (2, 0.0)])
def test_tsm_block(stride, shift):
    """A TSM basic block: inference BatchNorm, the shift on the
    pre-activation, the strided "SAME" conv, the projection shortcut."""
    rng = np.random.default_rng(stride)
    block = jmodel.TSMBasicBlockV2(output_channels=24, stride=stride,
                                   use_projection=True,
                                   shift_fraction=shift)
    params = flax_params(block, rng, (3, 16, 16, 16))
    params = jax.tree_util.tree_map(np.abs, params)  # variances > 0
    x = rng.standard_normal((3, 16, 16, 16)).astype(np.float32)
    ref = np.asarray(block.apply(params, x))
    port = tmodel.TSMBasicBlockV2(16, 24, stride, use_projection=True,
                                  shift_fraction=shift)
    port.load_state_dict(tckpt.tapnet_state_dict_from_jax(params))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=BLOCK_ATOL,
                               rtol=0)


def test_stem_max_pool_pads_with_minus_infinity():
    """flax's 3 x 3 / 2 "SAME" max-pool pads (0, 1) with -inf."""
    x = -np.abs(np.random.default_rng(0).standard_normal(
        (2, 8, 8, 3))).astype(np.float32)
    ref = np.asarray(fnn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME"))
    xt = tmodel.same_pad(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2,
                         value=float("-inf"))
    got = torch.nn.functional.max_pool2d(xt, 3, 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)


def _jax_heat_logits(m, video, query_points):
    grid = m.get_feature_grid(video)
    t, gh, gw, c = grid.shape
    n = query_points.shape[0]
    q = jax.vmap(lambda fr, x, y: jmodel.bilinear_sample(
        fr, x, y, pad_mode="clamp"))(
        grid[jnp.round(query_points[:, 0]).astype(jnp.int32)],
        query_points[:, 2] * (gw / 256) - 0.5,
        query_points[:, 1] * (gh / 256) - 0.5)
    cost = jnp.einsum("nc,thwc->tnhw", q, grid).reshape(t * n, gh, gw, 1)
    pos = m.cost_conv2(fnn.relu(m.cost_conv1(cost)))[..., 0]
    return pos.reshape(t, n, gh * gw).transpose(1, 0, 2)


def _port_heat_logits(model, video, query_points):
    grid = model.get_feature_grid(video)
    t, gh, gw, _ = grid.shape
    n = query_points.shape[0]
    q = tmodel.sample_query_features(grid, query_points)
    cost = torch.einsum("nc,thwc->tnhw", q, grid).reshape(t * n, 1, gh, gw)
    pos = model.cost_volume_regression_2(torch.relu(
        model.cost_volume_regression_1(cost)))
    return pos.reshape(t, n, gh * gw).transpose(0, 1)


def test_model_matches_jax(checkpoint):
    """The full-width model over 4 frames at 256 x 256, 8 queries."""
    rng = np.random.default_rng(6)
    video = rng.uniform(-1, 1, (4, 256, 256, 3)).astype(np.float32)
    qp = np.stack([rng.integers(0, 4, 8).astype(np.float32),
                   rng.uniform(10, 245, 8), rng.uniform(10, 245, 8)],
                  -1).astype(np.float32)
    params = jckpt.load_tapnet_checkpoint(checkpoint)
    jm = jmodel.TAPNet()
    ref = jax.jit(jm.apply)(params, video, qp)
    model = tmodel.TAPNet()
    tckpt.load_tapnet_checkpoint(checkpoint, model)
    with torch.no_grad():
        v, q = torch.from_numpy(video), torch.from_numpy(qp)
        got = model(v, q)
        heat = _port_heat_logits(model, v, q).numpy()
    assert_argmax_margins(heat, np.asarray(jax.jit(functools.partial(
        jm.apply, method=_jax_heat_logits))(params, video, qp)))
    for k in ("tracks", "occlusion"):
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, rtol=0)
    # the query frames are pinned: (t, y, x) -> tracks[t] == (x, y)
    rows = np.arange(8)
    np.testing.assert_allclose(got["tracks"].numpy()[rows, qp[:, 0].astype(
        int)], qp[:, [2, 1]], atol=1e-4)


def test_tracker_matches_jax():
    """`forward_device` against the JAX tracker's `forward` on a 4 x 96 x
    160 uint8 video with 70 queries (four 16-query chunks and one of 6,
    which JAX pads)."""
    jtracker, tracker = haiku_tracker_pair("tapnet", seed=18)
    rng = np.random.default_rng(5)
    video = smooth_video(4, 96, 160, seed=3)[None]
    n = 70
    qp = np.concatenate([rng.integers(0, 4, (n, 1)),
                         rng.uniform([2, 2], [158, 94], (n, 2))],
                        1)[None].astype(np.float32)
    ref_traj, ref_vis = jtracker.forward(video, qp)
    rgbs = torch.from_numpy(video)
    traj, vis = tracker.forward_device(rgbs, qp)
    assert traj.shape == (1, 4, n, 2) and vis.shape == (1, 4, n)
    np.testing.assert_allclose(traj.numpy(), ref_traj, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(vis.numpy(), ref_vis)
    with torch.no_grad():
        out = tracker.model.track(tracker._grid(rgbs), torch.from_numpy(
            raster_queries(qp[0], 96, 160)))
    assert_visibility_margins(not_occluded(out["occlusion"]).numpy(),
                              tracker.visibility_threshold)


def test_sam_pt_with_tapnet_matches_jax():
    """Tiny SAM + full-width TapNet: the port's device flow against the
    JAX SamPt's host flow."""
    jsampt, tsampt = tiny_sam_pt_pair(tracker="tapnet",
                                      positive_points_per_mask=3)
    video = sam_pt_video()
    jout = jsampt.forward(dict(video, keep_logits_on_device=True))
    assert_sam_pt_pair(video, jout, tsampt.forward(video))


def test_random_build_has_untrained_statistics():
    """Random weights: the BatchNorm statistics are an untrained net's
    (mean 0, variance 1), so no variance is negative."""
    tracker = TapNetPointTracker(allow_random_init=True, device="cpu")
    bn = tracker.model.tsm_resnet.unit0_block0.bn_pre
    assert torch.equal(bn.running_var, torch.ones(64))
    assert torch.equal(bn.running_mean, torch.zeros(64))
    assert not torch.equal(bn.weight, torch.ones(64))
