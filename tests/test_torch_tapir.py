"""TAPIR in the port (`sam_pt_torch/models/tracker/tapir/`) against the JAX
package's, in float32, on the same random haiku checkpoint
(`torch_port_helpers.random_tapir_haiku_params`, the published widths,
written as an .npy and read by each side's own reader).

Tolerances: conv / norm / mixer blocks 1e-4 (float32 summation order);
whole-model tracks 1e-3 raster px and occlusion / expected-distance logits
1e-3; the tracker's trajectories 1e-3 px with equal visibilities; the
SamPt pair as test_torch_default_model.py (trajectories 1e-3 px, IoU scores
1e-4, float16 logits 2e-2). The truncated soft-argmax and the visibility
threshold are discontinuous, so the tests assert their margins on their
own inputs: the two largest heatmap logits of every (query, frame) lie
further apart than the two sides' logits differ, and no visibility score
lies within 1e-3 of the threshold. The JAX model runs under `jax.jit`
(on the CPU one compile of the full-width model takes less time than one
call without it), at as few shapes as the cases allow.
"""
import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_pt_torch import build
from sam_pt_torch.models.tracker.tapir import model as tmodel
from sam_pt_torch.models.tracker.tapir.tracker import (
    OnlineTapirPointTracker, TapirPointTracker, not_occluded, prepare_frames,
    raster_queries)
from sam_pt_torch.utils import checkpoint as tckpt
from sam_pt_tpu.models.tracker.tapir import model as jmodel
from sam_pt_tpu.models.tracker.tapir.tracker import (
    OnlineTapirPointTracker as JOnline)
from sam_pt_tpu.models.tracker.tapir.tracker import (
    _resize_norm_dev as j_prepare)
from sam_pt_tpu.utils import checkpoint as jckpt
from torch_port_helpers import (
    assert_argmax_margins, assert_sam_pt_pair, assert_visibility_margins,
    flax_params, haiku_tracker_pair, random_tapir_haiku_params, sam_pt_video,
    save_npy, smooth_video, tiny_sam_pt_pair, tree_equal)

torch.set_num_threads(1)

ATOL = 1e-3
BLOCK_ATOL = 1e-4


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The .npy of each pyramid level (486- and 535-wide mixer input)."""
    folder = tmp_path_factory.mktemp("tapir")
    return {p: save_npy(folder / f"tapir_p{p}.npy",
                        random_tapir_haiku_params(seed=30 + p,
                                                  pyramid_level=p))
            for p in (0, 1)}


@pytest.fixture(scope="module")
def pair():
    """(JAX, port) trackers on one checkpoint (seed 18, pyramid level 1);
    the JAX one's jitted forward compiles once a shape for every test."""
    return haiku_tracker_pair("tapir", seed=18)


def _port_model(path, **kwargs):
    model = tmodel.TAPIR(**kwargs)
    tckpt.load_tapir_checkpoint(path, model)
    return model.eval().requires_grad_(False)


@pytest.mark.parametrize("level", [0, 1])
def test_converter_copy_and_state_dict(checkpoints, level):
    """The port's copy of the haiku key map gives the JAX converter's
    tree; the port's model loads it whole, as the JAX tree converts."""
    path = checkpoints[level]
    hk = tckpt.load_haiku_npy(path)
    tree_equal(hk, jckpt.load_haiku_npy(path))
    jtree = jckpt.load_tapir_checkpoint(path)
    tree_equal(tckpt.convert_tapir_haiku_params(hk), jtree)
    got = _port_model(path, pyramid_level=level).state_dict()
    ref = tckpt.tapir_state_dict_from_jax(jtree)
    assert got.keys() == ref.keys() and len(got) == 188
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())
    width = 4 + 384 + (2 + level) * 49
    assert tuple(got["pips_mixer.input_proj.weight"].shape) == (512, width)


def test_a_535_wide_model_refuses_a_486_wide_checkpoint(checkpoints):
    with pytest.raises(ValueError, match=r"pips_mixer\.input_proj\.weight: "
                       r"\(512, 486\) in the file, \(512, 535\)"):
        TapirPointTracker(checkpoint_path=checkpoints[0], device="cpu")
    assert TapirPointTracker(checkpoint_path=checkpoints[1],
                             device="cpu").model.pyramid_level == 1


@pytest.mark.parametrize("n,k,stride", [(256, 7, 2), (128, 3, 2), (64, 3, 2),
                                        (32, 3, 2), (33, 3, 2), (32, 3, 1)])
def test_same_padding_is_flax(n, k, stride):
    """flax "SAME" at stride 2 pads the smaller half first: (2, 3) for the
    7 x 7 stem at 256, (0, 1) for 3 x 3 at even sizes."""
    rng = np.random.default_rng(n + k)
    conv = fnn.Conv(4, (k, k), strides=(stride, stride), padding="SAME")
    params = flax_params(conv, rng, (1, n, n, 3))
    x = rng.standard_normal((2, n, n, 3)).astype(np.float32)
    ref = np.asarray(conv.apply(params, x))
    port = tmodel.SameConv2d(3, 4, k, stride)
    port.load_state_dict(tckpt.tapir_state_dict_from_jax(params))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=BLOCK_ATOL,
                               rtol=0)
    if (n, k, stride) == (256, 7, 2):
        padded = tmodel.same_pad(torch.zeros(1, 1, n, n), k, stride)
        assert padded.shape[-2:] == (n + 5, n + 5)


@pytest.mark.parametrize("stride", [1, 2])
def test_block_v2_and_instance_norm(stride):
    rng = np.random.default_rng(stride)
    block = jmodel.BlockV2(channels=24, stride=stride, use_projection=True)
    params = flax_params(block, rng, (1, 16, 16, 8))
    x = rng.standard_normal((3, 16, 16, 8)).astype(np.float32) * 2 + 0.5
    ref = np.asarray(block.apply(params, x))
    port = tmodel.BlockV2(8, 24, stride, use_projection=True)
    port.load_state_dict(tckpt.tapir_state_dict_from_jax(params))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=BLOCK_ATOL,
                               rtol=0)
    scale = rng.standard_normal(8).astype(np.float32)
    offset = rng.standard_normal(8).astype(np.float32)
    ref = np.asarray(jmodel.affine_instance_norm(x, scale, offset))
    got = tmodel.affine_instance_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(scale),
        torch.from_numpy(offset)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=BLOCK_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_mixer_block(causal):
    """One PIPsConvBlock (the interleaved depthwise convs, tanh GELU,
    scale-only LayerNorms); causal: the context handed in and out."""
    rng = np.random.default_rng(7)
    c = 16
    block = jmodel.PIPsConvBlock(use_causal_conv=causal)
    params = flax_params(block, rng, (2, 5, c))
    port = tmodel.PIPsConvBlock(c, use_causal_conv=causal)
    port.load_state_dict(tckpt.tapir_state_dict_from_jax(params))
    x = rng.standard_normal((3, 5, c)).astype(np.float32)
    ctx = None
    if causal:
        ctx = {"causal_1": rng.standard_normal((3, 2, c)).astype(np.float32),
               "causal_2": rng.standard_normal((3, 2, 4 * c)).astype(
                   np.float32)}
    ref, ref_ctx = block.apply(params, x, ctx, causal)
    got, got_ctx = port(torch.from_numpy(x), None if ctx is None else {
        k: torch.from_numpy(v) for k, v in ctx.items()}, causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=BLOCK_ATOL, rtol=0)
    assert got_ctx.keys() == ref_ctx.keys()
    for k in ref_ctx:
        np.testing.assert_allclose(got_ctx[k].detach().numpy(),
                                   np.asarray(ref_ctx[k]), atol=BLOCK_ATOL,
                                   rtol=0)


def _jax_heat_logits(m, video, query_points=None, q_lo=None):
    """The JAX model's cost-volume logits [N, T, h * w] (what the
    truncated soft-argmax takes the argmax of), for the query points'
    features or `q_lo`."""
    hires, lowres = m.get_feature_grids(video)
    if q_lo is None:
        _, q_lo = m.get_query_features(hires, lowres, query_points)
    t, h, w, _ = lowres.shape
    n = q_lo.shape[0]
    cost = jnp.einsum("nc,thwc->tnhw", q_lo, lowres).reshape(t * n, h, w, 1)
    pos = m.cost_conv2(fnn.relu(m.cost_conv1(cost)))[..., 0]
    return pos.reshape(t, n, h * w).transpose(1, 0, 2)


def _port_heat_logits(model, video, query_points=None, q_lo=None):
    hires, lowres = model.get_feature_grids(video)
    if q_lo is None:
        _, q_lo = model.get_query_features(hires, lowres, query_points)
    t, h, w, _ = lowres.shape
    n = q_lo.shape[0]
    cost = torch.einsum("nc,thwc->tnhw", q_lo, lowres)
    pos = model.cost_volume_regression_2(torch.relu(
        model.cost_volume_regression_1(cost.reshape(t * n, 1, h, w))))
    return pos.reshape(t, n, h * w).transpose(0, 1)


def _inputs(t, n, seed):
    rng = np.random.default_rng(seed)
    video = rng.uniform(-1, 1, (t, 256, 256, 3)).astype(np.float32)
    qp = np.stack([rng.integers(0, t, n).astype(np.float32),
                   rng.uniform(10, 245, n), rng.uniform(10, 245, n)],
                  -1).astype(np.float32)
    return video, qp


@pytest.mark.parametrize("level", [0, 1])
def test_model_matches_jax(checkpoints, pair, level):
    """The full-width model (ResNet, cost volume, 4 passes of the
    12-block mixer) over 4 frames at 256 x 256, 8 queries; level 1 on
    the trackers' weights, through the JAX tracker's jitted forward."""
    video, qp = _inputs(4, 8, seed=level)
    if level:
        jtracker, tracker = pair
        jm, params, forward = (jtracker.model, jtracker.params,
                               jtracker._forward_jit)
        model = tracker.model
    else:
        params = jckpt.load_tapir_checkpoint(checkpoints[level])
        jm = jmodel.TAPIR(pyramid_level=level)
        forward = jax.jit(jm.apply)
        model = _port_model(checkpoints[level], pyramid_level=level)
    ref = forward(params, video, qp)
    with torch.no_grad():
        v, q = torch.from_numpy(video), torch.from_numpy(qp)
        got = model(v, q)
        heat = _port_heat_logits(model, v, q).numpy()
    assert_argmax_margins(heat, np.asarray(jax.jit(functools.partial(
        jm.apply, method=_jax_heat_logits))(params, video, qp)))
    for k in ("tracks", "occlusion", "expected_dist"):
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, rtol=0)


# The online test's causal model: the published widths, the mixer cut to 2
# blocks and 2 passes (the full depth is the model tests' and the card's;
# its compile under jit costs more than the rest of this file).
ONLINE_DEPTH = dict(num_mixer_blocks=2, num_pips_iter=2)


def test_online_tracker_streams_as_jax_and_as_its_causal_pass(tmp_path):
    """`OnlineTapirPointTracker` (the causal model, the query features from
    the query frame, then one frame at a time with the carried context)
    over a 4 x 96 x 160 video: equal to the JAX tracker streamed the same
    way, and its steps' outputs to the port's own causal pass over the
    frames at once."""
    path = save_npy(tmp_path / "tapir_causal.npy",
                    random_tapir_haiku_params(seed=33, **ONLINE_DEPTH))
    video = smooth_video(4, 96, 160, seed=4)
    xy = np.random.default_rng(4).uniform([4, 4], [156, 92], (8, 2))
    jtracker = JOnline(checkpoint_path=path)
    jtracker.model = jmodel.TAPIR(use_causal_conv=True, **ONLINE_DEPTH)
    tracker = OnlineTapirPointTracker(allow_random_init=True, device="cpu")
    tracker.model = _port_model(path, use_causal_conv=True, **ONLINE_DEPTH)
    jtracker.init_tracking(video[0], xy)
    tracker.init_tracking(video[0], xy)
    steps = []
    real_step = tracker.model.online_step

    def recording_step(*args):
        out = real_step(*args)
        steps.append(out[0])
        return out

    tracker.model.online_step = recording_step
    for frame in video[1:]:
        ref_xy, ref_vis = jtracker.track_frame(frame)
        got_xy, got_vis = tracker.track_frame(frame)
        np.testing.assert_allclose(got_xy, ref_xy, atol=ATOL, rtol=0)
        np.testing.assert_array_equal(got_vis, ref_vis)
    q_hi, q_lo = tracker._queries
    frames = prepare_frames(torch.from_numpy(video[1:]))
    with torch.no_grad():
        whole, _ = real_step(frames, q_hi, q_lo)
        heat = _port_heat_logits(tracker.model, frames, q_lo=q_lo).numpy()
    jheat = jax.jit(functools.partial(
        jtracker.model.apply, method=_jax_heat_logits))(
        jtracker.params, j_prepare(jnp.asarray(video[1:]), (256, 256)),
        q_lo=jtracker._queries[1])
    assert_argmax_margins(heat, np.asarray(jheat))
    scores = not_occluded(whole["occlusion"]) * not_occluded(
        whole["expected_dist"])
    assert_visibility_margins(scores.numpy(), tracker.visibility_threshold)
    for k in whole:
        np.testing.assert_allclose(
            torch.cat([out[k] for out in steps], dim=1).numpy(),
            whole[k].numpy(), atol=ATOL, rtol=0)


def test_tracker_matches_jax(pair):
    """`forward_device` against the JAX tracker's `forward` on a 4 x 96 x
    160 uint8 video with 70 queries on all frames (a 64-query chunk and a
    last one of 6, which JAX pads)."""
    jtracker, tracker = pair
    rng = np.random.default_rng(8)
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
    assert 0.05 < ref_vis.mean() < 0.95
    with torch.no_grad():  # the scores behind `vis`, from the cached pyramid
        q = torch.from_numpy(raster_queries(qp[0], 96, 160))
        out = tracker.model.track(tracker._pyramid(rgbs), q)
    assert_visibility_margins(
        (not_occluded(out["occlusion"]) * not_occluded(
            out["expected_dist"])).numpy(), tracker.visibility_threshold)


def test_sam_pt_with_tapir_matches_jax(pair):
    """Tiny SAM + full-width TAPIR: the port's device flow against the JAX
    SamPt's host flow (TAPIR has no `forward_device` there)."""
    jsampt, tsampt = tiny_sam_pt_pair(trackers=pair,
                                      positive_points_per_mask=3)
    video = sam_pt_video()
    jout = jsampt.forward(dict(video, keep_logits_on_device=True))
    assert_sam_pt_pair(video, jout, tsampt.forward(video))
    vis = np.asarray(jout["visibilities"])
    assert (vis == 1).any() and (vis == 0).any()


@pytest.mark.parametrize("name", ["tapir", "tapnet"])
def test_build_sam_pt_with_the_tracker(name):
    """`build_sam_pt(sam="vit_b", tracker=...)`: the tracker as its YAML
    sets it, float32, random weights from `seed + 1`."""
    sam_pt = build.build_sam_pt("cpu", sam="vit_b", tracker=name,
                                **build.DEFAULT_SETTINGS)
    tracker = sam_pt.point_tracker
    assert type(tracker).__name__ == {"tapir": "TapirPointTracker",
                                      "tapnet": "TapNetPointTracker"}[name]
    assert (tracker.visibility_threshold, tracker.query_chunk_size) == {
        "tapir": (0.1, 64), "tapnet": (0.5, 16)}[name]
    p = next(tracker.model.parameters())
    assert p.dtype == torch.float32 and p.device.type == "cpu"
    assert len(sam_pt.sam_predictor.model.image_encoder.blocks) == 12


@pytest.mark.parametrize("name", ["tapir", "tapnet"])
def test_time_parallel_builds_and_tracks(name):
    """`time_parallel=True` in one process: the frames split over a world
    of one (the sharded code path, its halos zero, its psums the
    identity) track as the unsharded tracker does, bit for bit."""
    from sam_pt_torch.models.tracker import TRACKER_REGISTRY

    rgbs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 255, (1, 3, 32, 40, 3)).astype(np.uint8))
    q = np.array([[[0, 10.0, 12.0], [2, 30.0, 20.0]]], np.float32)
    outs = []
    for parallel in (False, True):
        tracker = TRACKER_REGISTRY[name](allow_random_init=True,
                                         time_parallel=parallel, seed=5,
                                         device="cpu")
        outs.append(tracker.forward(rgbs, q))
    assert tracker.time_parallel and tracker.mesh.size == 1
    for got, ref in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["tapir", "tapnet"])
def test_standalone_demo_runs_on_the_cpu(name, tmp_path, capsys):
    """The demo over 4 tiny PNG frames and a query file of two masks."""
    from sam_pt_torch.models.tracker.standalone_demo import run
    from sam_pt_torch.vos_eval.data.image_io import write_png

    rng = np.random.default_rng(2)
    os.makedirs(tmp_path / "frames")
    for t in range(4):
        write_png(str(tmp_path / "frames" / f"{t:05d}.png"),
                  rng.integers(0, 255, (40, 64, 3)).astype(np.uint8))
    (tmp_path / "points.txt").write_text("2\n0 ; 10,10 30,20\n2 ; 40,30 "
                                         "50,12\n")
    out = run(name, ["--frames", str(tmp_path / "frames"), "--query-points",
                     str(tmp_path / "points.txt"), "--frame-stride", "1",
                     "--longest-side", "64", "--out", str(tmp_path / "out"),
                     "--device", "cpu"])
    assert out["trajectories"].shape == (4, 4, 2)
    assert out["visibilities"].shape == (4, 4) and out["fps"] > 0
    if name == "tapnet":  # TapNet pins each query's own frame
        np.testing.assert_allclose(out["trajectories"][0, :2],
                                   [[10, 10], [30, 20]], atol=1e-4)
    assert "frames/s" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["tapir", "tapnet"])
def test_composed_config_builds_the_port_tracker(name):
    """`model/point_tracker=<name>` composes the port's tracker, on `cuda`
    unless `device` says otherwise; its checkpoint is missing here, so it
    needs `allow_random_init`."""
    from sam_pt_torch.config import compose, instantiate
    from sam_pt_torch.config import resolve_interpolations
    from sam_pt_torch.vos_eval.eval import CONFIG_DIR

    def node(*overrides):
        return resolve_interpolations(compose(
            CONFIG_DIR, "vos_eval_root",
            [f"model/point_tracker={name}", *overrides]),
            runtime_cwd=os.getcwd())["model"]["point_tracker"]

    assert node()["device"] == "cuda"
    assert node()["checkpoint_path"].endswith(".npy")
    with pytest.raises(FileNotFoundError):
        instantiate(node("device=cpu"))
    with pytest.warns(UserWarning, match="random weights"):
        tracker = instantiate(node(
            "device=cpu", "model.point_tracker.allow_random_init=true"))
    assert type(tracker).__module__ == (
        f"sam_pt_torch.models.tracker.{name}.tracker")
    assert next(tracker.model.parameters()).device.type == "cpu"
