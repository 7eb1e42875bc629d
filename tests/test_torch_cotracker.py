"""Port CoTracker against the JAX package's on a tiny config, same weights
(a random CoTracker v1 state dict through the JAX converter), in float32;
the window model's CUDA graphs (`cotracker/graphs.py`) against its eager
call.

The random update head moves points by small steps (its coordinate rows
are scaled by 0.05): with full-size random rows the untrained tracker is
chaotic, and float32 rounding differences grow by ~20x per window.

Tolerances: 2e-4 on feature maps of order 1-10 (float32 summation order
through the conv stack). The window model gets 5e-4 after two
iterations: flax's LayerNorm takes the variance as E[x^2] - E[x]^2, whose
float32 cancellation leaves ~1e-5 relative error on the JAX side, and the
model's measured response to a 1e-5 relative input change is 2e-4. The
tracker runs one iteration per window (the schedule is what it tests) and
gets 1e-4 on trajectories of order 10-100 pixels.

The JAX side is imported by the `jx` fixture, so that the tests marked
`cuda` run where jax is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cotracker.py
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sam_pt_torch.models.tracker.cotracker import graphs
from sam_pt_torch.models.tracker.cotracker.model import CoTracker as TCoTracker
from sam_pt_torch.models.tracker.cotracker.tracker import (
    CoTrackerPointTracker as TTracker,
)
from torch_port_helpers import (
    TINY_COTRACKER,
    random_cotracker_state_dict,
    torch_sd,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from sam_pt_tpu.models.tracker.cotracker.model import CoTracker
    from sam_pt_tpu.models.tracker.cotracker.tracker import (
        CoTrackerPointTracker,
    )
    from sam_pt_tpu.utils.checkpoint import convert_cotracker_state_dict
    return SimpleNamespace(jax=jax, jnp=jnp, CoTracker=CoTracker,
                           Tracker=CoTrackerPointTracker,
                           convert=convert_cotracker_state_dict)


@pytest.fixture(scope="module")
def tiny_sd():
    return random_cotracker_state_dict(seed=13, flow_head_scale=0.05,
                                       **TINY_COTRACKER)


@pytest.fixture(scope="module")
def tmodel(tiny_sd):
    model = TCoTracker(**TINY_COTRACKER)
    model.load_state_dict(torch_sd(tiny_sd))
    return model.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def weights(jx, tiny_sd, tmodel):
    return jx.convert(tiny_sd), tmodel


def _tracker_kwargs():
    return dict(interp_shape=(32, 40), visibility_threshold=0.5,
                support_grid_size=2, support_grid_every_n_frames=6, iters=1)


class TestModel:
    def test_encoder_and_window(self, jx, weights):
        jnp = jx.jnp
        params, tmodel = weights
        jmodel = jx.CoTracker(**TINY_COTRACKER)
        rng = np.random.default_rng(14)
        rgbs = rng.uniform(0, 255, (4, 32, 40, 3)).astype(np.float32)
        ref_f = jmodel.apply(params, jnp.asarray(rgbs),
                             method=jx.CoTracker.encode_frames)
        with torch.no_grad():
            got_f = tmodel.encode_frames(torch.from_numpy(rgbs))
        np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f),
                                   atol=2e-4, rtol=0)

        fmaps = np.array(ref_f)
        coords = rng.uniform(0, 9, (4, 3, 2)).astype(np.float32)
        feats = rng.standard_normal((3, 16)).astype(np.float32)
        tm = np.array([[1, 1, 0], [1, 1, 1], [1, 1, 1], [1, 1, 1]],
                      np.float32)
        vis_init = rng.standard_normal((4, 3)).astype(np.float32)
        active = np.array([True, True, False])
        ref = jmodel.apply(params, jnp.asarray(fmaps), jnp.asarray(coords),
                           jnp.asarray(feats), jnp.asarray(tm), iters=2,
                           vis_init=jnp.asarray(vis_init),
                           active=jnp.asarray(active))
        with torch.no_grad():
            got = tmodel(torch.from_numpy(fmaps), torch.from_numpy(coords),
                         torch.from_numpy(feats), torch.from_numpy(tm),
                         iters=2, vis_init=torch.from_numpy(vis_init),
                         active=torch.from_numpy(active))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-4,
                                       rtol=0)


class TestTracker:
    def test_forward_with_backward_merge(self, jx, weights):
        """9 frames (three overlapping windows of 4, the last overrunning),
        queries on frames 0, 3 and 8 (so the backward pass fills frames
        before them), support grid every 6 frames."""
        params, tmodel = weights
        jtr = jx.Tracker(params=params, **_tracker_kwargs(), s=4, stride=4)
        jtr.model = jx.CoTracker(**TINY_COTRACKER)
        ttr = TTracker(model=tmodel, **_tracker_kwargs())

        rng = np.random.default_rng(15)
        rgbs = rng.integers(0, 255, (1, 9, 48, 64, 3)).astype(np.uint8)
        qp = np.array([[[0, 5.0, 6.0], [3, 20.0, 15.0], [8, 40.0, 25.0]]],
                      np.float32)
        ref_t, ref_v = jtr.forward_device(jx.jax.device_put(rgbs), qp)
        got_t, got_v = ttr.forward_device(torch.from_numpy(rgbs), qp)
        np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t),
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))


def _window_inputs(rng, fmaps_shape, n, s, inactive):
    """One window's inputs over `n` tracks (the tracks in `inactive` not
    yet started), as `_track` makes them, as float32 tensors."""
    t, h8, w8, c = fmaps_shape
    fmaps = torch.from_numpy(
        rng.standard_normal(fmaps_shape).astype(np.float32))
    frames = torch.from_numpy(rng.integers(0, t, s))
    coords = torch.from_numpy(rng.uniform(
        0, [w8 - 1, h8 - 1], (s, n, 2)).astype(np.float32))
    feats = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32))
    tm = torch.from_numpy((rng.uniform(size=(s, n)) > 0.3).astype(np.float32))
    vis = torch.from_numpy(rng.standard_normal((s, n)).astype(np.float32))
    active = torch.ones(n, dtype=torch.bool)
    active[list(inactive)] = False
    return fmaps, frames, coords, feats, tm, vis, active


class TestWindowBuckets:
    @pytest.mark.parametrize("n, padded", [(1, 16), (16, 16), (17, 32),
                                           (79, 80)])
    def test_bucket_rule(self, n, padded):
        assert graphs.bucket_tracks(n) == padded

    @pytest.mark.parametrize("n, padded", [(21, 32), (33, 48)])
    def test_padded_window_matches_unpadded(self, tmodel, n, padded):
        """The window model over the bucket's padded inputs gives the real
        tracks the coordinates, visibility logits and features of the
        unpadded call; a few tracks are inactive (masked keys). One
        refinement iteration: the padded softmax sums its exact zeros in
        another order, a last-bit difference that each further iteration
        of the random tiny model amplifies some 40 times."""
        s = TINY_COTRACKER["s"]
        rng = np.random.default_rng(n)
        args = _window_inputs(rng, (6, 8, 10, 16), n, s, inactive=(0, 5, n - 1))
        fmaps, frames, coords, feats, tm, vis, active = args
        inputs = graphs.WindowInputs(*args, graphs.bucket_tracks(n))
        inputs.fill(*args)
        assert inputs.coords.shape == (s, padded, 2)
        assert not inputs.active[n:].any()
        with torch.no_grad():
            want = tmodel(fmaps[frames], coords, feats, tm, iters=1,
                          vis_init=vis, active=active)
            got = inputs.run(tmodel, iters=1)
        for g, w in zip(got, want):
            torch.testing.assert_close(g[:, :n], w, atol=1e-5, rtol=0)

    def test_fill_clears_what_more_tracks_left(self, tmodel):
        """A window of 25 tracks after one of 30 in the same bucket: the
        five tracks the first wrote behind the 25 are zero and inactive
        again, so the padded call still gives the unpadded one's result."""
        s = TINY_COTRACKER["s"]
        rng = np.random.default_rng(4)
        more = _window_inputs(rng, (6, 8, 10, 16), 30, s, inactive=(3,))
        fewer = _window_inputs(rng, (6, 8, 10, 16), 25, s, inactive=(7,))
        inputs = graphs.WindowInputs(*more, graphs.bucket_tracks(30))
        inputs.fill(*more)
        inputs.fill(*fewer)
        for buf in (inputs.coords, inputs.track_mask, inputs.vis):
            assert not buf[:, 25:].any()
        assert not inputs.feats[25:].any() and not inputs.active[25:].any()
        fmaps, frames, coords, feats, tm, vis, active = fewer
        with torch.no_grad():
            want = tmodel(fmaps[frames], coords, feats, tm, iters=1,
                          vis_init=vis, active=active)
            got = inputs.run(tmodel, iters=1)
        for g, w in zip(got, want):
            torch.testing.assert_close(g[:, :25], w, atol=1e-5, rtol=0)

    def test_runner_off_cuda_is_the_model(self, tmodel):
        """Off CUDA the runner is the eager call, bit for bit, and captures
        and replays nothing."""
        s = TINY_COTRACKER["s"]
        args = _window_inputs(np.random.default_rng(3), (6, 8, 10, 16), 9, s,
                              inactive=(2,))
        fmaps, frames, coords, feats, tm, vis, active = args
        runner = graphs.WindowGraphs()
        with torch.no_grad():
            got = runner(tmodel, *args, iters=2)
            want = tmodel(fmaps[frames], coords, feats, tm, iters=2,
                          vis_init=vis, active=active)
        for g, w in zip(got, want[:2]):
            assert torch.equal(g, w)
        assert (runner.captures, runner.replays) == (0, 0)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def main_model(card):
    """CoTracker v1 at its published widths, bf16 on the card."""
    model = TCoTracker(s=8, stride=4)
    model.load_state_dict(torch_sd(random_cotracker_state_dict(
        seed=13, flow_head_scale=0.05)))
    return model.to(card, torch.bfloat16).eval().requires_grad_(False)


def _eager_windows(model, fmaps, frames, coords_init, feats, track_mask,
                   vis_init, active, iters):
    coords, vis, _ = model(fmaps[frames], coords_init, feats, track_mask,
                           iters=iters, vis_init=vis_init, active=active)
    return coords, vis


@pytest.mark.cuda
class TestWindowGraphsCard:
    def test_replays_equal_eager_at_the_padded_shape(self, card, main_model):
        """Consecutive windows with new inputs, two in one bucket and one in
        the next, then the first bucket again: each replay equals the
        eager call on the same padded inputs bit for bit (a stale static
        buffer would not)."""
        runner = graphs.WindowGraphs()
        rng = np.random.default_rng(7)
        fmaps_shape = (12, 96, 128, 128)
        for n in (21, 30, 40, 25):
            args = [a.to(card) for a in _window_inputs(
                rng, fmaps_shape, n, 8, inactive=(1, n - 2))]
            args[0] = args[0].bfloat16()
            with torch.no_grad():
                coords, vis = runner(main_model, *args, iters=6)
                coords, vis = coords.clone(), vis.clone()
                inputs = graphs.WindowInputs(*args, graphs.bucket_tracks(n))
                inputs.fill(*args)
                want = inputs.run(main_model, iters=6)
            assert torch.equal(coords, want[0][:, :n]), n
            assert torch.equal(vis, want[1][:, :n]), n
        assert (runner.captures, runner.replays) == (2, 4)

    def test_tracker_matches_eager_and_counts(self, card, main_model):
        """A whole `forward_device` (forward, backward, merge) within the
        benchmark's `track_px` limit of the eager tracker, its visibilities
        the same but at a few points; one capture for the video's bucket,
        a replay a window (in the tracer's `track.window` spans too), and
        no capture for a second video in the same bucket."""
        from sam_pt_torch.utils import tracing

        kwargs = dict(model=main_model, interp_shape=(384, 512), iters=6)
        tracker, eager = TTracker(**kwargs), TTracker(**kwargs)
        eager.windows = _eager_windows
        rng = np.random.default_rng(8)

        def video(t, n_points):
            rgbs = torch.from_numpy(rng.integers(
                0, 255, (1, t, 480, 854, 3)).astype(np.uint8)).to(card)
            qp = np.concatenate([
                rng.integers(0, t, (1, n_points, 1)),
                rng.uniform(0, [854, 480], (1, n_points, 2))], -1)
            return rgbs, qp.astype(np.float32)

        rgbs, qp = video(20, 13)  # 13 + 2 x 4 support points: bucket 32
        tracing.enable()
        try:
            traj, vis = tracker.forward_device(rgbs, qp)
            spans = [sp for sp in tracing.export()
                     if sp["name"] == "track.window"]
        finally:
            tracing.disable()
        ref_traj, ref_vis = eager.forward_device(rgbs, qp)
        windows = 2 * len(range(0, 20 - 4, 4))
        assert (tracker.windows.captures, tracker.windows.replays) == (
            1, windows)
        assert len(spans) == windows
        assert sum(sp["counts"].get("graph_replays", 0)
                   for sp in spans) == windows
        assert sum(sp["counts"].get("graph_captures", 0)
                   for sp in spans) == 1
        px = (traj - ref_traj).norm(dim=-1).median()
        assert px <= 2.0, px
        assert (vis != ref_vis).float().mean() <= 0.01

        rgbs, qp = video(30, 15)  # 15 + 3 x 4 support points: bucket 32
        tracker.forward_device(rgbs, qp)
        windows += 2 * len(range(0, 30 - 4, 4))
        assert (tracker.windows.captures, tracker.windows.replays) == (
            1, windows)
