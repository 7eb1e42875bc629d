"""Port `SamPt`'s point re-initialisation path and query-points input
against JAX `SamPt`, on the tiny config of test_torch_sam_pt.py (same
weights, float32, the same `rng` seed on both sides).

Reinit: horizons 4 (tracker) / 3 (decode) as in tests/test_sam_pt.py, two
objects with query frames 0 and 3, so that the flipped (backward) pass and
the stitch run. A mask that differs at one boundary pixel would change the
k-medoid points drawn from it and every trajectory after it, so the tests
first assert that the masks which seed each re-initialisation agree
exactly. With the seeds of the video and the weights used here they do: no
predicted logit of those windows lies within the float16 rounding of the
decision boundary. Another seed may need checking afresh.

Tolerances as in test_torch_sam_pt.py: trajectories 1e-3 px, IoU scores
1e-4, logits 2e-2 absolute (float16 at the output, values of order 10).
"""
import numpy as np
import pytest
import torch

from sam_pt_torch.models.sam_pt import SamPt as TSamPt
from sam_pt_torch.utils.util import PointVisibilityType
from sam_pt_tpu.models.sam_pt import SamPt as JSamPt
from torch_port_helpers import tiny_sam_pt_pair

torch.set_num_threads(1)

LOGIT_ATOL = 2e-2
REINIT = dict(use_point_reinit=True, reinit_point_tracker_horizon=4,
              reinit_horizon=3, iterative_refinement_iterations=1)
VARIANTS = [
    "reinit-on-horizon-and-sync-masks",
    "reinit-at-median-of-area-diff",
    "reinit-on-similar-mask-area",
    "reinit-on-similar-mask-area-and-sync-masks",
]


def _video(t=7, h=48, w=64):
    rng = np.random.default_rng(16)
    masks = np.zeros((2, h, w), np.float32)
    masks[0, 10:25, 8:30] = 1
    masks[1, 28:45, 35:60] = 1
    return {
        "image": rng.integers(0, 255, (t, h, w, 3)).astype(np.uint8),
        "target_hw": (h, w),
        "query_masks": masks,
        "query_point_timestep": np.array([0, 3], np.float32),
    }


def _record(sampt, name):
    """Wrap `sampt.<name>` to record its arguments and result."""
    calls = []
    method = getattr(sampt, name)

    def wrapped(*args, **kwargs):
        out = method(*args, **kwargs)
        calls.append(([np.array(a) for a in args[1:3]], np.array(out)))
        return out

    setattr(sampt, name, wrapped)
    return calls


def _run_pair(**settings):
    jsampt, tsampt = tiny_sam_pt_pair(**settings)
    jcalls = _record(jsampt, "extract_query_points")
    tcalls = _record(tsampt, "extract_query_points")
    video = _video()
    jout = jsampt.forward(dict(video))
    tout = tsampt.forward(video)
    return jout, tout, jcalls, tcalls, tsampt


def _assert_outputs_match(jout, tout):
    jtraj = np.asarray(jout["trajectories"])
    np.testing.assert_allclose(tout["trajectories"].cpu().numpy(), jtraj,
                               atol=1e-3, rtol=0)
    np.testing.assert_array_equal(tout["visibilities"].cpu().numpy(),
                                  np.asarray(jout["visibilities"]))
    for key in ("scores_per_frame", "scores"):
        np.testing.assert_allclose(
            tout[key].cpu().numpy(), np.asarray(jout[key], np.float32),
            atol=1e-4, rtol=0, err_msg=key)  # NaN where both are NaN
    got = tout["logits"].float().cpu().numpy()
    ref = np.stack(jout["logits"]).astype(np.float32)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got[finite], ref[finite], atol=LOGIT_ATOL,
                               rtol=1e-3)


@pytest.fixture(scope="module")
def reinit_run():
    return _run_pair(**REINIT)


class TestReinitPath:
    def test_reinit_masks_agree_exactly(self, reinit_run):
        """The first call samples from the query masks, every later one
        from the predicted mask a re-initialisation chose."""
        _, _, jcalls, tcalls, _ = reinit_run
        assert len(jcalls) == len(tcalls) > 2
        for (jargs, jpts), (targs, tpts) in zip(jcalls, tcalls):
            np.testing.assert_array_equal(targs[0], jargs[0])  # masks
            np.testing.assert_array_equal(targs[1], jargs[1])  # frames
            np.testing.assert_array_equal(tpts, jpts)

    def test_both_directions_ran(self, reinit_run):
        *_, tsampt = reinit_run
        directions = {d for d, *_ in tsampt.reinit_windows}
        assert directions == {"forward", "backward"}

    def test_outputs(self, reinit_run):
        jout, tout, *_ = reinit_run
        assert tout["trajectories"].shape == (7, 2, 5, 2)
        assert np.isfinite(tout["trajectories"].numpy()).all()
        _assert_outputs_match(jout, tout)

    def test_fail_on_empty_reinit_mask(self):
        """An IoU gate no mask passes leaves every predicted mask empty, so
        every re-initialisation fails: REINIT_FAILED past the first window
        of each mask, -72 trajectories, -inf logits; the same on both
        sides."""
        jout, tout, jcalls, tcalls, _ = _run_pair(
            sam_iou_threshold=2.0, fail_on_empty_reinit_mask=True, **REINIT)
        assert len(jcalls) == len(tcalls) == 1  # the query masks only
        _assert_outputs_match(jout, tout)
        vis = tout["visibilities"].numpy()
        failed = float(PointVisibilityType.REINIT_FAILED)
        assert (vis[3:, 0] == failed).all()  # mask 0: window [0, 3)
        assert (tout["trajectories"].numpy()[3:, 0] == -72).all()
        assert torch.isneginf(tout["logits"]).all()


class TestChooseReinitTimestep:
    @pytest.mark.parametrize("variant", VARIANTS)
    def test_variant(self, variant):
        rng = np.random.default_rng(21)
        area = rng.integers(20, 400, (3, 8)).astype(np.float64)
        area[area <= 60] = np.nan
        area[0, :2] = np.nan
        area[1, :] = np.nan  # no candidate at all
        area[2, 3] = area[2, 5]  # a tie
        pred = rng.random((3, 9, 6, 7)) > 0.5
        current_ts = np.array([4, 4, 7])
        for start in (4, 0):
            picks = [cls(None, None, reinit_variant=variant, reinit_horizon=6,
                         reinit_point_tracker_horizon=6)
                     ._choose_reinit_timestep(area.copy(), pred, current_ts,
                                              start)
                     for cls in (JSamPt, TSamPt)]
            np.testing.assert_array_equal(picks[1], picks[0])
            assert picks[1].dtype == np.int64


class TestHostPrompts:
    def test_capped_other_object_points(self):
        """`max_other_objects_positive_points` subsamples the visible
        positives of the other objects with `self.rng`: with the same seed
        both sides draw the same points."""
        rng = np.random.default_rng(22)
        t, m, p = 3, 3, 5
        traj = rng.uniform(0, 60, (t, m, p, 2)).astype(np.float32)
        vis = (rng.random((t, m, p)) > 0.3).astype(np.float32)
        settings = dict(positive_points_per_mask=4,
                        add_other_objects_positive_points_as_negative_points=True,
                        max_other_objects_positive_points=3, seed=5)
        jpts, jlbl = JSamPt(None, None, **settings)._build_prompts(traj, vis)
        tpts, tlbl = TSamPt(None, None, **settings)._build_prompts(traj, vis)
        np.testing.assert_array_equal(tpts, jpts)
        np.testing.assert_array_equal(tlbl, jlbl)
        assert tlbl.shape == (t, m, p + 3)


class TestQueryPoints:
    def test_query_points_input(self):
        """17 query points of one object on frame 0 (the JAX package's
        device flow on its side): the query masks SAM decodes from them,
        and the outputs."""
        jsampt, tsampt = tiny_sam_pt_pair()
        jmasks = _record(jsampt, "extract_query_masks")
        tmasks = _record(tsampt, "extract_query_masks")
        rng = np.random.default_rng(24)  # a non-empty mask, of ~1300 px
        points = np.concatenate(
            [np.zeros((1, 17, 1)), rng.uniform([35, 28], [60, 45], (1, 17, 2))],
            axis=2).astype(np.float32)
        video = dict(_video(t=5))
        del video["query_masks"], video["query_point_timestep"]
        video["query_points"] = points
        jout = jsampt.forward(dict(video, keep_logits_on_device=True))
        tout = tsampt.forward(video)
        assert len(jmasks) == len(tmasks) == 1
        tmask, jmask = tmasks[0][1], jmasks[0][1]
        assert tmask.shape == (1, 48, 64) and tmask.any()
        np.testing.assert_array_equal(tmask, jmask)
        assert tout["trajectories"].shape == (5, 1, 17, 2)
        jout = dict(jout, logits=list(np.asarray(jout["logits"])))
        _assert_outputs_match(jout, tout)
