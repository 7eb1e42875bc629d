"""Port CoTracker against the JAX package's on a tiny config, same weights
(a random CoTracker v1 state dict through the JAX converter), in float32.

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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_pt_torch.models.tracker.cotracker.model import CoTracker as TCoTracker
from sam_pt_torch.models.tracker.cotracker.tracker import (
    CoTrackerPointTracker as TTracker,
)
from sam_pt_tpu.models.tracker.cotracker.model import CoTracker as JCoTracker
from sam_pt_tpu.models.tracker.cotracker.tracker import (
    CoTrackerPointTracker as JTracker,
)
from sam_pt_tpu.utils.checkpoint import convert_cotracker_state_dict
from torch_port_helpers import (
    TINY_COTRACKER,
    random_cotracker_state_dict,
    torch_sd,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    sd = random_cotracker_state_dict(seed=13, flow_head_scale=0.05,
                                     **TINY_COTRACKER)
    params = convert_cotracker_state_dict(sd)
    tmodel = TCoTracker(**TINY_COTRACKER)
    tmodel.load_state_dict(torch_sd(sd))
    return params, tmodel.eval().requires_grad_(False)


def _tracker_kwargs():
    return dict(interp_shape=(32, 40), visibility_threshold=0.5,
                support_grid_size=2, support_grid_every_n_frames=6, iters=1)


class TestModel:
    def test_encoder_and_window(self, weights):
        params, tmodel = weights
        jmodel = JCoTracker(**TINY_COTRACKER)
        rng = np.random.default_rng(14)
        rgbs = rng.uniform(0, 255, (4, 32, 40, 3)).astype(np.float32)
        ref_f = jmodel.apply(params, jnp.asarray(rgbs),
                             method=JCoTracker.encode_frames)
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
    def test_forward_with_backward_merge(self, weights):
        """9 frames (three overlapping windows of 4, the last overrunning),
        queries on frames 0, 3 and 8 (so the backward pass fills frames
        before them), support grid every 6 frames."""
        params, tmodel = weights
        jtr = JTracker(params=params, **_tracker_kwargs(), s=4, stride=4)
        jtr.model = JCoTracker(**TINY_COTRACKER)
        ttr = TTracker(model=tmodel, **_tracker_kwargs())

        rng = np.random.default_rng(15)
        rgbs = rng.integers(0, 255, (1, 9, 48, 64, 3)).astype(np.uint8)
        qp = np.array([[[0, 5.0, 6.0], [3, 20.0, 15.0], [8, 40.0, 25.0]]],
                      np.float32)
        ref_t, ref_v = jtr.forward_device(jax.device_put(rgbs), qp)
        got_t, got_v = ttr.forward_device(torch.from_numpy(rgbs), qp)
        np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t),
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
