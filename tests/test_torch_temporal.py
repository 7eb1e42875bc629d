"""Time-sharded TapNet and TAPIR in the port (`sam_pt_torch/parallel/
temporal.py`, the models' `time_shard` paths) in gloo worlds of 2 and 3
CPU ranks, float32, over 7 frames (padded to 8 and to 9), against the
JAX package's `tapnet_forward_time_sharded` / `tapir_forward_time_sharded`
on the same number of virtual CPU devices, and against the port
unsharded.

- TapNet at its published widths, TAPIR with the JAX test's cut mixer
  (2 passes, 2 blocks, hidden 32), the JAX models' initial weights
  converted; 64 x 64 frames, queries on the first, middle and last frame
  (so each rank owns one or none): tracks, occlusion (and TAPIR's
  expected distance) within 1e-4 of the JAX sharded run and of the port
  unsharded, as the JAX tests hold theirs; every rank gets the same
  bits.
- The port's TapNet and TAPIR trackers with `time_parallel` on the same
  worlds (TAPIR's model cut as above) track a 7 x 48 x 64 video as the
  unsharded tracker does: trajectories within 1e-3 px, the same
  visibilities.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sam_pt_torch.models.tracker.tapir import model as ttapir
from sam_pt_torch.models.tracker.tapir.tracker import TapirPointTracker
from sam_pt_torch.models.tracker.tapnet import model as ttapnet
from sam_pt_torch.models.tracker.tapnet.tracker import TapNetPointTracker
from sam_pt_torch.utils import checkpoint as tckpt
from sam_pt_tpu.models.tracker.tapir.model import TAPIR as JTapir
from sam_pt_tpu.models.tracker.tapnet.model import TAPNet as JTapnet
from sam_pt_tpu.parallel.mesh import create_mesh as jcreate_mesh
from sam_pt_tpu.parallel.temporal import (
    tapir_forward_time_sharded as jtapir_sharded,
    tapnet_forward_time_sharded as jtapnet_sharded,
)
from torch_parallel_worlds import cpu_world, temporal_rank

torch.set_num_threads(1)

T = 7
TAPIR_CUT = dict(num_pips_iter=2, num_mixer_blocks=2, mixer_hidden_dim=32)
KEYS = {"tapnet": ("tracks", "occlusion"),
        "tapir": ("tracks", "occlusion", "expected_dist")}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(72)
    video = (rng.standard_normal((T, 64, 64, 3)) * 0.5).astype(np.float32)
    qp = np.array([[0, 30.0, 40.0], [T - 1, 100.0, 200.0],
                   [T // 2, 5.0, 250.0]], np.float32)
    jmodels = {"tapnet": JTapnet(), "tapir": JTapir(**TAPIR_CUT)}
    params = {k: jax.jit(m.init)(jax.random.PRNGKey(0), jnp.asarray(video),
                                 jnp.asarray(qp))
              for k, m in jmodels.items()}
    tmodels = {"tapnet": ttapnet.TAPNet(), "tapir": ttapir.TAPIR(**TAPIR_CUT)}
    convert = {"tapnet": tckpt.tapnet_state_dict_from_jax,
               "tapir": tckpt.tapir_state_dict_from_jax}
    for k, m in tmodels.items():
        m.load_state_dict(convert[k](params[k]))
        m.eval().requires_grad_(False)
    trackers = {"tapnet": TapNetPointTracker(allow_random_init=True,
                                             device="cpu"),
                "tapir": TapirPointTracker(allow_random_init=True,
                                           device="cpu")}
    trackers["tapnet"].model = tmodels["tapnet"]
    trackers["tapir"].model = tmodels["tapir"]
    rgbs = rng.integers(0, 255, (1, T, 48, 64, 3)).astype(np.uint8)
    tq = np.array([[[0, 10.0, 20.0], [5, 40.0, 30.0], [T - 1, 50.0, 8.0]]],
                  np.float32)
    worlds = {w: cpu_world(w, temporal_rank, tmodels, video, qp, trackers,
                           rgbs, tq)
              for w in (2, 3)}
    unsharded = {k: t.forward(torch.from_numpy(rgbs), tq)
                 for k, t in trackers.items()}
    return video, qp, jmodels, params, tmodels, unsharded, worlds


@pytest.mark.parametrize("name", ["tapnet", "tapir"])
@pytest.mark.parametrize("world", [2, 3])
def test_time_sharded_model_matches_jax_and_unsharded(setup, name, world):
    video, qp, jmodels, params, tmodels, _, worlds = setup
    jsharded = {"tapnet": jtapnet_sharded, "tapir": jtapir_sharded}[name]
    mesh = jcreate_mesh(devices=jax.devices()[:world])
    jout = jsharded(jmodels[name], params[name], jnp.asarray(video),
                    jnp.asarray(qp), mesh)
    with torch.no_grad():
        tout = tmodels[name](torch.from_numpy(video), torch.from_numpy(qp))
    ranks = [r[name] for r in worlds[world]]
    for got in ranks:
        for key in KEYS[name]:
            assert got[key].shape[1] == T
            np.testing.assert_allclose(got[key], np.asarray(jout[key]),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
            np.testing.assert_allclose(got[key], tout[key].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
            np.testing.assert_array_equal(got[key], ranks[0][key])


@pytest.mark.parametrize("name", ["tapnet", "tapir"])
@pytest.mark.parametrize("world", [2, 3])
def test_time_parallel_tracker_tracks_as_unsharded(setup, name, world):
    traj, vis = setup[5][name]
    worlds = setup[6]
    for r in worlds[world]:
        got_traj, got_vis = r[f"{name}_tracker"]
        np.testing.assert_allclose(got_traj, traj, atol=1e-3)
        np.testing.assert_array_equal(got_vis, vis)
