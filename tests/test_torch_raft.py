"""Port RAFT against the JAX package's at raft-things.pth's widths, same
weights (a random raft-things-namespace state dict through the JAX
converter; the flow head scaled down, so that random weights give small
flows), in float32.

Tolerances: flows 1e-5 px after 12 iterations (measured 4e-6 on flows of
order 5); tracker trajectories 1e-5 px (measured 2e-6) and identical
in-frame flags.
"""
import jax.numpy as jnp
import numpy as np
import torch

from sam_pt_torch.models.tracker.raft.model import Raft as TRaft
from sam_pt_torch.models.tracker.raft.tracker import (
    RaftPointTracker as TTracker,
)
from sam_pt_torch.ops.sampling import bilinear_sample_nchw as t_sample
from sam_pt_torch.utils.checkpoint import raft_state_dict_from_jax
from sam_pt_tpu.models.tracker.raft.model import Raft as JRaft
from sam_pt_tpu.models.tracker.raft.tracker import (
    RaftPointTracker as JTracker,
)
from sam_pt_tpu.ops.sampling import bilinear_sample_nchw as j_sample
from sam_pt_tpu.utils.checkpoint import convert_raft_state_dict
from torch_port_helpers import random_raft_state_dict, torch_sd

torch.set_num_threads(1)


def test_bilinear_sample_nchw():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 3, 6, 7)).astype(np.float32)
    x = rng.uniform(-2, 9, (2, 11)).astype(np.float32)
    y = rng.uniform(-2, 8, (2, 11)).astype(np.float32)
    np.testing.assert_allclose(
        t_sample(*map(torch.from_numpy, (img, x, y))).numpy(),
        np.asarray(j_sample(*map(jnp.asarray, (img, x, y)))),
        atol=1e-6, rtol=0)


def test_state_dict_round_trip():
    """A strided block's BatchNorm is both `norm3` and `downsample.1`."""
    sd = random_raft_state_dict(seed=1)
    assert "cnet.layer2.0.norm3.running_var" in sd
    got = raft_state_dict_from_jax(convert_raft_state_dict(
        {f"module.{k}": v for k, v in sd.items()}))
    assert set(got) == set(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_flow():
    sd = random_raft_state_dict(seed=1)
    params = convert_raft_state_dict(sd)
    tmodel = TRaft()
    tmodel.load_state_dict(raft_state_dict_from_jax(params))
    tmodel.eval()
    rng = np.random.default_rng(0)
    im1, im2 = (rng.uniform(-1, 1, (2, 64, 72, 3)).astype(np.float32)
                for _ in range(2))
    ref = np.asarray(JRaft().apply(params, jnp.asarray(im1),
                                   jnp.asarray(im2), iters=12))
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(i).permute(0, 3, 1, 2)
                       for i in (im1, im2)), iters=12)
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-5, rtol=0)


def test_tracker_forward():
    """6 frames of 64 x 70 (padded to 72 on the device), queries on frames
    0, 3 and 5, one outside the frame."""
    sd = random_raft_state_dict(seed=1)
    jtracker = JTracker(params=convert_raft_state_dict(sd), iters=3)
    ttracker = TTracker(iters=3, allow_random_init=True, device="cpu")
    ttracker.model.load_state_dict(torch_sd(sd))
    rgbs = np.random.default_rng(2).integers(
        0, 255, (1, 6, 64, 70, 3)).astype(np.uint8)
    qp = np.array([[[0, 5.0, 6.0], [3, 20.0, 15.0], [5, 40.0, 25.0],
                    [3, 75.0, 10.0]]], np.float32)
    ref_t, ref_v = jtracker.forward(rgbs, qp)
    got_t, got_v = ttracker.forward_device(torch.from_numpy(rgbs), qp)
    np.testing.assert_allclose(got_t.numpy(), ref_t, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_v.numpy(), ref_v)
    assert 0 < ref_v.mean() < 1


def test_raft_things_pth_loads_as_it_is(tmp_path):
    """raft-things.pth: DataParallel prefixes, BatchNorm step counters
    (which the port's inference BatchNorm has no use for)."""
    sd = random_raft_state_dict(seed=6)
    public = {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}
    public["module.cnet.norm1.num_batches_tracked"] = torch.tensor(7)
    torch.save(public, tmp_path / "raft-things.pth")
    tracker = TTracker(checkpoint_path=str(tmp_path / "raft-things.pth"),
                       device="cpu")
    got = tracker.model.state_dict()
    for key, value in sd.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
