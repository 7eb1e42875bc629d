"""`SamPt(data_parallel=True)` of the port in a gloo world of 2 CPU ranks
against the JAX package's `data_parallel=True` on the 8-device virtual
CPU mesh and against the port unsharded, float32, on the tiny SamPt pair
(`torch_port_helpers.tiny_sam_pt_pair`: tiny SAM + tiny CoTracker) over
`sam_pt_video()` (two objects, query frames 0 and 3).

Both data-parallel SamPts take odd chunks (encode 3, decode 5), which
each rounds up to a multiple of its data axis (JAX: 8 and 8; the port's
world of 2: 4 and 6).

- The ranks return the same bits.
- The port's data-parallel outputs against the JAX data-parallel ones as
  `assert_sam_pt_pair` holds the unsharded pair (trajectories 1e-3 px,
  equal visibilities, scores 1e-4, float16 logits, fused labels).
- Against the port unsharded: logits within 2e-2, scores 1e-3 and
  trajectories 1e-4, the JAX test's limits for its own sharded forward
  (tests/test_parallel.py), with the same gated planes.
"""
import numpy as np
import pytest
import torch

from sam_pt_torch.models.sam_pt import SamPt as TSamPt
from sam_pt_tpu.models.sam_pt import SamPt as JSamPt
from torch_parallel_worlds import cpu_world, sam_pt_rank
from torch_port_helpers import (TINY_SAM_PT_SETTINGS, assert_sam_pt_pair,
                                sam_pt_video, tiny_sam_pt_pair)

torch.set_num_threads(1)

CHUNKS = dict(sam_encode_chunk=3, sam_decode_chunk=5)


def _data_parallel(sam_pt, cls):
    settings = dict(TINY_SAM_PT_SETTINGS, **CHUNKS)
    return cls(sam_pt.point_tracker, sam_pt.sam_predictor,
               data_parallel=True, **settings)


@pytest.fixture(scope="module")
def runs():
    jsampt, tsampt = tiny_sam_pt_pair()
    video = sam_pt_video()
    ranks = cpu_world(2, sam_pt_rank, _data_parallel(tsampt, TSamPt), video)
    jdp = _data_parallel(jsampt, JSamPt)
    jout = jdp.forward(dict(video, keep_logits_on_device=True))
    assert jdp.sam_encode_chunk == 8 and jdp.sam_decode_chunk == 8
    return video, jout, tsampt.forward(video), ranks


def test_ranks_agree_bit_for_bit(runs):
    _, _, _, ranks = runs
    for r in ranks:
        assert (r["encode_chunk"], r["decode_chunk"], r["mesh_size"]) == (
            4, 6, 2)
        for key, value in r["out"].items():
            np.testing.assert_array_equal(value, ranks[0]["out"][key],
                                          err_msg=key)


def test_data_parallel_matches_jax_data_parallel(runs):
    video, jout, _, ranks = runs
    tout = {k: torch.from_numpy(v) for k, v in ranks[0]["out"].items()}
    assert_sam_pt_pair(video, jout, tout)


def test_data_parallel_matches_the_port_unsharded(runs):
    _, _, plain, ranks = runs
    got = ranks[0]["out"]
    ref = {k: v.float().numpy() for k, v in plain.items()}
    logits = got["logits"].astype(np.float32)
    np.testing.assert_array_equal(np.isneginf(logits),
                                  np.isneginf(ref["logits"]))
    finite = np.isfinite(ref["logits"])
    assert finite.any()
    np.testing.assert_allclose(logits[finite], ref["logits"][finite],
                               atol=2e-2)
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-3)
    np.testing.assert_allclose(got["trajectories"], ref["trajectories"],
                               atol=1e-4)
    np.testing.assert_array_equal(got["visibilities"], ref["visibilities"])
