"""The repo's default model (`configs/model/sam_pt.yaml`: SAM + PIPS) in
the port: `build_predictor`, `build_sam_pt(sam=, tracker=)`, and a tiny
SamPt with PIPS against the JAX package's SamPt + PipsPointTracker on the
same weights, in float32.

The tiny SamPt is the tiny SAM of test_torch_sam_pt.py with PIPS at its
published widths (stride 4, the visibility bias at 3 so that points stay
visible), query masks of two objects on frames 0 and 3 of a 9-frame video
(a PIPS window runs past its end). Tolerances as in test_torch_sam_pt.py:
trajectories 1e-3 px, IoU scores 1e-4, float16 logits 2e-2 absolute, fused
labels equal away from the decision boundaries; the predictor's
embeddings 1e-4 (float32 through the tiny ViT).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam_pt_tpu.utils.testing as jtesting
from sam_pt_torch import build
from sam_pt_torch.models.sam import factory
from sam_pt_torch.models.sam.image_encoder import VIT_VARIANTS
from sam_pt_torch.models.tracker import TRACKER_REGISTRY
from sam_pt_torch.vos_eval.eval import device_fuse_index_masks as t_fuse
from sam_pt_tpu.models.sam.factory import build_predictor as j_build
from sam_pt_tpu.vos_eval.eval import device_fuse_index_masks as j_fuse
from torch_port_helpers import random_sam_state_dict, tiny_sam_pt_pair

torch.set_num_threads(1)

LOGIT_ATOL = 2e-2


def _video():
    rng = np.random.default_rng(16)
    t, h, w = 9, 48, 64
    masks = np.zeros((2, h, w), np.float32)
    masks[0, 10:25, 8:30] = 1
    masks[1, 28:45, 35:60] = 1
    return {
        "image": rng.integers(0, 255, (t, h, w, 3)).astype(np.uint8),
        "target_hw": (96, 128),
        "query_masks": masks,
        "query_point_timestep": np.array([0, 3], np.float32),
    }


@pytest.fixture(scope="module")
def outputs():
    jsampt, tsampt = tiny_sam_pt_pair(tracker="pips")
    video = _video()
    jout = jsampt.forward(dict(video, keep_logits_on_device=True))
    tout = tsampt.forward(video)
    return video, jout, tout


def test_trajectories_and_visibilities(outputs):
    _, jout, tout = outputs
    assert tout["trajectories"].shape == (9, 2, 5, 2)
    np.testing.assert_allclose(tout["trajectories"].numpy(),
                               np.asarray(jout["trajectories"]), atol=1e-3,
                               rtol=0)
    np.testing.assert_array_equal(tout["visibilities"].numpy(),
                                  np.asarray(jout["visibilities"]))


def test_scores_logits_and_masks(outputs):
    video, jout, tout = outputs
    for key in ("scores_per_frame", "scores"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   atol=1e-4, rtol=0)
    got = tout["logits"].float().numpy()
    ref = np.asarray(jout["logits"], np.float32)
    assert got.shape == ref.shape == (2, 9, 96, 128)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    finite = np.isfinite(ref)
    assert finite.any()
    np.testing.assert_allclose(got[finite], ref[finite], atol=LOGIT_ATOL,
                               rtol=1e-3)
    ts = [0, 3]
    gt = video["query_masks"].repeat(2, axis=1).repeat(2, axis=2)
    # Fusion compares each object's logit with a zero background and with
    # the other objects' logits: labels may differ where either is closer
    # than the tolerance.
    top2 = np.sort(np.maximum(ref, -1e4), axis=0)[-2:]
    near = (np.abs(ref) < LOGIT_ATOL).any(0) | (
        top2[1] - top2[0] < LOGIT_ATOL)
    assert np.array_equal(t_fuse(tout["logits"], gt, ts)[~near],
                          j_fuse(jout["logits"], gt, ts)[~near])


@pytest.fixture()
def tiny_variant(monkeypatch):
    monkeypatch.setitem(VIT_VARIANTS, "vit_tiny_test", jtesting.TINY_VIT)
    return "vit_tiny_test"


def test_build_predictor_loads_a_public_pth(tmp_path, tiny_variant):
    """A `segment_anything`-namespace .pth, loaded as it is by the port
    and through the JAX converter by the JAX factory: same embeddings."""
    path = str(tmp_path / "sam_tiny.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                random_sam_state_dict(seed=21).items()}, path)
    kwargs = dict(variant=tiny_variant, checkpoint=path, dtype="float32",
                  image_size=64)
    tpred = factory.build_predictor(device="cpu", **kwargs)
    jpred = j_build(**kwargs)
    frames = np.random.default_rng(22).uniform(0, 255, (2, 48, 64, 3)
                                               ).astype(np.float32)
    got = tpred.encode_frames(torch.from_numpy(frames), (48, 64))
    ref = jpred.encode_frames(jnp.asarray(frames), (48, 64))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               atol=1e-4, rtol=0)


def test_build_predictor_missing_checkpoint(tmp_path, tiny_variant):
    missing = str(tmp_path / "absent.pth")
    with pytest.raises(FileNotFoundError):
        factory.build_predictor(tiny_variant, missing, device="cpu")
    with pytest.warns(UserWarning, match="random"):
        a = factory.build_predictor(tiny_variant, missing, image_size=64,
                                    allow_random_init=True, seed=3,
                                    device="cpu")
    b = factory.build_predictor(tiny_variant, None, image_size=64,
                                allow_random_init=True, seed=3, device="cpu")
    sd_a, sd_b = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    assert a.model.dtype == torch.bfloat16
    w = a.model.image_encoder.blocks[0].attn.qkv.weight.float()
    assert 0.015 < float(w.std()) < 0.025
    # HQ-SAM's decoder and TinyViT (MobileSAM) are ported: they build; a
    # variant no config names is refused.
    hq = factory.build_predictor(tiny_variant, image_size=64, hq=True,
                                 allow_random_init=True, device="cpu")
    assert type(hq.model.mask_decoder).__name__ == "MaskDecoderHQ"
    tiny = factory.build_predictor("vit_t", image_size=64,
                                   allow_random_init=True, device="cpu")
    assert type(tiny.model.image_encoder).__name__ == "TinyViT"
    with pytest.raises(ValueError, match="unknown SAM variant"):
        factory.build_predictor("vit_x", allow_random_init=True,
                                device="cpu")


@pytest.mark.parametrize("name", ["build_predictor", "pips", "pips_plus_plus",
                                  "raft"])
def test_cuda_is_the_default_device(name):
    """Entry points run on the card unless the caller asks for the CPU:
    without a card, the default fails rather than falling back."""
    fn = (factory.build_predictor if name == "build_predictor"
          else TRACKER_REGISTRY[name])
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        kwargs = dict(allow_random_init=True)
        if name == "build_predictor":
            kwargs["variant"] = "vit_b"
        with pytest.raises((AssertionError, RuntimeError)):
            fn(**kwargs)


def test_build_sam_pt_default_model():
    """`sam="vit_b", tracker="pips", **DEFAULT_SETTINGS` is
    configs/model/sam_pt.yaml; the defaults stay the main path."""
    assert build.DEFAULT_SETTINGS == dict(sam_decode_chunk=32,
                                          point_tracker_mask_batch_size=5,
                                          sam_encode_chunk=4)
    sig = inspect.signature(build.build_sam_pt).parameters
    assert (sig["sam"].default, sig["tracker"].default) == ("vit_h",
                                                            "cotracker")
    sam_pt = build.build_sam_pt("cpu", sam="vit_b", tracker="pips",
                                **build.DEFAULT_SETTINGS)
    encoder = sam_pt.sam_predictor.model.image_encoder
    assert (len(encoder.blocks), encoder.global_attn_indexes) == (
        12, (2, 5, 8, 11))
    assert sam_pt.sam_predictor.model.dtype == torch.bfloat16
    tracker = sam_pt.point_tracker
    assert type(tracker).__name__ == "PipsPointTracker"
    assert (tracker.stride, tracker.s, tracker.vis_threshold0) == (4, 8, 0.9)
    assert tracker.model.norm.weight.dtype == torch.float32
    assert (sam_pt.sam_decode_chunk, sam_pt.point_tracker_mask_batch_size,
            sam_pt.sam_encode_chunk, sam_pt.positive_points_per_mask,
            sam_pt.iterative_refinement_iterations) == (32, 5, 4, 16, 12)
