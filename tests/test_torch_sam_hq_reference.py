"""HQ-SAM in the port against the benchmark's plain reference
(`benchmark/reference/pipeline_hq.py`), on the CPU at a tiny size, both in
float32 on the same state dicts drawn from a seed
(`benchmark/harness/weights.py`): the HQ configuration's own file with
SAM's encoder cut to 4 blocks of 32 wide, global at blocks 1 and 3, on a
128-pixel input (`benchmark/tests/tiny.py`), built by the benchmark's HQ
system (`Sam(use_hq=True)`), under the configuration's SamPt settings.

- The embeddings: {'emb', 'interm'}, `interm` the first global block's
  output.
- The image-level HQ features that `SamPt._hq_features_device` computes
  once a frame: equal to the reference's, and decoding from them equals
  decoding with `MaskDecoderHQ`'s in-pass computation.
- The 14-pass decode chain's logits and IoUs.
- A forward computes the features once a frame (the `hq` span's frames,
  the rows `image_features` sees) and none in the decode chain.

The tracker is a stand-in that keeps every point where it was queried:
the points are the decoder's input here, not what is tested.
"""
import numpy as np
import pytest
import torch

from benchmark.harness import weights
from benchmark.reference import pipeline_hq as ref
from benchmark.systems import sam_pt_hq
from benchmark.tests import tiny
from sam_pt_torch.models.sam_pt import SamPt
from sam_pt_torch.utils import tracing

torch.set_num_threads(1)

CELL = "hqvith_cotracker.crowded"
T, H, W = 6, 48, 64
OBJECTS = 2


class StillTracker:
    """Every point stays at its query position, visible."""

    def forward_device(self, video, query_points):
        q = torch.as_tensor(np.asarray(query_points)[0, :, 1:])
        traj = q[None].expand(video.shape[1], -1, -1).clone()
        return traj[None], torch.ones(traj.shape[:2])[None]


@pytest.fixture(scope="module")
def hq():
    cfg = tiny.config(CELL)
    cfg["sam"].update(depth=4, global_attn_indexes=[1, 3], dtype="float32")
    cfg["tracker"]["dtype"] = "float32"
    ckpt = weights.checkpoints(cfg, ref.param_shapes(cfg), 2 ** 31 + 8,
                               torch.device("cpu"))
    predictor = sam_pt_hq.build_sam(cfg, ckpt)
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.integers(0, 255, (T, H, W, 3), np.uint8))
    return cfg, ckpt["sam"], predictor, frames


def _sam_pt(cfg, predictor, **settings):
    return SamPt(StillTracker(), predictor, **{**cfg["sam_pt"], **settings})


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def test_embeddings_match_with_interm_from_the_first_global_block(hq):
    cfg, sd, predictor, frames = hq
    got = _sam_pt(cfg, predictor)._encode_all_frames(frames[:3])
    want = ref.embeddings(frames[:3], sd, cfg)
    assert set(got) == set(want) == {"emb", "interm"}
    assert got["interm"].shape == (3, 8, 8, 32)
    # float32 on both sides: summation order alone
    for key in want:
        assert _rel(got[key], want[key]) < 1e-5, key


def test_features_once_a_frame_equal_the_in_pass_computation(hq):
    cfg, sd, predictor, frames = hq
    sam_pt = _sam_pt(cfg, predictor)
    emb = sam_pt._encode_all_frames(frames)
    hoisted = sam_pt._hq_features_device(emb)
    assert set(hoisted) == {"emb", "hq"} and hoisted["emb"] is emb["emb"]
    assert hoisted["hq"].shape == (T, 32, 32, 32)
    # the published arithmetic on the reference's side, frame by frame
    for f in range(T):
        want = ref.hq_features({k: v[f] for k, v in emb.items()}, sd)
        assert _rel(hoisted["hq"][f].permute(2, 0, 1), want) < 1e-5

    # the decoder fed the hoisted features, gathered per pair as the chain
    # gathers them, against MaskDecoderHQ computing them in the pass
    idx = torch.tensor([0, 0, 3, 5, 5, 2])
    rng = np.random.default_rng(6)
    pts = torch.from_numpy(rng.uniform(0, 128, (6, 4, 2)).astype(np.float32))
    lbl = torch.tensor([[1, 0, -1, -1], [1, 1, 2, 3]] * 3)
    mask = torch.from_numpy(rng.standard_normal((6, 32, 32, 1)).astype(
        np.float32))
    valid = torch.ones(6, dtype=torch.bool)
    in_pass = predictor.decode({k: v[idx] for k, v in emb.items()}, pts, lbl,
                               mask, valid)
    once = predictor.decode({k: v[idx] for k, v in hoisted.items()}, pts,
                            lbl, mask, valid)
    # the same layers on the same inputs: the convolutions' batch differs
    for a, b in zip(once, in_pass):
        assert _rel(a, b) < 1e-6


def test_decode_chain_matches_the_reference(hq):
    cfg, sd, predictor, frames = hq
    # every pair kept whatever its IoU: the gate is not under test here
    sam_pt = _sam_pt(cfg, predictor, sam_iou_threshold=-float("inf"))
    emb = sam_pt._encode_all_frames(frames[:2])
    rng = np.random.default_rng(7)
    n_pos = cfg["sam_pt"]["positive_points_per_mask"]
    n = n_pos + cfg["sam_pt"]["negative_points_per_mask"]
    traj = torch.from_numpy(rng.uniform([4, 4], [W - 4, H - 4],
                                        (2, OBJECTS, n, 2)).astype(np.float32))
    vis = torch.ones(2, OBJECTS, n)
    assert cfg["sam_pt"]["iterative_refinement_iterations"] == 12
    logits, spf = sam_pt._apply_sam_device(
        (H, W), traj, vis, sam_pt._hq_features_device(emb))
    for f in range(2):
        for obj in range(OBJECTS):
            pts, lbl = ref.prompt(traj[f], vis[f], obj, n_pos, True)
            want, iou, visible = ref.decode({k: v[f] for k, v in emb.items()},
                                            pts, lbl, (H, W), sd, cfg)
            assert visible
            # the port's decoder norms take epsilon 1e-6, the published
            # ones (the reference's) 1e-5; the port keeps float16 logits
            assert abs(float(spf[f, obj]) - float(iou)) < 1e-4
            assert _rel(logits[obj, f], want) < 2e-3


def test_forward_computes_the_features_once_a_frame(hq):
    cfg, _, predictor, frames = hq
    sam_pt = _sam_pt(cfg, predictor)
    decoder = predictor.model.mask_decoder
    rows = []
    image_features = decoder.image_features

    def counted(emb, interm):
        rows.append((emb.shape[0], tracing.enabled() and _open_span()))
        return image_features(emb, interm)

    decoder.image_features = counted
    masks = np.zeros((OBJECTS, H, W), np.float32)
    masks[0, 8:24, 8:30] = 1
    masks[1, 26:44, 34:60] = 1
    video = {"image": frames.numpy(), "target_hw": (H, W),
             "query_masks": masks,
             "query_point_timestep": np.zeros(OBJECTS, np.float32)}
    tracing.enable()
    try:
        sam_pt.forward(video)
        spans = tracing.export()
    finally:
        tracing.disable()
        del decoder.image_features
    ec = cfg["sam_pt"]["sam_encode_chunk"]
    # one call a chunk of frames, the last padded; none a pair
    assert [r for r, _ in rows] == [ec] * -(-T // ec)
    assert {s for _, s in rows} == {"hq"}
    (span,) = [s for s in spans if s["name"] == "hq"]
    assert span["counts"] == {"frames": T, "bytes": T * 32 * 32 * 32 * 4}


def _open_span():
    """The name of the innermost open span of the tracer."""
    timer = tracing._timer
    return timer._open[-1]["name"] if timer._open else None
