"""Phase 20 of `chip_smoke.py` (SuperGlue) on the CPU: its pure helpers
(the reinit schedule, `superglue_live_weights` giving matches on a small
pair, the F9 permutation), and the phase rehearsed with the tiny SAM and
SuperGlue at its published widths in place of SAM ViT-B, the CPU against
itself in place of the card, then the CLI run with
`model/point_tracker=superglue` and `match_pairs` as subprocesses. (A file
of its own, so that it runs beside test_torch_chip_smoke.py.)"""
from types import SimpleNamespace

import numpy as np
import torch

import chip_smoke
from sam_pt_torch.ops import flash_attention as fa
from test_torch_chip_smoke import _rehearsal

torch.set_num_threads(1)


def test_reinit_schedule_adds_each_windows_mask_decode():
    encoder = SimpleNamespace(blocks=[0] * 12, global_attn_indexes=(2, 5, 8,
                                                                    11))
    sam_pt = SimpleNamespace(
        sam_encode_chunk=4, sam_decode_chunk=32,
        iterative_refinement_iterations=12,
        sam_predictor=SimpleNamespace(model=SimpleNamespace(
            image_encoder=encoder)))
    windows = [("forward", 0, 24, 1), ("forward", 12, 24, 1),
               ("backward", 11, 24, 1), ("backward", 23, 24, 1)]
    got = chip_smoke.superglue_reinit_schedule(sam_pt, 24, windows)
    # 24 + 12 + 13 + 1 tracked pairs, then 4 one-pair mask decodes
    assert got == {"window": 8 * 6, "global": 4 * 6,
                   "cross": 5 * 14 * (1 + 1 + 1 + 1 + 4), "relpos": 0}


def test_live_weights_give_matches_on_a_small_pair():
    """Random N(0, 0.02^2) weights match nothing at 0.2; live, frame 0
    matches most of itself on the still frames and follows the texture
    when it moves."""
    from sam_pt_torch.models.tracker.superglue.tracker import (
        SuperGluePointTracker,
    )

    video = torch.from_numpy(chip_smoke.textured_frames(6, 3, 96, 160))
    tracker = SuperGluePointTracker(allow_random_init=True, seed=1,
                                    device="cpu", max_keypoints=256,
                                    sinkhorn_iterations=50)
    assert chip_smoke.superglue_matches(tracker, video).max() == 0
    chip_smoke.superglue_live_weights(tracker)
    counts = chip_smoke.superglue_matches(tracker, video)
    assert (counts >= 20).all(), counts
    sg = tracker.superglue
    assert float(sg.bin_score) == 1.0 and not sg.gnn.layers[3].mlp[-1].weight.any()


def test_head_permutation_is_f9():
    """Channel d * 4 + h of the port is channel h * 64 + d of the JAX
    package; the permutation is a bijection."""
    from sam_pt_torch.utils.checkpoint import head_permutation

    perm = head_permutation(256, 4)
    assert sorted(perm) == list(range(256))
    for d, h in ((0, 0), (0, 3), (5, 2), (63, 3)):
        assert perm[d * 4 + h] == h * 64 + d


def _tiny_superglue_sam_pt(device):
    """The tiny SamPt with SuperGlue at its published widths in place, 64
    keypoint slots (a 48 x 80 frame has fewer keypoints; 1024 slots would
    cost the CPU minutes of attention over padding)."""
    from sam_pt_torch.models.tracker import TRACKER_REGISTRY
    from sam_pt_torch.utils.testing import build_tiny_sam_pt

    sam_pt = build_tiny_sam_pt(device="cpu", positive_points_per_mask=16,
                               negative_points_per_mask=1,
                               iterative_refinement_iterations=2)
    sam_pt.point_tracker = TRACKER_REGISTRY["superglue"](
        allow_random_init=True, seed=1, device=device,
        positive_points_per_mask=16, negative_points_per_mask=1,
        max_keypoints=64)
    return sam_pt


def test_superglue_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """Phase 20 on the CPU at 48 x 80 with the tiny SAM and 64 keypoint
    slots: launches, output
    checks, matches and visible positives, the reinit pass with its mask
    sets, the tracker alone over 4 frames and the CPU against itself,
    label propagation, the phase's seconds."""
    from sam_pt_torch.vos_eval.eval import device_fuse_index_masks

    _rehearsal(monkeypatch)
    checks = chip_smoke.superglue_tracker_checks
    monkeypatch.setattr(chip_smoke, "superglue_tracker_checks",
                        lambda device, card, profiling: checks(
                            device, card, frames=4, keypoints=64,
                            small_keypoints=64, profiling=profiling))
    found = chip_smoke.superglue_phase(
        fa, torch.device("cpu"), device_fuse_index_masks, "the CPU", False,
        build=_tiny_superglue_sam_pt)
    out = capsys.readouterr().out
    assert found == {k: 0 for k in fa.LAUNCHES}
    for line in ("superglue: video 24 frames x 2 objects",
                 "superglue: matches a frame (1-23)",
                 "superglue reinit: windows [('forward', 0, 24, 1)",
                 "superglue reference: decode chain",
                 "tracker superglue: 4 frames 48 x 80, 17 points",
                 "tracker superglue card vs CPU", "0 of",
                 "label propagation card vs CPU", "the phase took"):
        assert line in out
    assert "FAIL" not in out


def test_superglue_cli_and_match_pairs_rehearsed_on_the_cpu(monkeypatch,
                                                            capsys):
    """Phase 20's CLI run (the default model with the tiny SAM and
    SuperGlue composed in, one video) and `match_pairs` as a subprocess,
    on the CPU, with 64 keypoint slots."""
    _rehearsal(monkeypatch)
    monkeypatch.setattr(chip_smoke, "CLI_FRAMES", 4)
    chip_smoke.cli_phase(fa, "the CPU", model=(
        "device=cpu", "size=-1", "model/sam@model.sam_predictor=sam_tiny_test",
        "model/point_tracker=superglue", "model.point_tracker.max_keypoints=64",
        "model.point_tracker.allow_random_init=true"), videos=1,
        label="cli superglue")
    chip_smoke.match_pairs_phase("the CPU", ("--device", "cpu", "--resize",
                                             "160", "96", "--max_keypoints",
                                             "64"))
    out = capsys.readouterr().out
    for line in ("cli superglue: instantiated cfg['model'] (SamPt: SAM",
                 "SuperGluePointTracker", "cli superglue: evaluate wrote [4]",
                 "video0: 4 written masks equal", "match_pairs: python -m "
                 "...superglue.match_pairs exit 0"):
        assert line in out
    assert "FAIL" not in out
