"""Phase 19 of `chip_smoke.py` (TAPIR and TapNet) rehearsed on the CPU:
the phase with the tiny SAM and the full-width trackers in place of SAM
ViT-B, the trackers alone and against themselves in place of the card,
the CLI run with `model/point_tracker=tapir` and the two standalone demos
as subprocesses. (A file of its own, so that it runs beside
test_torch_chip_smoke.py.)"""
import torch

import chip_smoke
from sam_pt_torch.ops import flash_attention as fa
from test_torch_chip_smoke import _rehearsal


def _tiny_haiku_sam_pt(device, name):
    """The tiny SamPt with TAPIR or TapNet at full width in its place."""
    from sam_pt_torch.models.tracker import TRACKER_REGISTRY
    from sam_pt_torch.utils.testing import build_tiny_sam_pt

    sam_pt = build_tiny_sam_pt(device="cpu", positive_points_per_mask=16,
                               negative_points_per_mask=1,
                               iterative_refinement_iterations=2)
    sam_pt.point_tracker = TRACKER_REGISTRY[name](allow_random_init=True,
                                                  seed=1, device=device)
    return sam_pt


def test_haiku_tracker_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """Phase 19 on the CPU: the tiny SAM with each of TAPIR and TapNet at
    full width over 24 x 2 at 48 x 80 (launches, output checks, the timed
    pass, the reference check), then the trackers alone over 4 frames and
    the CPU against itself in place of the card."""
    from sam_pt_torch.vos_eval.eval import device_fuse_index_masks

    _rehearsal(monkeypatch)
    checks = chip_smoke.haiku_tracker_checks
    monkeypatch.setattr(chip_smoke, "haiku_tracker_checks",
                        lambda device, card: checks(device, card, frames=4))
    found = chip_smoke.haiku_tracker_phase(
        fa, torch.device("cpu"), device_fuse_index_masks, "the CPU", False,
        build=_tiny_haiku_sam_pt)
    out = capsys.readouterr().out
    assert found == {name: {k: 0 for k in fa.LAUNCHES}
                     for name in ("tapir", "tapnet")}
    for line in ("tapir: video 24 frames x 2 objects", "tapnet: timed pass",
                 "tapir reference: decode chain", "tracker tapnet: 4 frames "
                 "48 x 80, 17 points", "(not pinned)", "(<= 1e-3)",
                 "tracker online tapir card vs CPU", "the phase took"):
        assert line in out
    assert "FAIL" not in out


def test_tapir_cli_and_tracker_demos_rehearsed_on_the_cpu(monkeypatch,
                                                          capsys):
    """Phase 19's CLI run (the default model with the tiny SAM and TAPIR
    composed in, one video) and the two tracker demos as subprocesses, on
    the CPU."""
    _rehearsal(monkeypatch)
    monkeypatch.setattr(chip_smoke, "CLI_FRAMES", 4)
    monkeypatch.setattr(chip_smoke, "DEMO_FRAMES", 3)
    chip_smoke.cli_phase(fa, "the CPU", model=(
        "device=cpu", "size=-1", "model/sam@model.sam_predictor=sam_tiny_test",
        "model/point_tracker=tapir",
        "model.point_tracker.allow_random_init=true"), videos=1,
        label="cli tapir")
    found = chip_smoke.tracker_demo_phase("the CPU", ("--device", "cpu"))
    out = capsys.readouterr().out
    for line in ("cli tapir: instantiated cfg['model'] (SamPt: SAM",
                 "TapirPointTracker", "cli tapir: evaluate wrote [4] PNGs",
                 "video0: 4 written masks equal", "cli tapir: python -m "
                 "sam_pt_torch.vos_eval.eval (1 video, 8 frames) exit 0"):
        assert line in out
    assert all("frames/s" in found[name] for name in ("tapir", "tapnet"))
    assert "FAIL" not in out
