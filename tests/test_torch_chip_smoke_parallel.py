"""Phase 21 of `chip_smoke.py` (the parallel layer) rehearsed on the CPU:
the same worlds (gloo worlds of 2, 4 and 3 ranks, here on the CPU), the
same jobs and checks, at a small size: the tiny SamPt (data-parallel over
phase 4's two videos cut to 48 x 80), the tiny SAM in place of ViT-H
(its 2 heads split over a model axis of 2), TapNet at its published
widths and TAPIR with a cut mixer over 5 frames of 64 x 64. The schedules
are the CPU's zero counts (the plain paths launch no kernel); the NCCL
world runs only on the card. (A file of its own, so that it runs beside
the other chip_smoke rehearsals.)"""
import numpy as np
import torch

import chip_smoke
from test_torch_chip_smoke import _rehearsal

TAPIR_CUT = dict(num_pips_iter=2, num_mixer_blocks=2, mixer_hidden_dim=32)


def tiny_dp(device, data_parallel=True):
    from sam_pt_torch.utils.testing import build_tiny_sam_pt

    return build_tiny_sam_pt(device=device, data_parallel=data_parallel,
                             sam_decode_chunk=5)


def tiny_sam(device):
    from sam_pt_torch.utils.testing import build_tiny_predictor

    return build_tiny_predictor(seed=3, device=device).model


def tiny_haiku(device):
    from sam_pt_torch.models.batch_norm import reset_batch_norm_stats_
    from sam_pt_torch.models.tracker.tapir.model import TAPIR
    from sam_pt_torch.models.tracker.tapnet.model import TAPNet
    from sam_pt_torch.utils.checkpoint import randomize_

    g = torch.Generator(device=device).manual_seed(5)
    return {name: reset_batch_norm_stats_(randomize_(
        model.requires_grad_(False), g, 0.1)).eval()
        for name, model in (("tapnet", TAPNet()),
                            ("tapir", TAPIR(**TAPIR_CUT)))}


def zero_schedule(*args):
    return {"window": 0, "global": 0, "cross": 0, "relpos": 0}


def zero_tp_schedule(encoder):
    return {"window": 0, "global": 0}


def test_parallel_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    from sam_pt_torch.vos_eval.eval import device_fuse_index_masks

    _rehearsal(monkeypatch)
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # one thread a rank
    monkeypatch.setattr(chip_smoke, "PARALLEL_BUILDERS", {
        "dp": tiny_dp, "sam": tiny_sam, "haiku": tiny_haiku,
        "schedule": zero_schedule, "tp_schedule": zero_tp_schedule})
    monkeypatch.setattr(chip_smoke, "TIME_FRAMES", 5)
    monkeypatch.setattr(chip_smoke, "TIME_HW", 64)
    monkeypatch.setattr(chip_smoke, "TIME_QUERIES", 4)
    videos = [chip_smoke.make_video(t, m, seed=i)
              for i, (t, m) in enumerate([(4, 1), (5, 3)])]
    plain = tiny_dp(torch.device("cpu"), data_parallel=False)
    reference = []
    for v in videos:
        out, masks = chip_smoke.run_video(plain, v, device_fuse_index_masks)
        reference.append((masks, out["scores"].float().numpy()))
    found = chip_smoke.parallel_phase(torch.device("cpu"), "the CPU",
                                      reference, videos)
    out = capsys.readouterr().out
    assert found == {"window": 0, "global": 0, "cross": 0, "relpos": 0}
    for line in ("parallel: world of 2 (gloo, both ranks on cpu)",
                 "parallel dp gloo x2: video 1 fused masks agree on",
                 "outputs bit-equal across ranks",
                 "chunks (encode, decode) (4, 6)",
                 "parallel tp gloo x2 (model 2): embeddings rel. L2",
                 "parallel tp gloo x2 (model 2): the MLP's psum "
                 "torch.float32,",
                 "the attention's torch.float32",
                 "1 local heads", "parallel tp gloo x4 (data 2 x model 2)",
                 "parallel time gloo x2 tapnet: 5 frames over 2 ranks",
                 "parallel time gloo x3 tapir: 5 frames over 3 ranks",
                 "expected_dist within", "the phase took"):
        assert line in out, line
    assert "nccl" not in out


def test_kernel_json_tp_rows():
    """`window_attention_tp2` and `global_attention_tp2`: K1/K2 at 8
    heads x 80, with a rank's launches of phase 21's TP encode and every
    key of the contract."""
    cases = ("window", "global", "cross", "cross_masked", "cross_unmasked",
             "relpos", "relpos_window", "window_vit_b", "global_vit_b",
             "global_crop", "cross_interactive", "cross_hq",
             "cross_hq_masked", "cross_amg", "cross_amg_masked", "cross_vis",
             "cross_vis_masked", "cross_self", "window_tp2", "global_tp2")
    report = {c: {"max_abs_err": 1e-3 * (i + 1), "bound_by": "bytes",
                  **{f: float(i + j) for j, f in enumerate(chip_smoke.TIMES)
                     if f != "bound_by"}} for i, c in enumerate(cases)}
    zeros = {"window": 1, "global": 1, "cross": 1, "relpos": 0}
    rows = {r["name"]: r for r in chip_smoke.kernel_json(
        report, zeros, {"relpos": 1}, zeros, zeros, zeros,
        hq_launches=zeros,
        vis_launches={"amg": 1, "sam_pt": 1, "capacity": zeros},
        haiku_launches={"tapir": zeros, "tapnet": zeros},
        tp_launches={"window": 28, "global": 4})}
    for key, launches in (("window", 28), ("global", 4)):
        row = rows[f"{key}_attention_tp2"]
        assert row["launches"] == launches
        assert (row["route"], row["source"], row["replaces"]) == (
            "cuda", *chip_smoke.KERNEL_SOURCES[key])
        assert row["max_abs_err"] == report[f"{key}_tp2"]["max_abs_err"]
        for f in chip_smoke.TIMES:
            assert row[f] == report[f"{key}_tp2"][f]


def test_digest_tells_bits_apart():
    a = torch.tensor([0.0, 1.0])
    assert chip_smoke.digest(a) == chip_smoke.digest(a.clone())
    assert chip_smoke.digest(a) != chip_smoke.digest(torch.tensor([-0.0,
                                                                   1.0]))
    assert chip_smoke.digest(np.zeros(2, np.uint8)) != chip_smoke.digest(
        np.zeros(3, np.uint8))
