"""The kernel phase's arithmetic in `chip_smoke.py`, on the CPU: the
roofline bound of each kernel case against counts made by hand from the
main path's shapes, the library yardsticks (one
`scaled_dot_product_attention` call each) against the plain version of the
kernel they stand beside, in float32 at small shapes, the kernel JSON
line's rows, and the CLI phase rehearsed at a small size with the tiny
SamPt (its synthetic DAVIS tree also at full size).

Tolerance of the yardsticks: 1e-5 absolute and relative. Both sides compute
the same softmax attention in float32 (the plain versions' bf16 roundings
are no-ops in float32) and differ only in summation order.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from sam_pt_torch.ops import flash_attention as fa
from sam_pt_torch.vos_eval.data.image_io import read_index_mask

BF16 = 2


def _bytes(*shapes, extra=0):
    return BF16 * sum(int(np.prod(s)) for s in shapes) + extra


# (problems, nq, nk, d, bytes moved): GFLOP, MB, bound ms, bound_by
ROWS = {
    "K1": ((100 * 16, 196, 196, 80),
           _bytes((100, 196, 3840), (100, 196, 16, 28), (100, 196, 1280)),
           19.67, 218.3, 0.0652, "bytes"),
    "K2": ((4 * 16, 4096, 4096, 80),
           _bytes((4, 4096, 3840), (4, 4096, 16, 128), (4, 4096, 1280)),
           343.6, 234.9, 0.347, "operations"),
    "K3 token->image": ((48 * 8, 60, 4096, 16),
                        _bytes((48, 60, 128), (48, 4096, 128),
                               (48, 4096, 128), (48, 60, 128)),
                        6.04, 102.1, 0.0305, "bytes"),
    "K3 image->token": ((48 * 8, 4096, 60, 16),
                        _bytes((48, 4096, 128), (48, 60, 128),
                               (48, 60, 128), (48, 4096, 128),
                               extra=48 * 60),
                        6.04, 102.1, 0.0305, "bytes"),
    "K4 flash": ((64, 4096, 4096, 80),
                 _bytes(*[(64, 4096, 80)] * 3, *[(64, 4096, 64)] * 2,
                        (64, 4096, 80)),
                 343.6, 234.9, 0.347, "operations"),
    "K1 ViT-B": ((100 * 12, 196, 196, 64),
                 _bytes((100, 196, 2304), (100, 196, 12, 28),
                        (100, 196, 768)),
                 11.80, 133.6, 0.0399, "bytes"),
    "K2 ViT-B": ((4 * 12, 4096, 4096, 64),
                 _bytes((4, 4096, 2304), (4, 4096, 12, 128), (4, 4096, 768)),
                 206.16, 151.0, 0.2084, "operations"),
    "K4 window": ((1600, 196, 196, 80),
                  _bytes(*[(1600, 196, 80)] * 3, *[(1600, 196, 14)] * 2,
                         (1600, 196, 80)),
                  19.67, 218.3, 0.0652, "bytes"),
    # crop_pad_tokens at 480 x 854: 36 x 64 tokens of the 64 x 64 grid
    "K2 crop": ((4 * 16, 2304, 2304, 80),
                _bytes((4, 2304, 3840), (4, 2304, 16, 100), (4, 2304, 1280)),
                108.72, 123.9, 0.1099, "operations"),
    # 12 frames of the interactive phase, 325 token keys (5 output tokens,
    # 317 prompt slots, 2 box corners, the pad), 42 of them valid; the
    # operations count the valid keys
    "K3 image->token interactive": (
        (12 * 8, 4096, 42, 16),
        _bytes((12, 4096, 128), (12, 325, 128), (12, 325, 128),
               (12, 4096, 128), extra=12 * 325),
        1.06, 27.2, 0.00811, "bytes"),
    # the HQ phase's refinement passes: a decode chunk of 32 pairs, 42
    # token keys (6 output tokens with the HQ token, a mask's 17 points,
    # the other object's 16 positives, 2 box corners, the pad), the pad
    # masked in the image->token direction (41 valid keys)
    "K3 HQ token->image": (
        (32 * 8, 42, 4096, 16),
        _bytes((32, 42, 128), (32, 4096, 128), (32, 4096, 128),
               (32, 42, 128)),
        2.82, 67.8, 0.02024, "bytes"),
    "K3 HQ image->token": (
        (32 * 8, 4096, 41, 16),
        _bytes((32, 4096, 128), (32, 42, 128), (32, 42, 128),
               (32, 4096, 128), extra=32 * 42),
        2.75, 67.8, 0.02024, "bytes"),
    # the VIS phase's generator: a batch of 64 one-point prompts, 7 tokens
    # (5 output tokens, the point, the pad point) against 4096, every
    # token valid in the image->token direction's key mask
    "K3 AMG token->image": (
        (64 * 8, 7, 4096, 16),
        _bytes((64, 7, 128), (64, 4096, 128), (64, 4096, 128),
               (64, 7, 128)),
        0.94, 134.4, 0.04013, "bytes"),
    "K3 AMG image->token": (
        (64 * 8, 4096, 7, 16),
        _bytes((64, 4096, 128), (64, 7, 128), (64, 7, 128),
               (64, 4096, 128), extra=64 * 7),
        0.94, 134.4, 0.04013, "bytes"),
    # the VIS phase's tracking with 28 proposals: a decode chunk of 32
    # pairs in a refinement pass, 457 tokens (5 output tokens, 17 points,
    # 16 positives of each of 27 other masks, 2 box corners, the pad), the
    # pad masked in the image->token direction (456 valid keys)
    "K3 VIS token->image": (
        (32 * 8, 457, 4096, 16),
        _bytes((32, 457, 128), (32, 4096, 128), (32, 4096, 128),
               (32, 457, 128)),
        30.67, 74.6, 0.03101, "operations"),
    "K3 VIS image->token": (
        (32 * 8, 4096, 456, 16),
        _bytes((32, 4096, 128), (32, 457, 128), (32, 457, 128),
               (32, 4096, 128), extra=32 * 457),
        30.60, 74.6, 0.03094, "operations"),
    # K5 at a decode chunk of 48 pairs, bytes alone (no attention shape):
    # the rows read and written once, gamma and beta of C values each.
    # HQ-SAM's `embedding_maskfeature`: LayerNorm2d(64) + GELU at 256 x 256
    "K5 HQ maskfeature": (None, _bytes((48, 256, 256, 64), (64,), (64,),
                                       (48, 256, 256, 64)),
                          None, 805.3, 0.2404, "bytes"),
    # the upscaling's LayerNorm2d(64) + GELU at 128 x 128
    "K5 upscaling": (None, _bytes((48, 128, 128, 64), (64,), (64,),
                                  (48, 128, 128, 64)),
                     None, 201.3, 0.0601, "bytes"),
    # the two-way transformer's norm4 over the image's 4096 rows of 256
    "K5 norm4": (None, _bytes((48, 4096, 256), (256,), (256,),
                              (48, 4096, 256)),
                 None, 201.3, 0.0601, "bytes"),
}


@pytest.mark.parametrize("row", list(ROWS))
def test_roofline_matches_hand_counts(row):
    shape, nbytes, gflop, mb, bound_ms, bound_by = ROWS[row]
    if shape is None:
        roof = chip_smoke.bytes_roofline(nbytes)
        assert roof["flop"] is None
    else:
        roof = chip_smoke.attention_roofline(*shape, nbytes)
        assert roof["flop"] / 1e9 == pytest.approx(gflop, abs=0.01)
    assert roof["bytes"] / 1e6 == pytest.approx(mb, abs=0.05)
    assert roof["bound_ms"] == pytest.approx(bound_ms, abs=5e-4)
    assert roof["bound_by"] == bound_by


def test_tensor_bytes_counts_each_tensor_once():
    x = torch.zeros(3, 5, dtype=torch.bfloat16)
    m = torch.zeros(7, dtype=torch.uint8)
    assert chip_smoke.tensor_bytes(x, m) == 3 * 5 * 2 + 7


def _merge_heads(x):
    """SDPA's [B, H, N, d] output as the kernels' [B, N, H*d]."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _randn(rng, *shape, std=1.0):
    return torch.from_numpy((std * rng.standard_normal(shape)
                             ).astype(np.float32))


def _case(name, rng):
    """(plain output, library output) at a small shape, float32."""
    if name in ("window", "global"):
        heads, d = 2, 16
        kh, kw = (4, 4) if name == "window" else (6, 5)
        b = 3 if name == "window" else 2
        qkv = _randn(rng, b, kh * kw, 3 * heads * d)
        rh = _randn(rng, kh, kh, d, std=0.2)
        rw = _randn(rng, kw, kw, d, std=0.2)
        kwargs = dict(scale=d ** -0.5, heads=heads)
        if name == "window":
            bias = fa.window_bias(qkv, rh, rw, heads)
            ref = fa.window_attention_plain(qkv, bias, **kwargs)
        else:
            bias = fa.global_bias(qkv, rh, rw, heads, kh, kw)
            ref = fa.global_attention_plain(qkv, bias, kh=kh, kw=kw,
                                            **kwargs)
        got = chip_smoke.library_fused_qkv(qkv, bias, kh=kh, **kwargs)()
        return ref, _merge_heads(got)
    if name == "relpos":
        b, kh, kw, d = 3, 6, 5, 16
        q, k, v = (_randn(rng, b, kh * kw, d) for _ in range(3))
        bias_h, bias_w = _randn(rng, b, kh * kw, kh), _randn(rng, b,
                                                              kh * kw, kw)
        ops = (q, k, v, bias_h, bias_w)
        ref = fa.relpos_attention_plain(*ops, scale=d ** -0.5)
        got = chip_smoke.library_relpos(*ops, scale=d ** -0.5)()
        return ref, got[:, 0]
    nq, nk = (7, 40) if name == "cross" else (40, 7)
    q = _randn(rng, 2, nq, 32)
    k, v = _randn(rng, 2, nk, 32), _randn(rng, 2, nk, 32)
    valid = None
    if name == "cross_masked":
        valid = torch.from_numpy(rng.random((2, nk)) > 0.4)
        valid[:, 0] = True
    kwargs = dict(heads=2, divisor=4.0, kv_valid=valid)
    ref = fa.cross_attention_plain(q, k, v, **kwargs)
    got = chip_smoke.library_cross(q, k, v, **kwargs)()
    return ref, _merge_heads(got)


@pytest.mark.parametrize("name", ["window", "global", "cross",
                                  "cross_masked", "cross_unmasked", "relpos"])
def test_library_yardstick_computes_the_kernels_function(name):
    ref, got = _case(name, np.random.default_rng(0))
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)



# kernel_phase's report: case -> the numbers of `chip_smoke.TIMES`.
CASES = ("window", "global", "cross", "cross_masked", "cross_unmasked",
         "relpos", "relpos_window", "window_vit_b", "global_vit_b",
         "global_crop", "cross_interactive", "cross_hq", "cross_hq_masked",
         "cross_amg", "cross_amg_masked", "cross_self", "cross_vis",
         "cross_vis_masked", *chip_smoke.LN_CASES)
CROP_LAUNCHES = {"window": 168, "global": 24, "cross": 70, "relpos": 0}
INTERACTIVE_LAUNCHES = {"window": 48, "global": 24, "cross": 15400,
                        "relpos": 0}
HQ_LAUNCHES = {"window": 168, "global": 24, "cross": 140, "relpos": 0}
VIS_LAUNCHES = {"launches": {"window": 280, "global": 40, "cross": 1420,
                            "relpos": 0},
                "amg": 160, "sam_pt": 1260, "tracked": [28, 7], "pairs": 32,
                "capacity": {"window": 84, "global": 12, "cross": 3720,
                             "relpos": 0}}
HAIKU_LAUNCHES = {"tapir": {"window": 48, "global": 24, "cross": 140,
                             "relpos": 0},
                  "tapnet": {"window": 48, "global": 24, "cross": 140,
                             "relpos": 0}}
SECOND_CASE = {"cross": ("cross_masked", "_image_to_token"),
               "relpos": ("relpos_window", "_window")}
# Cases whose errors count in a row without their times.
CHECKED_CASES = {"cross": ("cross_unmasked",)}


def _report():
    return {name: {"max_abs_err": 1e-3 * (i + 1), "bound_by": "bytes",
                   **{f: 10.0 * i + j for j, f in enumerate(chip_smoke.TIMES)
                      if f != "bound_by"}}
            for i, name in enumerate(CASES)}


@pytest.mark.parametrize("key", list(chip_smoke.KERNEL_SOURCES))
def test_kernel_json_rows_carry_both_timers(key):
    """Every row has the contract's keys and both timers of each of its
    cases (`loop_ms`, `library_loop_ms` beside `ms`, `library_ms`), taken
    from the right case; K4's launches are the route phase's."""
    report = _report()
    launches = {"window": 420, "global": 60, "cross": 280, "relpos": 0}
    rows = {r["name"]: r for r in chip_smoke.kernel_json(
        report, launches, {"relpos": 1}, {"window": 48, "global": 24},
        CROP_LAUNCHES, INTERACTIVE_LAUNCHES, hq_launches=HQ_LAUNCHES,
        vis_launches=VIS_LAUNCHES,
        haiku_launches=HAIKU_LAUNCHES)}
    row = rows[f"{key}_attention"]
    assert {"name", "route", "source", "replaces", "launches",
            "max_abs_err"} <= set(row)
    assert {"loop_ms", "library_loop_ms"} <= set(chip_smoke.TIMES)
    cases = [(key, "")] + ([SECOND_CASE[key]] if key in SECOND_CASE else [])
    for case, suffix in cases:
        for f in chip_smoke.TIMES:
            assert row[f + suffix] == report[case][f]
    checked = [c for c, _ in cases] + list(CHECKED_CASES.get(key, ()))
    assert row["max_abs_err"] == max(report[c]["max_abs_err"]
                                     for c in checked)
    assert row["launches"] == (1 if key == "relpos" else launches[key])


def test_kernel_json_layer_norm_row():
    """K5's row: the slice's launches, the worst error of its three
    cases, the HQ case's times and, suffixed, the upscaling's and
    norm4's; no row without launches."""
    report = _report()
    args = (report, {"window": 420, "global": 60, "cross": 280,
                     "relpos": 0}, {"relpos": 1},
            {"window": 48, "global": 24, "cross": 140}, CROP_LAUNCHES,
            INTERACTIVE_LAUNCHES)
    kw = dict(hq_launches=HQ_LAUNCHES, vis_launches=VIS_LAUNCHES,
              haiku_launches=HAIKU_LAUNCHES)
    assert "layer_norm" not in {
        r["name"] for r in chip_smoke.kernel_json(*args, **kw)}
    rows = {r["name"]: r for r in chip_smoke.kernel_json(
        *args, ln_launches=2410, **kw)}
    row = rows["layer_norm"]
    assert row["launches"] == 2410
    assert (row["source"], row["replaces"]) == chip_smoke.LN_SOURCE
    assert row["max_abs_err"] == max(report[c]["max_abs_err"]
                                     for c in chip_smoke.LN_CASES)
    for f in chip_smoke.TIMES:
        assert row[f] == report["layer_norm_hq"][f]
        assert row[f + "_upscaling"] == report["layer_norm_upscaling"][f]
        assert row[f + "_norm4"] == report["layer_norm_norm4"][f]


@pytest.mark.parametrize("hq", [False, True])
def test_layer_norm_schedule_counts_the_models_narrow_norms(monkeypatch, hq):
    """K5's schedule against the LayerNorm calls of a tiny SamPt's run on
    the CPU outside the ViT blocks (whose rows, 768-1280 at ViT-B/L/H,
    take PyTorch's kernel): the neck's, the prompt encoder's and the
    decoder's, 4 passes a decode chunk."""
    from sam_pt_torch.models.sam.image_encoder import LayerNorm

    monkeypatch.setattr(chip_smoke, "H", 48)
    monkeypatch.setattr(chip_smoke, "W", 80)
    sam_pt = (_tiny_variant("samhq_vit_h") if hq else _tiny_variant("sam"))
    sam_pt.sam_decode_chunk = 4
    model = sam_pt.sam_predictor.model
    blocks = set(model.image_encoder.blocks.modules())
    calls = []
    for m in model.modules():
        if isinstance(m, LayerNorm) and m not in blocks:
            m.register_forward_hook(lambda *a: calls.append(1))
    with torch.no_grad():
        sam_pt.forward(chip_smoke.make_video(6, 2, seed=0))
    assert len(calls) == chip_smoke.layer_norm_schedule(sam_pt, [6], [12])


@pytest.mark.parametrize("key", chip_smoke.VIT_B_ROWS)
def test_kernel_json_vit_b_rows(key):
    """K1 and K2 at ViT-B's shapes are rows of their own, with the
    default model's launches (and TAPIR's and TapNet's SamPt runs') and
    every key of the contract."""
    report = _report()
    rows = {r["name"]: r for r in chip_smoke.kernel_json(
        report, {"window": 420, "global": 60, "cross": 280, "relpos": 0},
        {"relpos": 1}, {"window": 48, "global": 24, "cross": 140},
        CROP_LAUNCHES, INTERACTIVE_LAUNCHES, hq_launches=HQ_LAUNCHES,
        vis_launches=VIS_LAUNCHES,
        haiku_launches=HAIKU_LAUNCHES)}
    row = rows[f"{key}_attention_vit_b"]
    assert row["launches"] == {"window": 48, "global": 24}[key]
    for name in ("tapir", "tapnet"):  # phase 19's runs, ViT-B's too
        assert row[f"launches_{name}"] == HAIKU_LAUNCHES[name][key]
    assert (row["source"], row["replaces"]) == chip_smoke.KERNEL_SOURCES[key]
    assert row["max_abs_err"] == report[f"{key}_vit_b"]["max_abs_err"]
    for f in chip_smoke.TIMES:
        assert row[f] == report[f"{key}_vit_b"][f]


@pytest.mark.parametrize("name,case,key,launches", [
    ("global_attention_crop", "global_crop", "global", 24),
    ("image_to_token_interactive", "cross_interactive", "cross", 6160)])
def test_kernel_json_rows_of_this_slice(name, case, key, launches):
    """K2 on the cropped grid with the crop phase's K2 launches, and K3
    image->token at the interactive capacity with 2 of the interactive
    run's 5 K3 launches a decoder pass, each with every key of the
    contract."""
    report = _report()
    rows = {r["name"]: r for r in chip_smoke.kernel_json(
        report, {"window": 420, "global": 60, "cross": 280, "relpos": 0},
        {"relpos": 1}, {"window": 48, "global": 24, "cross": 140},
        CROP_LAUNCHES, INTERACTIVE_LAUNCHES, hq_launches=HQ_LAUNCHES,
        vis_launches=VIS_LAUNCHES,
        haiku_launches=HAIKU_LAUNCHES)}
    row = rows[name]
    assert row["launches"] == launches
    assert (row["route"], row["source"], row["replaces"]) == (
        "cuda", *chip_smoke.KERNEL_SOURCES[key])
    assert row["max_abs_err"] == report[case]["max_abs_err"]
    for f in chip_smoke.TIMES:
        assert row[f] == report[case][f]


def test_kernel_json_hq_row():
    """K3 with the HQ token: token->image and, suffixed, image->token at
    the HQ phase's shapes, both errors counted, the HQ phase's K3
    launches (both directions, as the row says), every key of the
    contract."""
    report = _report()
    rows = {r["name"]: r for r in chip_smoke.kernel_json(
        report, {"window": 420, "global": 60, "cross": 280, "relpos": 0},
        {"relpos": 1}, {"window": 48, "global": 24, "cross": 140},
        CROP_LAUNCHES, INTERACTIVE_LAUNCHES, hq_launches=HQ_LAUNCHES,
        vis_launches=VIS_LAUNCHES,
        haiku_launches=HAIKU_LAUNCHES)}
    row = rows["cross_attention_hq"]
    assert row["launches"] == 140
    assert row["launches_of"] == "token_to_image + image_to_token"
    assert (row["route"], row["source"], row["replaces"]) == (
        "cuda", *chip_smoke.KERNEL_SOURCES["cross"])
    assert row["max_abs_err"] == max(report["cross_hq"]["max_abs_err"],
                                     report["cross_hq_masked"]["max_abs_err"])
    for f in chip_smoke.TIMES:
        assert row[f] == report["cross_hq"][f]
        assert row[f + "_image_to_token"] == report["cross_hq_masked"][f]


def test_kernel_json_amg_row():
    """K3 at the generator's batch of one-point prompts: token->image and,
    suffixed, image->token, both errors counted, the K3 launches of the
    generator's decodes in the VIS phase, every key of the contract."""
    report = _report()
    rows = {r["name"]: r for r in chip_smoke.kernel_json(
        report, {"window": 420, "global": 60, "cross": 280, "relpos": 0},
        {"relpos": 1}, {"window": 48, "global": 24, "cross": 140},
        CROP_LAUNCHES, INTERACTIVE_LAUNCHES, hq_launches=HQ_LAUNCHES,
        vis_launches=VIS_LAUNCHES,
        haiku_launches=HAIKU_LAUNCHES)}
    row = rows["cross_attention_amg"]
    assert row["launches"] == 160
    assert row["launches_of"] == "token_to_image + image_to_token"
    assert (row["route"], row["source"], row["replaces"]) == (
        "cuda", *chip_smoke.KERNEL_SOURCES["cross"])
    assert row["max_abs_err"] == max(report["cross_amg"]["max_abs_err"],
                                     report["cross_amg_masked"]["max_abs_err"])
    for f in chip_smoke.TIMES:
        assert row[f] == report["cross_amg"][f]
        assert row[f + "_image_to_token"] == report["cross_amg_masked"][f]
    assert len(rows) == 12


@pytest.mark.parametrize("name,cases,launches", [
    ("cross_attention_vis", ("cross_vis", "cross_vis_masked"), 1260),
    ("cross_attention_self", ("cross_self",), 3720)])
def test_kernel_json_vis_rows(name, cases, launches):
    """K3 at the VIS evaluate run's tracked prompts (token->image and,
    suffixed, image->token) with SamPt's K3 launches in that run, and K3
    at head dim 32 with every K3 launch of the capacity run, each row its
    own cases' errors and times and every key of the contract."""
    report = _report()
    rows = {r["name"]: r for r in chip_smoke.kernel_json(
        report, {"window": 420, "global": 60, "cross": 280, "relpos": 0},
        {"relpos": 1}, {"window": 48, "global": 24, "cross": 140},
        CROP_LAUNCHES, INTERACTIVE_LAUNCHES, hq_launches=HQ_LAUNCHES,
        vis_launches=VIS_LAUNCHES,
        haiku_launches=HAIKU_LAUNCHES)}
    row = rows[name]
    assert row["launches"] == launches and row["launches_of"]
    assert (row["route"], row["source"], row["replaces"]) == (
        "cuda", *chip_smoke.KERNEL_SOURCES["cross"])
    assert row["max_abs_err"] == max(report[c]["max_abs_err"] for c in cases)
    for f in chip_smoke.TIMES:
        assert row[f] == report[cases[0]][f]
        if len(cases) > 1:
            assert row[f + "_image_to_token"] == report[cases[1]][f]
    assert ("bound_ms_image_to_token" in row) == (len(cases) > 1)


@pytest.mark.parametrize("hq", [False, True])
def test_amg_tokens_read_from_the_code(hq, monkeypatch):
    """The decoder's tokens in a generator decode (one point, no box), as
    `Sam.decode_masks` builds them: `amg_tokens()` (7), and one more for
    HQ-SAM's token; the image->token key mask is all valid."""
    from sam_pt_torch.models.sam.mask_decoder import TwoWayTransformer
    from sam_pt_torch.models.sam.predictor import SamPredictor
    from sam_pt_torch.models.sam.sam_model import Sam
    from sam_pt_torch.utils.checkpoint import randomize_
    from sam_pt_torch.utils.testing import TINY_VIT
    from sam_pt_torch.utils.tree import tree_map

    seen = []
    forward = TwoWayTransformer.forward

    def recorded(self, image_embedding, image_pe, point_embedding,
                 token_valid=None):
        seen.append((point_embedding.shape[1], token_valid))
        return forward(self, image_embedding, image_pe, point_embedding,
                       token_valid)

    monkeypatch.setattr(TwoWayTransformer, "forward", recorded)
    sam = randomize_(Sam(TINY_VIT, image_size=64, use_hq=hq),
                     torch.Generator().manual_seed(0))
    predictor = SamPredictor(sam.eval())
    emb = predictor.encode_frames(torch.zeros((1, 48, 64, 3)), (48, 64))
    emb = tree_map(lambda e: e.expand(3, *e.shape[1:]),
                   predictor.decode_ready(emb))
    predictor.predict(emb, torch.ones((3, 1, 2)), torch.ones((3, 1)),
                      (48, 64), multimask_output=True)
    assert [n for n, _ in seen] == [chip_smoke.amg_tokens() + hq]
    assert bool(seen[0][1].all())


def test_vis_self_attention_tokens():
    """100 masks' prompts in a refinement pass: 5 output tokens, 17 points,
    16 positives of each of the 99 other masks, 2 box corners, the pad
    point: 1609 tokens, past the 1024 from which the decoder's token
    self-attention takes K3 (at head dim 32); 63 masks stay below, and
    28 (the VIS run's video 0) give 457. The VIS kernel cases lay the
    keys out so: every point valid, the pad slot masked out."""
    assert chip_smoke.vis_tokens() == 1609
    assert chip_smoke.vis_tokens(63) < 1024 <= chip_smoke.vis_tokens(64)
    assert chip_smoke.vis_tokens(28) == 457
    cases = chip_smoke.vis_kernel_cases(fa, "cpu", 2, 28)
    for name, (nq, nk, valid) in {"cross_vis": (457, 4096, 4096),
                                  "cross_vis_masked": (4096, 457, 456)
                                  }.items():
        kernel, plain, library, inputs, shape = cases[name]()
        assert inputs[0].shape == (2, nq, 128)
        assert inputs[1].shape == (2, nk, 128)
        assert shape == (16, nq, valid, 16)
        torch.testing.assert_close(_merge_heads(library()).float(),
                                   plain().float(), atol=2e-2, rtol=2e-2)


def test_vis_schedule():
    """The generator's one-frame encode and 16 decodes of 64 points a
    video, then SamPt's encode chunks and decode chain; with 70 masks the
    prompt (17 points and 16 of each other mask) passes 1024 tokens, and
    each pass's two self-attentions take K3 too."""
    from types import SimpleNamespace

    from sam_pt_torch.models.sam.auto_mask_generator import build_point_grid
    from sam_pt_torch.models.sam.image_encoder import VIT_VARIANTS

    cfg = VIT_VARIANTS["vit_h"]
    encoder = SimpleNamespace(blocks=[None] * cfg["depth"],
                              global_attn_indexes=cfg["global_attn_indexes"])
    sam_pt = SimpleNamespace(
        sam_encode_chunk=4, sam_decode_chunk=32,
        iterative_refinement_iterations=12, positive_points_per_mask=16,
        negative_points_per_mask=1,
        add_other_objects_positive_points_as_negative_points=True,
        sam_predictor=SimpleNamespace(model=SimpleNamespace(
            image_encoder=encoder)))
    adapter = SimpleNamespace(model=sam_pt, sam_generator=SimpleNamespace(
        point_grids=[build_point_grid(32)], points_per_batch=64))
    assert chip_smoke.vis_schedule(adapter, [(16, 3), (16, 70)]) == {
        "window": 28 * (2 + 8), "global": 4 * (2 + 8),
        "cross": 5 * 16 * 2 + 5 * 14 * (2 + 35) + 2 * 14 * 35,
        "relpos": 0}
    # a video with no proposal runs the generator only
    assert chip_smoke.vis_schedule(adapter, [(16, 0)]) == {
        "window": 28, "global": 4, "cross": 80, "relpos": 0}


def test_vis_tree(tmp_path):
    """The VIS phase's tree at full size: UVO v1's tiny-split layout, 2-3
    moving textured shapes a video, ground-truth tracks as RLE that decode
    to the shapes."""
    from sam_pt_torch.vis_eval.datasets import VISDataset, resolve_dataset
    from sam_pt_torch.vis_eval.rle import decode_mask

    json_file, image_root, gt = chip_smoke.make_vis_tree(str(tmp_path),
                                                         frames=3)
    assert resolve_dataset("uvo_v1_val_tiny", str(tmp_path))[:2] == (
        json_file, image_root)
    dataset = VISDataset(json_file, image_root, True)
    assert len(dataset) == chip_smoke.VIS_VIDEOS
    counts = [sum(a["video_id"] == v["id"] for a in gt["annotations"])
              for v in gt["videos"]]
    assert counts == [2, 3]
    video = dataset.load_video(dataset.videos[0])
    assert video["image"].shape == (3, chip_smoke.H, chip_smoke.W, 3)
    frames, masks = chip_smoke.vis_frames(3, seed=20)
    np.testing.assert_array_equal(video["image"], frames)
    for k, ann in enumerate(a for a in gt["annotations"]
                            if a["video_id"] == 1):
        for t, seg in enumerate(ann["segmentations"]):
            np.testing.assert_array_equal(decode_mask(seg), masks[t, k])
        assert masks[0, k].sum() > 1000
        assert not np.array_equal(masks[0, k], masks[-1, k])  # they move
    assert not (masks[:, 0] & masks[:, 1]).any()


def test_hq_shapes_stay_on_the_image_to_token_kernel():
    """42 token keys in the HQ phase's refinement passes, the pad slot
    masked: at most 64 keys, K3's image->token kernel takes them."""
    assert chip_smoke.hq_tokens() == 42 <= 64
    valid = chip_smoke.hq_key_mask(2, "cpu")
    assert valid.shape == (2, 42) and int(valid[0].sum()) == 41
    assert not valid[0, -1]


def test_launch_schedule_of_tiny_vit():
    """TinyViT runs no kernel: K3 only."""
    from types import SimpleNamespace

    from sam_pt_torch.models.sam.tiny_vit import TinyViT

    sam_pt = SimpleNamespace(
        sam_encode_chunk=4, sam_decode_chunk=32,
        iterative_refinement_iterations=12,
        sam_predictor=SimpleNamespace(model=SimpleNamespace(
            image_encoder=TinyViT(img_size=64))))
    assert chip_smoke.launch_schedule(sam_pt, [24], [48]) == {
        "window": 0, "global": 0, "cross": 140, "relpos": 0}


def test_shapes_of_this_slice():
    """The crop leaves 36 x 64 tokens of a 480 x 854 frame (resized to
    576 x 1024) and 15 windows; the interactive prompt holds the default
    model's 17 points and the 300 interactions of the default budget, so
    a refinement pass's image->token call has 325 keys, laid out as
    `Sam.decode_masks` masks them."""
    assert chip_smoke.crop_grid() == (36, 64)
    assert chip_smoke.window_count(36, 64) == 15
    assert chip_smoke.interactive_capacity() == 317
    assert chip_smoke.interactive_tokens() == 325
    valid = chip_smoke.interactive_key_mask(2, "cpu")
    assert valid.shape == (2, 325) and int(valid[0].sum()) == 42
    assert valid[0, :40].all() and not valid[0, 40:322].any()
    assert valid[0, 322:324].all() and not valid[0, 324]


def test_interactive_and_one_point_schedules():
    """K1/K2 per encode chunk; K3 5 per pass of each decode chain the
    interactive model ran, and one pass per object's query frame on the
    one-point run."""
    from types import SimpleNamespace

    encoder = SimpleNamespace(blocks=[None] * 12,
                              global_attn_indexes=(2, 5, 8, 11))
    sam_pt = SimpleNamespace(
        sam_encode_chunk=4, sam_decode_chunk=32,
        iterative_refinement_iterations=12, chain_calls=220,
        sam_predictor=SimpleNamespace(model=SimpleNamespace(
            image_encoder=encoder)))
    assert chip_smoke.interactive_schedule(sam_pt, [12, 12]) == {
        "window": 48, "global": 24, "cross": 15400, "relpos": 0}
    assert chip_smoke.one_point_schedule(sam_pt, 12, 2) == {
        "window": 40, "global": 20, "cross": 80, "relpos": 0}


@pytest.mark.parametrize("variant,window,global_", [("vit_b", 8, 4),
                                                    ("vit_h", 28, 4)])
def test_launch_schedule_reads_the_model(variant, window, global_):
    """Per encode chunk one K1 a window block and one K2 a global block;
    K3 5 per decoder pass and decode chunk."""
    from types import SimpleNamespace

    from sam_pt_torch.models.sam.image_encoder import VIT_VARIANTS

    cfg = VIT_VARIANTS[variant]
    encoder = SimpleNamespace(blocks=[None] * cfg["depth"],
                              global_attn_indexes=cfg["global_attn_indexes"])
    sam_pt = SimpleNamespace(
        sam_encode_chunk=4, sam_decode_chunk=32,
        iterative_refinement_iterations=12,
        sam_predictor=SimpleNamespace(model=SimpleNamespace(
            image_encoder=encoder)))
    got = chip_smoke.launch_schedule(sam_pt, [24], [48])
    assert got == {"window": 6 * window, "global": 6 * global_,
                   "cross": 5 * 14 * 2, "relpos": 0}


def test_cli_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """The CLI phase end to end on the CPU at a small size, with the tiny
    SamPt: the tree, `evaluate`'s outputs, the written masks against the
    direct forward pixel for pixel, the timed run and the entry point as
    a subprocess. The plain paths launch no kernel here, so the schedule
    is the counts' zeros."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "H", 48)
    monkeypatch.setattr(chip_smoke, "W", 80)
    monkeypatch.setattr(chip_smoke, "CLI_FRAMES", 5)
    monkeypatch.setattr(chip_smoke, "launch_schedule",
                        lambda *a: {k: 0 for k in fa.LAUNCHES})
    chip_smoke.cli_phase(fa, "the CPU", model=(
        "device=cpu", "model=sam_pt_tiny_test", "size=-1"))
    out = capsys.readouterr().out
    for line in ("evaluate wrote [5, 5] PNGs", "video0: 5 written masks "
                 "equal", "labels [0, 2, 5]", "exit 0", "Model on cpu"):
        assert line in out
    assert "FAIL" not in out


def test_cli_tree_labels_and_boxes(tmp_path):
    """The CLI phase's tree at full size: two moving boxes a frame, the
    second video's labelled 2 and 5, in the DAVIS-2017 layout."""
    names = chip_smoke.make_davis_tree(str(tmp_path))
    ann = tmp_path / "trainval" / "Annotations" / "480p"
    for name, labels in zip(names, chip_smoke.CLI_LABELS):
        files = sorted(os.listdir(ann / name))
        assert len(files) == chip_smoke.CLI_FRAMES
        first, palette = read_index_mask(str(ann / name / files[0]))
        last, _ = read_index_mask(str(ann / name / files[-1]))
        assert first.shape == (chip_smoke.H, chip_smoke.W)
        assert set(np.unique(first)) == {0, *labels}
        assert not np.array_equal(first, last)  # the boxes move
        assert palette == chip_smoke.CLI_PALETTE
    assert (tmp_path / "trainval" / "ImageSets" / "2017" / "val.txt"
            ).read_text().split() == names


def _rehearsal(monkeypatch, frames=None):
    """Stubs for a phase's run on the CPU at 48 x 80: no synchronisation,
    no profiler device time, the schedules as the CPU's zero counts (the
    plain paths launch no kernel)."""
    zeros = {k: 0 for k in fa.LAUNCHES}
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "H", 48)
    monkeypatch.setattr(chip_smoke, "W", 80)
    for name in ("launch_schedule", "interactive_schedule",
                 "one_point_schedule", "vis_schedule"):
        monkeypatch.setattr(chip_smoke, name, lambda *a: dict(zeros))
    monkeypatch.setattr(chip_smoke, "profiled_ms",
                        lambda fn, calls=20: (fn(), 1.0)[1])
    if frames:
        monkeypatch.setattr(chip_smoke, "INTERACTIVE_FRAMES", frames)


def test_patch_filter_and_crop_phases_rehearsed_on_the_cpu(monkeypatch,
                                                           capsys):
    """Phases 12 and 13 on the CPU with the tiny SamPt at the main path's
    17 points: every kind of patch flag, the card-vs-CPU comparison (here
    the CPU against itself), the crop's zero pad rows and its reference
    check."""
    from sam_pt_torch.utils.testing import build_tiny_sam_pt
    from sam_pt_torch.vos_eval.eval import device_fuse_index_masks

    _rehearsal(monkeypatch)
    sam_pt = build_tiny_sam_pt(device="cpu", positive_points_per_mask=16,
                               negative_points_per_mask=1,
                               iterative_refinement_iterations=2)
    chip_smoke.patch_filter_phase(sam_pt, fa, device_fuse_index_masks,
                                  "the CPU")
    launches = chip_smoke.crop_phase(sam_pt, fa, device_fuse_index_masks,
                                     "the CPU")
    out = capsys.readouterr().out
    assert launches == {k: 0 for k in fa.LAUNCHES}
    for line in ("flags equal on 17/17 points", "crop reference: encoder",
                 "global blocks 12 of 16 tokens"):
        assert line in out
    assert "FAIL" not in out
    assert not sam_pt.use_patch_matching_filtering
    assert not sam_pt.sam_predictor.model.crop_pad_tokens


def test_interactive_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """Phase 14 on the CPU at 4 frames with the tiny SamPt as a
    SamPtInteractive: the histories and pickles, the budget, the written
    masks against the direct forward pixel for pixel, then the one-point
    run."""
    _rehearsal(monkeypatch, frames=4)
    chip_smoke.interactive_phase(
        fa, "the CPU", model=("device=cpu", "model=sam_pt_tiny_test",
                              "size=-1"),
        interactive=("+model.interactive=true", "+model.online=true",
                     "+model.interactions_max_per_frame=3"))
    out = capsys.readouterr().out
    for line in ("histories and pickles written", "4 written masks equal "
                 "the direct forward's", "one point: launches"):
        assert line in out
    assert "FAIL" not in out


def _tiny_variant(name):
    """The tiny SamPt with the SAM of a variant config in its place: the
    tiny ViT (HQ-SAM's decoder for `samhq_*`) or TinyViT at 64 pixels."""
    from sam_pt_torch.models.sam.predictor import SamPredictor
    from sam_pt_torch.models.sam.sam_model import Sam
    from sam_pt_torch.models.batch_norm import reset_batch_norm_stats_
    from sam_pt_torch.utils.checkpoint import randomize_
    from sam_pt_torch.utils.testing import TINY_VIT, build_tiny_sam_pt

    sam_pt = build_tiny_sam_pt(device="cpu", positive_points_per_mask=16,
                               negative_points_per_mask=1,
                               iterative_refinement_iterations=2)
    encoder = "vit_t" if name.endswith("vit_tiny") else TINY_VIT
    sam = Sam(encoder, image_size=64, use_hq=name.startswith("samhq"))
    sam = randomize_(sam, torch.Generator().manual_seed(0))
    sam_pt.sam_predictor = SamPredictor(
        reset_batch_norm_stats_(sam).eval().requires_grad_(False))
    chip_smoke.bias_for_a_live_run(sam_pt)
    return sam_pt


def test_variant_phases_rehearsed_on_the_cpu(monkeypatch, capsys):
    """Phases 15 and 16 on the CPU with tiny stand-ins for HQ-SAM ViT-H,
    ViT-B, MobileSAM and Light HQ-SAM: launches, output checks, the
    reference checks (`interm` included), TinyViT against float32 and the
    encode times in turns."""
    from sam_pt_torch.vos_eval.eval import device_fuse_index_masks

    _rehearsal(monkeypatch)
    monkeypatch.setattr(chip_smoke, "compose_model", _tiny_variant)
    launches = chip_smoke.hq_phase(fa, device_fuse_index_masks, "the CPU",
                                   False)
    found = chip_smoke.mobile_phase(fa, device_fuse_index_masks, "the CPU",
                                    False)
    out = capsys.readouterr().out
    assert launches == {k: 0 for k in fa.LAUNCHES}
    assert set(found) == {"sam_mobile_vit_tiny", "samhq_light_vit_tiny"}
    for line in ("hq reference: encoder embeddings kernels vs plain rel_l2 "
                 "emb", "interm", "TinyViT bf16 vs float32 weights",
                 "TinyViT / ViT-B", "samhq_light_vit_tiny: timed pass"):
        assert line in out
    assert "FAIL" not in out


def test_demo_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """Phase 17 on the CPU with the tiny SamPt, 4 frames at 48 x 80 and
    no resize: main's overlays, its masks and tracks against the direct
    forward, the `python -m` entry point as a subprocess."""
    _rehearsal(monkeypatch)
    monkeypatch.setattr(chip_smoke, "DEMO_FRAMES", 4)
    launches = chip_smoke.demo_phase(fa, "the CPU", model=(
        "device=cpu", "model=sam_pt_tiny_test", "longest_side_length=null"))
    out = capsys.readouterr().out
    assert launches == {k: 0 for k in fa.LAUNCHES}
    for line in ("demo: main over 4 PNG frames 48 x 80 resized to 48 x 80",
                 "4 frames written", "equal the direct forward's: True",
                 "python -m sam_pt_torch.demo exit 0",
                 "Inference: 4 frames"):
        assert line in out
    assert "FAIL" not in out


def test_vis_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """Phase 18 on the CPU with the tiny SAM shared by the generator and
    the tiny SamPt, 3 frames at 48 x 80, the config's own gates: the tree,
    the live weights, `evaluate`, SamPt's first decode chunk against the
    plain route, the records against a direct adapter call pixel for
    pixel, the stage split, the capacity run (100 masks) and the
    `python -m` entry point as a subprocess."""
    _rehearsal(monkeypatch)
    monkeypatch.setattr(chip_smoke, "VIS_FRAMES", 3)
    monkeypatch.setattr(chip_smoke, "device_profile", lambda *a: None)
    launches = chip_smoke.vis_phase(fa, "the CPU", model=(
        "device=cpu", "model/sam@sam_shared=sam_tiny_test",
        "model@vos_model=sam_pt_tiny_test"), profiling=True)
    out = capsys.readouterr().out
    zeros = {k: 0 for k in fa.LAUNCHES}
    assert launches == {"launches": zeros, "amg": 0, "sam_pt": 0,
                        "capacity": zeros, "pairs": 16,
                        "tracked": launches["tracked"]}
    assert len(launches["tracked"]) == 2
    for line in ("vis: wrote the UVO-format tree (2 videos x 3 PNG frames "
                 "48 x 80, 5 ground-truth tracks", "shared by the generator",
                 "a 32^2 grid in batches of 64, 100 masks, tracker batch 100",
                 "tracks, the written records equal a direct adapter "
                 "call's with the rng reset: True",
                 "decodes to the downloaded masks: True", "profile vis:",
                 "generator host", "scoring", "candidates passed both gates",
                 "vis SamPt (video 0's first chunk", "vis capacity: video "
                 "0's first 3 frames, box NMS threshold 1: 100 tracks",
                 "vis capacity SamPt (its first chunk, 16 pairs)",
                 "python -m sam_pt_torch.vis_eval.eval"
                 " (1 video, random weights as built) exit 0",
                 "vis: the phase took"):
        assert line in out
    assert "FAIL" not in out



def test_helpers_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """Phase 3b on the CPU at 48 x 80 with the tiny CoTracker tracker
    (float32) in place of the main path's: `evaluate_batch` against
    `forward`, `unpack_results`, and the box embeddings and nearest
    resizes and samples against themselves, one `helpers:` line."""
    from sam_pt_torch.models.tracker.cotracker.model import CoTracker
    from sam_pt_torch.models.tracker.cotracker.tracker import (
        CoTrackerPointTracker,
    )
    from sam_pt_torch.utils.checkpoint import randomize_
    from torch_port_helpers import TINY_COTRACKER, TINY_TRACKER

    _rehearsal(monkeypatch)

    def tiny(device):
        g = torch.Generator(device=device).manual_seed(0)
        model = randomize_(CoTracker(**TINY_COTRACKER).to(device), g)
        return CoTrackerPointTracker(
            model=model.eval().requires_grad_(False), **TINY_TRACKER)

    monkeypatch.setattr(chip_smoke, "build_main_cotracker", tiny)
    chip_smoke.helpers_phase(torch.device("cpu"), "the CPU")
    out = capsys.readouterr().out
    assert ("packed outputs bit-equal to forward's, 16 records" in out
            and "resize_nearest logits equal, resize_nearest mask equal, "
                "grid_sample_nearest equal to the CPU's" in out
            and "(OK at 6.10352e-05 + 6.10352e-05 |ref|)" in out), out
