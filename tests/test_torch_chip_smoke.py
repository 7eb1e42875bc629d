"""The kernel phase's arithmetic in `chip_smoke.py`, on the CPU: the
roofline bound of each kernel case against counts made by hand from the
main path's shapes, the library yardsticks (one
`scaled_dot_product_attention` call each) against the plain version of the
kernel they stand beside, in float32 at small shapes, and the kernel JSON
line's rows.

Tolerance of the yardsticks: 1e-5 absolute and relative. Both sides compute
the same softmax attention in float32 (the plain versions' bf16 roundings
are no-ops in float32) and differ only in summation order.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from sam_pt_torch.ops import flash_attention as fa

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
    "K4 window": ((1600, 196, 196, 80),
                  _bytes(*[(1600, 196, 80)] * 3, *[(1600, 196, 14)] * 2,
                         (1600, 196, 80)),
                  19.67, 218.3, 0.0652, "bytes"),
}


@pytest.mark.parametrize("row", list(ROWS))
def test_roofline_matches_hand_counts(row):
    shape, nbytes, gflop, mb, bound_ms, bound_by = ROWS[row]
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
         "relpos", "relpos_window")
SECOND_CASE = {"cross": ("cross_masked", "_image_to_token"),
               "relpos": ("relpos_window", "_window")}
# Cases whose error counts in a row without their times.
CHECKED_CASE = {"cross": "cross_unmasked"}


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
        report, launches, {"relpos": 1})}
    row = rows[f"{key}_attention"]
    assert {"name", "route", "source", "replaces", "launches",
            "max_abs_err"} <= set(row)
    assert {"loop_ms", "library_loop_ms"} <= set(chip_smoke.TIMES)
    cases = [(key, "")] + ([SECOND_CASE[key]] if key in SECOND_CASE else [])
    for case, suffix in cases:
        for f in chip_smoke.TIMES:
            assert row[f + suffix] == report[case][f]
    checked = [c for c, _ in cases] + (
        [CHECKED_CASE[key]] if key in CHECKED_CASE else [])
    assert row["max_abs_err"] == max(report[c]["max_abs_err"]
                                     for c in checked)
    assert row["launches"] == (1 if key == "relpos" else launches[key])
