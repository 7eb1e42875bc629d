"""The yardstick's arithmetic against hand counts at ViT-H's and ViT-B's
shapes: the kernels' operations, bytes and bounds, the encoder's and
decoder's model FLOPs and the launch schedule."""
import pytest

from benchmark.harness import flops, registry

MB = 1e6


def _config(name):
    return registry.Cell(name).config


@pytest.mark.parametrize("launch, args, gflop, mbytes, bound_ms, by", [
    # K1 at ViT-H: 100 windows of 196 tokens, 16 heads x 80; qkv, bias, out
    ("window", (100, 196, 16, 80), 19.67,
     2 * (100 * 196 * 3840 + 100 * 196 * 16 * 28 + 100 * 196 * 1280) / MB,
     0.0652, "bytes"),
    # K2 at ViT-H: 4 frames of 64 x 64 tokens
    ("global", (4, 64, 64, 16, 80), 343.6,
     2 * (4 * 4096 * 3840 + 4 * 4096 * 16 * 128 + 4 * 4096 * 1280) / MB,
     0.347, "operations"),
    # K1 and K2 at ViT-B: 12 heads x 64
    ("window", (100, 196, 12, 64), 11.80,
     2 * (100 * 196 * 2304 + 100 * 196 * 12 * 28 + 100 * 196 * 768) / MB,
     0.0399, "bytes"),
    ("global", (4, 64, 64, 12, 64), 206.16,
     2 * (4 * 4096 * 2304 + 4 * 4096 * 12 * 128 + 4 * 4096 * 768) / MB,
     0.2084, "operations"),
    # K3 token->image: 48 pairs, 60 tokens against 4096, 8 heads x 16
    ("cross", (48, 60, 4096, 8, 16), 6.04,
     2 * (2 * 48 * 60 * 128 + 2 * 48 * 4096 * 128) / MB, 0.0305, "bytes"),
    # K3 image->token with a key mask: 48 x 60 keys, 48 x 42 of them valid
    ("cross", (48, 4096, 60, 8, 16, 48 * 42), 4.23,
     (2 * (2 * 48 * 4096 * 128 + 2 * 48 * 60 * 128) + 48 * 60) / MB,
     0.0305, "bytes"),
])
def test_kernel_counts(launch, args, gflop, mbytes, bound_ms, by):
    roof = getattr(flops, f"{launch}_launch")(*args)
    assert roof["flop"] / 1e9 == pytest.approx(gflop, abs=0.01)
    assert roof["bytes"] / MB == pytest.approx(mbytes, rel=1e-9)
    assert roof["bound_s"] * 1e3 == pytest.approx(bound_ms, abs=5e-4)
    assert roof["bound_by"] == by


def test_vit_h_flops_by_hand():
    # patch embedding; 28 windowed blocks over 4900 padded tokens (qkv and
    # projection, q.k and p.v in 196-token windows, the rel-pos bias) with
    # the MLP over 4096; 4 global blocks over 4096; the neck
    patch = 2 * 4096 * 768 * 1280
    window = (2 * 4900 * 1280 * 5120 + 4 * 4900 * 196 * 1280
              + 2 * 4900 * 28 * 1280 + 4 * 4096 * 1280 * 5120)
    glob = (2 * 4096 * 1280 * 5120 + 4 * 4096 * 4096 * 1280
            + 2 * 4096 * 128 * 1280 + 4 * 4096 * 1280 * 5120)
    neck = 2 * 4096 * 1280 * 256 + 2 * 4096 * 256 * 256 * 9
    want = patch + 28 * window + 4 * glob + neck
    assert flops.vit_flops(_config("vith_cotracker.davis17")["sam"]) == want
    assert want / 1e12 == pytest.approx(5.96, abs=0.01)


def test_vit_b_flops_by_hand():
    patch = 2 * 4096 * 768 * 768
    window = (2 * 4900 * 768 * 3072 + 4 * 4900 * 196 * 768
              + 2 * 4900 * 28 * 768 + 4 * 4096 * 768 * 3072)
    glob = (2 * 4096 * 768 * 3072 + 4 * 4096 * 4096 * 768
            + 2 * 4096 * 128 * 768 + 4 * 4096 * 768 * 3072)
    neck = 2 * 4096 * 768 * 256 + 2 * 4096 * 256 * 256 * 9
    want = patch + 8 * window + 4 * glob + neck
    assert flops.vit_flops(_config("vitb_pips.davis17")["sam"]) == want


def test_decoder_pass_by_hand():
    # 17 prompt tokens + the pad + 5 output tokens = 23 tokens, no mask in
    t, n, d, h = 23, 4096, 256, 128

    def attn(nq, nk, i):
        return 2 * nq * d * i + 4 * nk * d * i + 4 * nq * nk * i + 2 * nq * i * d

    layers = 2 * (attn(t, t, d) + attn(t, n, h) + attn(n, t, h)
                  + 4 * t * d * 2048) + attn(t, n, h)
    upscale = 2 * 128 * 128 * 256 * 64 + 2 * 256 * 256 * 64 * 32
    heads = 2 * (2 * d * d + d * 32) + 2 * 256 * 256 * 32 + 2 * (2 * d * d + 4 * d)
    assert flops.decoder_pass_flops(18, False) == layers + upscale + heads
    mask = 2 * 128 * 128 * 4 * 4 + 2 * 64 * 64 * 16 * 16 + 2 * 64 * 64 * 16 * 256
    assert (flops.decoder_pass_flops(18, True)
            - flops.decoder_pass_flops(18, False)) == mask


@pytest.mark.parametrize("cell, frames, objects, want", [
    # ViT-H: 28 window + 4 global blocks a chunk of 4 frames; decode
    # chunks of 48 pairs, 14 passes of 5 K3 launches
    ("vith_cotracker.davis17", 35, 1, {"window": 28 * 9, "global": 4 * 9,
                                       "cross": 70, "relpos": 0}),
    ("vith_cotracker.davis17", 100, 5, {"window": 28 * 25, "global": 4 * 25,
                                        "cross": 70 * 11, "relpos": 0}),
    # ViT-B: 8 + 4 blocks; chunks of 32 pairs
    ("vitb_pips.davis17", 70, 3, {"window": 8 * 18, "global": 4 * 18,
                                  "cross": 70 * 7, "relpos": 0}),
])
def test_launch_schedule(cell, frames, objects, want):
    cfg = _config(cell)
    assert flops.launch_schedule(cfg["sam"], cfg["sam_pt"], frames,
                                 objects) == want
