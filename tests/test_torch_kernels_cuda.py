"""The port's CUDA kernels K1/K2/K3/K4 against their plain PyTorch versions
on the card, in bfloat16 at the main path's shapes (ViT-H windows and global
blocks, 48 decoder pairs, both K3 directions also at ragged shapes and
at the automatic mask generator's 64 pairs x 7 tokens and the VIS path's
tracked prompts (32 pairs x 455 and 457 tokens), token -> image also
at head dim 32 (the decoder's self-attention from 1024 tokens); K4 at
ViT-H global width and over ViT-H windows; the window body also at head
dims 64 and 128 and over small, rectangular and ragged windows; the flash
body also at ViT-B/L widths, on ragged grids and at head dims 16 and
128). Needs a CUDA device; skipped without one. This
file imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerance, as in chip_smoke.py: |got - ref| <= 1e-2 + 2^-6 |ref|. Both
sides normalise p before rounding it to bf16 and round the output once;
f32 sums in another order and ex2.approx may tip a rounding (one output
ulp is up to 2^-7 relative), so two ulps, plus 1e-2 for values near zero.
K4's two routes through one `Attention` agree within 1e-2 relative L2
(the same body, bias einsums in two layouts).
"""
import pytest
import torch

from sam_pt_torch.ops import flash_attention as fa

ATOL, RTOL = 1e-2, 2 ** -6

# K3 cases: name -> (nq, nk, key mask, divisor); 48 pairs, 8 heads x 16.
# The key mask: False (none), True (random, key 0 valid) or "pair" (random,
# and every key of pair 0 masked: its p is uniform over its nk keys).
K3_CASES = {
    "token_to_image": (60, 4096, False, 4.0),
    "image_to_token": (4096, 60, True, 4.0),
    "token_to_image_masked": (60, 4096, True, 4.0),
    "token_to_image_divisor_3": (60, 4096, False, 3.0),
    **{f"token_to_image_nq{nq}_nk{nk}": (nq, nk, False, 4.0)
       for nq in (1, 17, 64, 65, 130) for nk in (4096, 4000)},
    "image_to_token_unmasked": (4096, 60, False, 4.0),
    "image_to_token_divisor_3": (4096, 60, True, 3.0),
    "image_to_token_unmasked_divisor_3": (4096, 60, False, 3.0),
    # 65 and 130 keys take the token -> image kernel's two passes
    **{f"image_to_token_nk{nk}": (4096, nk, True, 4.0)
       for nk in (1, 5, 17, 64, 65, 130)},
    **{f"image_to_token_nq{nq}": (nq, 60, True, 4.0) for nq in (4000, 4097)},
    "image_to_token_all_masked_pair": (4096, 60, "pair", 4.0),
}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, std=1.0):
    return (std * torch.randn(shape, generator=gen, device="cuda")).bfloat16()


def _close(got, ref):
    torch.testing.assert_close(got.float(), ref.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("heads,d,win", [(16, 80, 14), (12, 64, 14),
                                             (16, 80, 7), (16, 80, 6)])
    def test_window_k1(self, gen, heads, d, win):
        """ViT-H's heads (16 x 80) and ViT-B/L's head dim (12 x 64) over
        14 x 14 windows (196 tokens, a ragged last 16-row tile), and small
        windows: 7 x 7 (49 tokens, 4 row tiles, one for each of the 4
        warps) and 6 x 6 (36 tokens, 3 tiles: one warp has no tile, skips
        its scores and output and still reaches the barrier for v)."""
        qkv = _randn(gen, 100, win * win, 3 * heads * d)
        rh, rw = _randn(gen, win, win, d, std=0.2), _randn(gen, win, win, d,
                                                           std=0.2)
        bias = fa.window_bias(qkv, rh, rw, heads)
        kw = dict(scale=d ** -0.5, heads=heads)
        _close(fa.window_attention_cuda(qkv, bias, **kw),
               fa.window_attention_plain(qkv, bias, **kw))

    def test_window_body_two_blocks_per_sm(self, gen):
        """At ViT-H's 14 x 14 x 80 the window body's shared memory (88 KB)
        and registers leave room for two blocks on an SM."""
        from sam_pt_torch.ops._cuda import library

        assert library().sam_window_blocks_per_sm(14, 14, 80) == 2

    def test_flash_body_one_block_per_sm(self, gen):
        """At ViT-H's 64 x 64 x 80 the flash body's 512 threads and its
        ring of k/v stages fill an SM with one block."""
        from sam_pt_torch.ops._cuda import library

        assert library().sam_flash_blocks_per_sm(64, 64, 80) == 1

    def test_cross_image_to_token_four_blocks_per_sm(self, gen):
        """At SAM's 8 heads x 16 K3 image->token's 34 KB of shared memory
        a block and at most 64 registers a thread leave room for four
        blocks on an SM, with and without the key mask."""
        from sam_pt_torch.ops._cuda import library

        for masked in (True, False):
            assert library().sam_cross_i2t_blocks_per_sm(8, masked, True) == 4

    def test_global_k2(self, gen):
        qkv = _randn(gen, 1, 4096, 3 * 16 * 80)
        rh, rw = _randn(gen, 64, 64, 80, std=0.2), _randn(gen, 64, 64, 80,
                                                          std=0.2)
        bias = fa.global_bias(qkv, rh, rw, 16, 64, 64)
        kw = dict(scale=80 ** -0.5, heads=16, kh=64, kw=64)
        _close(fa.global_attention_cuda(qkv, bias, **kw),
               fa.global_attention_plain(qkv, bias, **kw))

    @pytest.mark.parametrize("heads,d,kh,kw", [
        (12, 64, 64, 64), (16, 64, 64, 64), (16, 80, 40, 50)])
    def test_global_k2_widths_and_grids(self, gen, heads, d, kh, kw):
        """The flash body at ViT-B's and ViT-L's heads (12 and 16 x 64)
        over 64 x 64 tokens, and on a 40 x 50 grid (2000 tokens: neither a
        multiple of the 128-row query tile nor of the 64-key tile, and
        bias_w is no 64-key row: the gathered-bias route)."""
        qkv = _randn(gen, 2, kh * kw, 3 * heads * d)
        rh, rw = _randn(gen, kh, kh, d, std=0.2), _randn(gen, kw, kw, d,
                                                          std=0.2)
        bias = fa.global_bias(qkv, rh, rw, heads, kh, kw)
        kwa = dict(scale=d ** -0.5, heads=heads, kh=kh, kw=kw)
        _close(fa.global_attention_cuda(qkv, bias, **kwa),
               fa.global_attention_plain(qkv, bias, **kwa))

    @pytest.mark.parametrize("case", list(K3_CASES))
    def test_cross_k3(self, gen, case):
        """k and v distinct (a kernel that swapped them would fail), both
        directions at the decoder's shapes, over ragged query and key
        counts (image -> token also past one 64-key tile), with and
        without a key mask (image -> token also with a pair whose keys are
        all masked) and with a divisor that is no power of two."""
        nq, nk, masked, divisor = K3_CASES[case]
        q = _randn(gen, 48, nq, 128)
        k, v = _randn(gen, 48, nk, 128), _randn(gen, 48, nk, 128)
        kw = dict(heads=8, divisor=divisor)
        valid = None
        if masked:
            valid = torch.rand((48, nk), generator=gen, device="cuda") > 0.3
            valid[:, 0] = True
            if masked == "pair":
                valid[0] = False
        got = fa.cross_attention_cuda(
            q, k, v, kv_valid=None if valid is None else valid.to(
                torch.uint8), **kw)
        _close(got, fa.cross_attention_plain(q, k, v, kv_valid=valid, **kw))

    @pytest.mark.parametrize("direction", ["token_to_image",
                                           "image_to_token"])
    def test_cross_k3_generator_shape(self, gen, direction):
        """K3 at the automatic mask generator's decode: 64 one-point
        prompts, 7 tokens (5 output tokens, the point, the pad point)
        against 4096 image tokens; image -> token with the decoder's key
        mask, every token valid."""
        b, nt = 64, 7
        nq, nk = (nt, 4096) if direction == "token_to_image" else (4096, nt)
        q = _randn(gen, b, nq, 128)
        k, v = _randn(gen, b, nk, 128), _randn(gen, b, nk, 128)
        kw = dict(heads=8, divisor=4.0)
        valid = None
        if direction == "image_to_token":
            valid = torch.ones((b, nk), dtype=torch.bool, device="cuda")
        got = fa.cross_attention_cuda(
            q, k, v, kv_valid=None if valid is None else valid.to(
                torch.uint8), **kw)
        _close(got, fa.cross_attention_plain(q, k, v, kv_valid=valid, **kw))

    @pytest.mark.parametrize("direction", ["token_to_image",
                                           "image_to_token"])
    @pytest.mark.parametrize("nt", [455, 457])
    def test_cross_k3_vis_prompt_shape(self, gen, direction, nt):
        """K3 at the VIS path's tracked prompts: a decode chunk of 32
        pairs, 28 masks' prompts (5 output tokens, 17 points, 16 positives
        of each of 27 other masks, the pad; 2 box corners more in a
        refinement pass) against 4096 image tokens; image -> token (on
        the token -> image kernel above 64 keys) with the pad slot masked
        out."""
        b = 32
        nq, nk = (nt, 4096) if direction == "token_to_image" else (4096, nt)
        q = _randn(gen, b, nq, 128)
        k, v = _randn(gen, b, nk, 128), _randn(gen, b, nk, 128)
        kw = dict(heads=8, divisor=4.0)
        valid = None
        if direction == "image_to_token":
            valid = torch.ones((b, nk), dtype=torch.bool, device="cuda")
            valid[:, -1] = False
        got = fa.cross_attention_cuda(
            q, k, v, kv_valid=None if valid is None else valid.to(
                torch.uint8), **kw)
        _close(got, fa.cross_attention_plain(q, k, v, kv_valid=valid, **kw))

    @pytest.mark.parametrize("nt,masked", [(1609, True), (1024, False),
                                           (1100, True)])
    def test_cross_k3_head_dim_32(self, gen, nt, masked):
        """K3 at head dim 32 (the token -> image kernel): the decoder's
        token self-attention over 1024 tokens or more, as 100 masks'
        prompts give it, 8 heads, divisor sqrt(32), with and without the
        key mask, over token counts past and off a 64-row tile."""
        x, k, v = (_randn(gen, 32, nt, 256) for _ in range(3))
        kw = dict(heads=8, divisor=32 ** 0.5)
        valid = None
        if masked:
            valid = torch.rand((32, nt), generator=gen, device="cuda") > 0.3
            valid[:, 0] = True
        got = fa.cross_attention_cuda(
            x, k, v, kv_valid=None if valid is None else valid.to(
                torch.uint8), **kw)
        _close(got, fa.cross_attention_plain(x, k, v, kv_valid=valid, **kw))

    @pytest.mark.parametrize("b,kh,kw,d", [
        (64, 64, 64, 80), (2, 16, 70, 80), (64, 15, 15, 80),  # flash
        (16, 64, 64, 16), (16, 64, 64, 128),
        (1600, 14, 14, 80), (64, 7, 20, 80), (64, 10, 10, 80),  # window
        (64, 4, 5, 80), (64, 14, 14, 128)])
    def test_relpos_k4(self, gen, b, kh, kw, d):
        """The flash body (ViT-H global width; a rectangle with a ragged
        last q- and k-tile; 225 tokens, just above the window body; head
        dims 16 and 128 over 64 x 64, the least and the most it takes) and
        the window body (ViT-H windows; a 7 x 20 rectangle; 100 tokens, no
        multiple of 16; 20 tokens, 2 row tiles for 4 warps; head dim 128,
        one block per SM)."""
        q, k, v = (_randn(gen, b, kh * kw, d) for _ in range(3))
        rq = q.reshape(b, kh, kw, d)
        bias_h = torch.einsum("bhwc,hkc->bhwk", rq,
                              _randn(gen, kh, kh, d, std=0.2))
        bias_w = torch.einsum("bhwc,wkc->bhwk", rq,
                              _randn(gen, kw, kw, d, std=0.2))
        ops = (q, k, v, bias_h.reshape(b, -1, kh).contiguous(),
               bias_w.reshape(b, -1, kw).contiguous())
        _close(fa.relpos_attention_cuda(*ops, scale=d ** -0.5),
               fa.relpos_attention_plain(*ops, scale=d ** -0.5))

    def test_attention_default_route_runs_k4(self, gen):
        from sam_pt_torch.models.sam.image_encoder import Attention

        torch.manual_seed(0)
        raw = Attention(160, 2, (32, 32), raw_qkv=True)
        default = Attention(160, 2, (32, 32))
        with torch.no_grad():
            for p in raw.parameters():
                p.normal_(0, 0.1)
        default.load_state_dict(raw.state_dict())
        x = _randn(gen, 2, 1024, 160)
        fa.reset_launch_counts()
        with torch.no_grad():
            ref = raw.cuda().bfloat16()(x, (32, 32)).float()
            got = default.cuda().bfloat16()(x, (32, 32)).float()
        torch.cuda.synchronize()
        assert fa.LAUNCHES["global"] == 1 and fa.LAUNCHES["relpos"] == 1
        assert float((got - ref).norm() / ref.norm()) < 1e-2

    def test_cuda_tensors_launch_or_raise(self, gen):
        """A CUDA tensor never takes the plain path: the wrapper launches
        (and counts) the kernel, or raises on what the kernel does not
        take."""
        q = _randn(gen, 2, 8, 32)
        kv = _randn(gen, 2, 1024, 32)
        fa.reset_launch_counts()
        out = fa.cross_attention(q, kv, kv, heads=2, divisor=4.0)
        torch.cuda.synchronize()
        assert out.is_cuda and fa.LAUNCHES["cross"] == 1
        with pytest.raises(TypeError):
            fa.cross_attention(q.float(), kv.float(), kv.float(), heads=2,
                               divisor=4.0)
        assert fa.LAUNCHES["cross"] == 1
