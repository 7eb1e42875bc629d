"""The port's CUDA kernels K1/K2/K3/K4 against their plain PyTorch versions
on the card, in bfloat16 at the main path's shapes (ViT-H windows and global
blocks, 48 decoder pairs, K3 token -> image also at ragged shapes; K4 at
ViT-H global width and over ViT-H windows). Needs a CUDA device; skipped
without one. This
file imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerance, as in chip_smoke.py: |got - ref| <= 1e-2 + 2^-6 |ref|. Both
sides round the output to bf16 (one ulp is up to 2^-7 relative), and K2's
online softmax rounds p before normalising, so two ulps, plus 1e-2 for
values near zero. K4's two routes through one `Attention` agree within
1e-2 relative L2 (the same body, bias einsums in two layouts).
"""
import pytest
import torch

from sam_pt_torch.ops import flash_attention as fa

ATOL, RTOL = 1e-2, 2 ** -6

# K3 cases: name -> (nq, nk, key mask, divisor); 48 pairs, 8 heads x 16.
K3_CASES = {
    "token_to_image": (60, 4096, False, 4.0),
    "image_to_token": (4096, 60, True, 4.0),
    "token_to_image_masked": (60, 4096, True, 4.0),
    "token_to_image_divisor_3": (60, 4096, False, 3.0),
    **{f"token_to_image_nq{nq}_nk{nk}": (nq, nk, False, 4.0)
       for nq in (1, 17, 64, 65, 130) for nk in (4096, 4000)},
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
    def test_window_k1(self, gen):
        qkv = _randn(gen, 100, 196, 3 * 16 * 80)
        rh, rw = _randn(gen, 14, 14, 80, std=0.2), _randn(gen, 14, 14, 80,
                                                          std=0.2)
        bias = fa.window_bias(qkv, rh, rw, 16)
        kw = dict(scale=80 ** -0.5, heads=16)
        _close(fa.window_attention_cuda(qkv, bias, **kw),
               fa.window_attention_plain(qkv, bias, **kw))

    def test_global_k2(self, gen):
        qkv = _randn(gen, 1, 4096, 3 * 16 * 80)
        rh, rw = _randn(gen, 64, 64, 80, std=0.2), _randn(gen, 64, 64, 80,
                                                          std=0.2)
        bias = fa.global_bias(qkv, rh, rw, 16, 64, 64)
        kw = dict(scale=80 ** -0.5, heads=16, kh=64, kw=64)
        _close(fa.global_attention_cuda(qkv, bias, **kw),
               fa.global_attention_plain(qkv, bias, **kw))

    @pytest.mark.parametrize("case", list(K3_CASES))
    def test_cross_k3(self, gen, case):
        """k and v distinct (a kernel that swapped them would fail), both
        directions at the decoder's shapes, token -> image over ragged
        query and key counts, with a key mask and with a divisor that is
        no power of two."""
        nq, nk, masked, divisor = K3_CASES[case]
        q = _randn(gen, 48, nq, 128)
        k, v = _randn(gen, 48, nk, 128), _randn(gen, 48, nk, 128)
        kw = dict(heads=8, divisor=divisor)
        valid = None
        if masked:
            valid = torch.rand((48, nk), generator=gen, device="cuda") > 0.3
            valid[:, 0] = True
        got = fa.cross_attention_cuda(
            q, k, v, kv_valid=None if valid is None else valid.to(
                torch.uint8), **kw)
        _close(got, fa.cross_attention_plain(q, k, v, kv_valid=valid, **kw))

    @pytest.mark.parametrize("b,kh,kw", [(64, 64, 64), (1600, 14, 14),
                                         (2, 16, 70)])
    def test_relpos_k4(self, gen, b, kh, kw):
        """The flash regime (ViT-H global width; a rectangle with a ragged
        last q- and k-tile) and the whole-window regime (ViT-H windows)."""
        d = 80
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
