"""The port's CUDA kernels K1/K2/K3 against their plain PyTorch versions on
the card, in bfloat16 at the main path's shapes (ViT-H windows and global
blocks, 48 decoder pairs). Needs a CUDA device; skipped without one. This
file imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerance, as in chip_smoke.py: |got - ref| <= 1e-2 + 2^-6 |ref|. Both
sides round the output to bf16 (one ulp is up to 2^-7 relative), and K2's
online softmax rounds p before normalising, so two ulps, plus 1e-2 for
values near zero.
"""
import pytest
import torch

from sam_pt_torch.ops import flash_attention as fa

ATOL, RTOL = 1e-2, 2 ** -6


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

    @pytest.mark.parametrize("direction", ["token_to_image", "image_to_token"])
    def test_cross_k3(self, gen, direction):
        tok = _randn(gen, 48, 60, 128)
        img = _randn(gen, 48, 4096, 128)
        kw = dict(heads=8, divisor=4.0)
        if direction == "token_to_image":
            _close(fa.cross_attention_cuda(tok, img, img, **kw),
                   fa.cross_attention_plain(tok, img, img, **kw))
            return
        valid = torch.rand((48, 60), generator=gen, device="cuda") > 0.3
        valid[:, 0] = True
        _close(fa.cross_attention_cuda(img, tok, tok,
                                       kv_valid=valid.to(torch.uint8), **kw),
               fa.cross_attention_plain(img, tok, tok, kv_valid=valid, **kw))

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
