"""The port's K1/K2/K3/K4 plain versions against the JAX kernels (Pallas
interpret mode on the CPU), and the wrappers' CPU dispatch. The kernels
themselves are checked against these plain versions on the card by
test_torch_kernels_cuda.py and chip_smoke.py.

Comparisons run in float32, where the point is the algorithm: the two
sides differ only in summation order, so the tolerance is a few f32 ulps
of the O(1) outputs (2e-5 absolute after a 4096-key softmax).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_pt_torch.ops import flash_attention as fa
from sam_pt_tpu.ops import flash_attention as jfa

torch.set_num_threads(1)

F32_ATOL = 2e-5


def _rng():
    return np.random.default_rng(1234)


def _window_inputs(rng, bw=2, win=14, heads=16, d=80):
    n = win * win
    qkv = (rng.standard_normal((bw, n, 3 * heads * d)) * 0.5).astype(np.float32)
    rh = (rng.standard_normal((win, win, d)) * 0.2).astype(np.float32)
    rw = (rng.standard_normal((win, win, d)) * 0.2).astype(np.float32)
    return qkv, rh, rw


class TestPlainVersusJax:
    @pytest.mark.parametrize("heads,d", [(16, 80), (12, 64)])
    def test_window_k1_vith_shapes(self, heads, d):
        """K1 over 14 x 14 windows (BW=2, 196 tokens) at ViT-H's heads
        (16 x 80) and at ViT-B/L's head dim (12 x 64)."""
        qkv, rh, rw = _window_inputs(_rng(), heads=heads, d=d)
        scale = d ** -0.5
        ref = jfa.fused_qkv_window_attention(
            jnp.asarray(qkv), jnp.asarray(rh), jnp.asarray(rw), scale=scale,
            heads=heads)
        got = fa.window_attention(torch.from_numpy(qkv), torch.from_numpy(rh),
                                  torch.from_numpy(rw), scale=scale,
                                  heads=heads)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=F32_ATOL, rtol=0)

    def test_global_k2_native_dim_vs_padded(self):
        """K2 on a 32 x 32 grid (1024 tokens, the smallest fused size): the
        JAX kernel reads the head dim zero-padded 80 -> 128, the port the
        native 80; they agree after stripping the pad lanes."""
        rng = _rng()
        b, kh, kw, heads, d, dp = 1, 32, 32, 2, 80, 128
        n = kh * kw
        real = (rng.standard_normal((b, n, 3, heads, d)) * 0.5).astype(
            np.float32)
        rh = (rng.standard_normal((kh, kh, d)) * 0.2).astype(np.float32)
        rw = (rng.standard_normal((kw, kw, d)) * 0.2).astype(np.float32)
        padded = np.zeros((b, n, 3, heads, dp), np.float32)
        padded[..., :d] = real
        pad_tab = lambda t: np.pad(t, ((0, 0), (0, 0), (0, dp - d)))  # noqa
        scale = d ** -0.5
        ref = jfa.fused_qkv_relpos_attention(
            jnp.asarray(padded.reshape(b, n, -1)), jnp.asarray(pad_tab(rh)),
            jnp.asarray(pad_tab(rw)), scale=scale, kh=kh, kw=kw, heads=heads)
        ref = np.asarray(ref).reshape(b, n, heads, dp)[..., :d]
        got = fa.global_attention(
            torch.from_numpy(real.reshape(b, n, -1)), torch.from_numpy(rh),
            torch.from_numpy(rw), scale=scale, kh=kh, kw=kw, heads=heads)
        np.testing.assert_allclose(got.numpy().reshape(b, n, heads, d), ref,
                                   atol=F32_ATOL, rtol=0)

    @pytest.mark.parametrize("direction", ["token_to_image", "image_to_token"])
    def test_cross_k3(self, direction):
        """K3 at 4096 image tokens: unmasked token->image, and image->token
        with a key mask."""
        rng = _rng()
        b, heads, dh, tokens = 2, 8, 16, 23
        nq, nk = (tokens, 4096) if direction == "token_to_image" else (
            4096, tokens)
        q = (rng.standard_normal((b, nq, heads * dh)) * 0.5).astype(np.float32)
        k = (rng.standard_normal((b, nk, heads * dh)) * 0.5).astype(np.float32)
        v = (rng.standard_normal((b, nk, heads * dh)) * 0.5).astype(np.float32)
        valid = None
        if direction == "image_to_token":
            valid = rng.random((b, nk)) > 0.3
            valid[:, 0] = True
        ref = jfa.fused_cross_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=heads,
            divisor=dh ** 0.5,
            kv_valid=None if valid is None else jnp.asarray(valid))
        got = fa.cross_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            heads=heads, divisor=dh ** 0.5,
            kv_valid=None if valid is None else torch.from_numpy(valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=F32_ATOL, rtol=0)

    def test_cross_k3_bf16_rounding_sequence(self):
        """In bf16 the plain K3 follows the TPU kernel's rounding points
        (logits rounded, divided in bf16, p rounded after normalisation):
        equal to one bf16 ulp of the O(0.1) outputs."""
        rng = _rng()
        b, nq, nk, heads, dh = 1, 16, 1024, 4, 16
        arrs = [(rng.standard_normal((b, n, heads * dh)) * 0.5).astype(
            np.float32) for n in (nq, nk, nk)]
        ref = jfa.fused_cross_attention(
            *[jnp.asarray(a, jnp.bfloat16) for a in arrs], heads=heads,
            divisor=dh ** 0.5)
        got = fa.cross_attention(
            *[torch.from_numpy(a).to(torch.bfloat16) for a in arrs],
            heads=heads, divisor=dh ** 0.5)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(ref, np.float32),
            atol=2 ** -9, rtol=2 ** -7)


    def test_cross_k3_bf16_image_to_token_masked(self):
        """Image -> token in bf16 with a key mask, pair 1's keys all
        masked: the plain K3 (which the kernel is held to on the card)
        follows the TPU kernel's rounding points to one bf16 ulp of the
        O(0.1) outputs, and pair 1's p is uniform over its keys, so all
        its rows are equal."""
        rng = _rng()
        b, nq, nk, heads, dh = 2, 1024, 23, 4, 16
        arrs = [(rng.standard_normal((b, n, heads * dh)) * 0.5).astype(
            np.float32) for n in (nq, nk, nk)]
        valid = rng.random((b, nk)) > 0.3
        valid[0, 0] = True
        valid[1] = False
        ref = jfa.fused_cross_attention(
            *[jnp.asarray(a, jnp.bfloat16) for a in arrs], heads=heads,
            divisor=dh ** 0.5, kv_valid=jnp.asarray(valid))
        got = fa.cross_attention(
            *[torch.from_numpy(a).to(torch.bfloat16) for a in arrs],
            heads=heads, divisor=dh ** 0.5, kv_valid=torch.from_numpy(valid))
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                                   atol=2 ** -9, rtol=2 ** -7)
        np.testing.assert_array_equal(got[1], np.broadcast_to(got[1, :1],
                                                              got[1].shape))


class TestRelposK4PlainVersusJax:
    @pytest.mark.parametrize("b,kh,kw", [
        (2, 32, 32),   # N = 1024: the q-tiled regime, square grid
        (2, 16, 64),   # N = 1024, rectangular grid (key j -> j // 64, j % 64)
        (4, 14, 14),   # N = 196 < 1024: the grouped-windows regime
    ])
    def test_k4(self, b, kh, kw):
        """K4 at head dim 80 (the JAX kernel pads it to 128 and augments q
        and k with the bias and one-hot columns; the port reads 80)."""
        rng = _rng()
        n, d = kh * kw, 80
        q, k, v = ((rng.standard_normal((b, n, d)) * 0.5).astype(np.float32)
                   for _ in range(3))
        bh = (rng.standard_normal((b, n, kh)) * 0.5).astype(np.float32)
        bw = (rng.standard_normal((b, n, kw)) * 0.5).astype(np.float32)
        scale = d ** -0.5
        ref = jfa.fused_relpos_attention(
            *(jnp.asarray(a) for a in (q, k, v, bh, bw)), scale=scale)
        got = fa.relpos_attention(
            *(torch.from_numpy(a) for a in (q, k, v, bh, bw)), scale=scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=F32_ATOL, rtol=0)


class TestDispatch:
    def test_cpu_tensors_take_the_plain_path(self):
        fa.reset_launch_counts()
        qkv, rh, rw = _window_inputs(_rng(), bw=1, win=4, heads=2, d=8)
        fa.window_attention(torch.from_numpy(qkv), torch.from_numpy(rh),
                            torch.from_numpy(rw), scale=0.3, heads=2)
        x = torch.zeros((1, 8, 32))
        fa.cross_attention(x, torch.zeros((1, 16, 32)),
                           torch.zeros((1, 16, 32)), heads=2, divisor=4.0)
        qkv_g = torch.zeros((1, 16, 3 * 2 * 8))
        fa.global_attention(qkv_g, torch.zeros((4, 4, 8)),
                            torch.zeros((4, 4, 8)), scale=0.3, kh=4, kw=4,
                            heads=2)
        split = torch.zeros((2, 16, 8))
        fa.relpos_attention(split, split, split, torch.zeros((2, 16, 4)),
                            torch.zeros((2, 16, 4)), scale=0.3)
        assert fa.LAUNCHES == {"window": 0, "global": 0, "cross": 0,
                               "relpos": 0}

    def test_kernel_entry_refuses_cpu_tensors(self):
        qkv = torch.zeros((1, 16, 48))
        bias = torch.zeros((1, 16, 2, 8))
        with pytest.raises(ValueError):
            fa.window_attention_cuda(qkv, bias, scale=0.3, heads=2)
        assert fa.LAUNCHES["window"] == 0
        split, table = torch.zeros((2, 16, 16)), torch.zeros((2, 16, 4))
        with pytest.raises(ValueError):
            fa.relpos_attention_cuda(split, split, split, table, table,
                                     scale=0.3)
        assert fa.LAUNCHES["relpos"] == 0
