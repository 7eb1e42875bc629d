"""Port SAM modules against the JAX package's, same weights, in float32.

Weights: random `segment_anything` state dicts (tests/torch_port_helpers)
converted for the JAX side by its own converter. Tolerances are stated per
test; they cover float32 summation-order differences accumulated through
the layers, on outputs of order 1-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam_pt_tpu.utils.testing as jtesting
from sam_pt_torch.models.sam.image_encoder import ImageEncoderViT
from sam_pt_torch.models.sam.predictor import SamPredictor as TPredictor
from sam_pt_torch.models.sam.sam_model import Sam as TSam
from sam_pt_torch.utils.checkpoint import (
    sam_state_dict_from_jax,
    vit_encoder_state_dict_from_jax,
)
from sam_pt_tpu.models.sam import image_encoder as jie
from sam_pt_tpu.models.sam.predictor import SamPredictor as JPredictor
from sam_pt_tpu.models.sam.sam_model import Sam as JSam
from sam_pt_tpu.utils.checkpoint import (
    _convert_vit_encoder,
    _make_put,
    convert_sam_state_dict,
)
from torch_port_helpers import random_sam_state_dict

torch.set_num_threads(1)


def _port_sam(params, **kw):
    sam = TSam(**kw)
    sam.load_state_dict(sam_state_dict_from_jax(params))
    return sam.eval().requires_grad_(False)


class TestImageEncoderAtKernelScale:
    def test_window_span_and_global_block(self):
        """A 32 x 32 token grid with ViT-H's head dim 80 (8 heads of 80):
        the window block runs K1's plain version over 14 x 14 windows with
        the grid padded 32 -> 42 (pad slots zeroed, still attended); the
        global block runs K2's (JAX: head dim padded to 128). Neck included.
        Tolerance 2e-4 on LayerNorm-scale outputs."""
        cfg = dict(embed_dim=640, depth=2, num_heads=8,
                   global_attn_indexes=(1,), window_size=14)
        sd = random_sam_state_dict(seed=7, embed_dim=640, depth=2, heads=8,
                                   grid=32, window=14, global_idx=(1,))
        tree = {}
        _convert_vit_encoder(sd, _make_put(tree))
        jparams = {"params": tree["image_encoder"]}
        assert jparams["params"]["blocks_1"]["attn"]["rel_pos_h"].shape[-1] == 128

        x = np.random.default_rng(8).standard_normal(
            (1, 512, 512, 3)).astype(np.float32)
        ref = jie.ImageEncoderViT(img_size=512, **cfg).apply(
            jparams, jnp.asarray(x))
        enc = ImageEncoderViT(img_size=512, **cfg)
        enc.load_state_dict(
            vit_encoder_state_dict_from_jax(jparams["params"], prefix=""))
        with torch.no_grad():
            got = enc.eval()(torch.from_numpy(x))
        assert got.shape == (1, 32, 32, 256)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                                   rtol=0)


class TestTinySam:
    @pytest.fixture(scope="class")
    def pair(self):
        sd = random_sam_state_dict(seed=9)
        params = convert_sam_state_dict(sd)
        jsam = JSam(encoder_variant="vit_tiny_test", image_size=64)
        tsam = _port_sam(params, encoder=jtesting.TINY_VIT, image_size=64)
        return jsam, params, tsam

    def test_encoder_predictor_and_upscale(self, pair):
        """Tiny encoder (plain attention paths), antialiased preprocessing
        resize, coordinate scaling and logits upscaling."""
        jsam, params, tsam = pair
        rng = np.random.default_rng(10)
        frames = rng.integers(0, 255, (2, 48, 80, 3)).astype(np.uint8)
        jpred, tpred = JPredictor(jsam, params), TPredictor(tsam)
        ref = jpred.encode_frames(jnp.asarray(frames), (48, 80))
        got = tpred.encode_frames(torch.from_numpy(frames), (48, 80))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=0)
        low = rng.standard_normal((3, 16, 16)).astype(np.float32) * 5
        np.testing.assert_allclose(
            tpred.upscale_logits(torch.from_numpy(low), (48, 80)).numpy(),
            np.asarray(jpred.upscale_logits(jnp.asarray(low), (48, 80))),
            atol=1e-4, rtol=0)
        pts = rng.uniform(0, 80, (3, 5, 2)).astype(np.float32)
        np.testing.assert_allclose(
            tpred.scale_coords(torch.from_numpy(pts), (48, 80)).numpy(),
            np.asarray(jpred.scale_coords(jnp.asarray(pts), (48, 80))),
            rtol=1e-6)


class TestDecoderAtKernelScale:
    def test_prompt_encoder_and_mask_decoder(self):
        """64 x 64 image tokens, so every image-side attention runs K3's
        plain version (JAX: the Pallas kernel, interpret mode): padded
        prompts, a box-corner row, a mask input with one row disabled.
        Tolerance 2e-3 on logits of order 10."""
        sd = random_sam_state_dict(seed=11, grid=64)
        params = convert_sam_state_dict(sd)
        jsam = JSam(encoder_variant="vit_tiny_test", image_size=1024)
        tsam = _port_sam(params, encoder=jtesting.TINY_VIT, image_size=1024)

        rng = np.random.default_rng(12)
        emb = rng.standard_normal((2, 64, 64, 256)).astype(np.float32)
        pts = rng.uniform(0, 1024, (2, 6, 2)).astype(np.float32)
        lbl = np.array([[1, 1, 0, -1, -1, -1], [1, 0, -1, 2, 3, -1]],
                       np.int32)
        mask_in = rng.standard_normal((2, 256, 256, 1)).astype(np.float32)
        valid = np.array([True, False])
        for token0 in (False, True):
            ref_m, ref_iou = jsam.apply(
                params, jnp.asarray(emb), jnp.asarray(pts), jnp.asarray(lbl),
                jnp.asarray(mask_in), jnp.asarray(valid),
                only_token0=token0, method=JSam.decode_masks)
            with torch.no_grad():
                got_m, got_iou = tsam.decode_masks(
                    torch.from_numpy(emb), torch.from_numpy(pts),
                    torch.from_numpy(lbl), torch.from_numpy(mask_in),
                    torch.from_numpy(valid), only_token0=token0)
            assert got_m.shape == ref_m.shape
            np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m),
                                       atol=2e-3, rtol=0)
            np.testing.assert_allclose(got_iou.numpy(), np.asarray(ref_iou),
                                       atol=2e-4, rtol=0)
