"""SAM's `crop_pad_tokens` and `SamPredictor.predict` in the port against
the JAX package, float32 on the CPU, with the tiny SAM of the orchestrator
tests (`vit_tiny_test`, 64-pixel input, grid 4, windows of 2, one global
block) on the same random weights.

- The encoder with the crop, over frames whose content is 36 x 64, 20 x 64
  and 64 x 44 pixels of the 64 x 64 input (valid token grids 3 x 4, 2 x 4,
  4 x 3): embeddings to 1e-4 absolute (float32 summation order), zero off
  the valid grid on both sides; without the crop, the same as before.
- `rel_pos_table(..., cropped=True)`: the center of the table, equal to
  JAX `_rel_pos_table` at ViT-H's sizes (127 rows to 36 and 64) and at the
  tiny ones.
- The raw-qkv routes of `Attention` on the grids the crop makes: K2 from
  1024 tokens at any kh x kw, K1 for square grids up to 208 tokens, the
  plain path otherwise (as JAX `image_encoder.py:283-320`).
- `predict` with and without `multimask_output`: logits and IoU to 1e-4,
  the same token slice.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam_pt_tpu.utils.testing as jtesting
from sam_pt_torch.models.sam import image_encoder as t_encoder
from sam_pt_torch.models.sam.predictor import SamPredictor as TPredictor
from sam_pt_torch.models.sam.sam_model import Sam as TSam
from sam_pt_torch.ops import flash_attention as fa
from sam_pt_torch.utils.checkpoint import sam_state_dict_from_jax
from sam_pt_tpu.models.sam.image_encoder import _rel_pos_table
from sam_pt_tpu.models.sam.predictor import SamPredictor as JPredictor
from sam_pt_tpu.models.sam.sam_model import Sam as JSam
from sam_pt_tpu.utils.checkpoint import convert_sam_state_dict
from torch_port_helpers import random_sam_state_dict

torch.set_num_threads(1)

ATOL = 1e-4


def _pair(crop: bool):
    params = convert_sam_state_dict(random_sam_state_dict(seed=17))
    jpredictor = JPredictor(JSam(encoder_variant="vit_tiny_test",
                                 image_size=64, crop_pad_tokens=crop), params)
    tsam = TSam(jtesting.TINY_VIT, image_size=64, crop_pad_tokens=crop)
    tsam.load_state_dict(sam_state_dict_from_jax(params))
    return jpredictor, TPredictor(tsam.eval().requires_grad_(False))


@pytest.fixture(scope="module")
def cropped_pair():
    return _pair(True)


@pytest.mark.parametrize("hw,valid", [((36, 64), (3, 4)),
                                      ((20, 64), (2, 4)),
                                      ((64, 44), (4, 3))])
def test_cropped_encoder_matches_jax(cropped_pair, hw, valid):
    jpredictor, tpredictor = cropped_pair
    frames = np.random.default_rng(sum(hw)).integers(
        0, 255, (2, *hw, 3)).astype(np.uint8)
    ref = np.asarray(jpredictor.encode_frames(jnp.asarray(frames), hw))
    got = tpredictor.encode_frames(torch.from_numpy(frames), hw).numpy()
    assert got.shape == ref.shape == (2, 4, 4, 256)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    off = np.ones((4, 4), bool)
    off[:valid[0], :valid[1]] = False
    assert np.all(got[:, off] == 0) and np.all(ref[:, off] == 0)
    assert np.abs(got[:, ~off]).min() > 0


def test_uncropped_encoder_unchanged():
    jpredictor, tpredictor = _pair(False)
    frames = np.random.default_rng(5).integers(0, 255, (2, 36, 64, 3)).astype(
        np.uint8)
    ref = np.asarray(jpredictor.encode_frames(jnp.asarray(frames), (36, 64)))
    got = tpredictor.encode_frames(torch.from_numpy(frames), (36, 64))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    assert np.abs(ref[:, 3:]).max() > 0  # the pad tokens are encoded


@pytest.mark.parametrize("rows,size", [(127, 36), (127, 64), (127, 14),
                                       (7, 3), (7, 2), (27, 14)])
def test_center_sliced_rel_pos_table_matches_jax(rows, size):
    table = np.random.default_rng(rows + size).standard_normal(
        (rows, 16)).astype(np.float32)
    got = t_encoder.rel_pos_table(torch.from_numpy(table), size, size,
                                  cropped=True).numpy()
    ref = np.asarray(_rel_pos_table(jnp.asarray(table), size, size,
                                    cropped=True))
    assert got.shape == (size, size, 16)
    np.testing.assert_array_equal(got, ref)
    # distance 0 is the table's center row, as on the uncropped grid
    np.testing.assert_array_equal(got[0, 0], table[rows // 2])


@pytest.mark.parametrize("hw,route", [((36, 64), "global"),
                                      ((64, 36), "global"),
                                      ((32, 32), "global"),
                                      ((14, 14), "window"),
                                      ((12, 12), "window"),
                                      ((20, 20), "plain"),
                                      ((10, 30), "plain")])
def test_raw_qkv_routes_follow_jax(monkeypatch, hw, route):
    """Which kernel an encoder block's attention takes on a (cropped)
    grid; the plain path's output equals the split-head reference."""
    calls = []
    for name in ("global_attention", "window_attention"):
        real = getattr(fa, name)

        def recorder(*args, _name=name, _real=real, **kwargs):
            calls.append(_name.split("_")[0])
            return _real(*args, **kwargs)

        monkeypatch.setattr(fa, name, recorder)
    torch.manual_seed(0)
    attn = t_encoder.Attention(32, 2, (64, 64), raw_qkv=True)
    plain = t_encoder.Attention(32, 2, (64, 64), raw_qkv=False)
    with torch.no_grad():
        for p in (attn.rel_pos_h, attn.rel_pos_w):
            p.normal_(0, 0.2)
        plain.load_state_dict(attn.state_dict())
        x = torch.randn(1, hw[0] * hw[1], 32)
        out = attn(x, hw, cropped=True)
    assert calls == ([] if route == "plain" else [route])
    if route == "plain":
        torch.testing.assert_close(out, plain(x, hw, cropped=True))


@pytest.mark.parametrize("multimask", [False, True])
def test_predict_matches_jax(multimask):
    jpredictor, tpredictor = _pair(False)
    rng = np.random.default_rng(int(multimask))
    frames = rng.integers(0, 255, (2, 48, 64, 3)).astype(np.uint8)
    emb = np.array(jpredictor.encode_frames(jnp.asarray(frames), (48, 64)))
    pts = rng.uniform(0, 60, (2, 3, 2)).astype(np.float32)
    lbl = np.array([[1, 0, -1], [1, 1, 0]])
    jl, ji, jslice = jpredictor.predict(jnp.asarray(emb), jnp.asarray(pts),
                                        jnp.asarray(lbl), (48, 64),
                                        multimask_output=multimask)
    tl, ti, tslice = tpredictor.predict(torch.from_numpy(emb), pts, lbl,
                                        (48, 64), multimask_output=multimask)
    k = 3 if multimask else 1
    assert tslice == jslice == (slice(1, 4) if multimask else slice(0, 1))
    assert tuple(tl.shape) == (2, k, 16, 16) and tuple(ti.shape) == (2, k)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=ATOL, rtol=0)
