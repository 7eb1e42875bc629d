"""HQ-SAM in the port against the JAX package, same weights, in float32:
`MaskDecoderHQ` at real width and tiny, `select_hq_masks`, `Sam(use_hq)`
encode + decode, and a tiny SamPt with HQ-SAM through forward and
re-initialisation.

Weights: random public-namespace (`segment_anything` + `segment_anything_hq`)
state dicts from tests/torch_port_helpers, converted for the JAX side by its
own converter; the port loads them back through `sam_state_dict_from_jax`
(so the converter round trip is exercised) or as they are. Tolerances are
stated per test: float32 summation-order differences through the layers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam_pt_tpu.utils.testing as jtesting
from sam_pt_torch.models.sam.mask_decoder_hq import MaskDecoderHQ as TDecoder
from sam_pt_torch.models.sam.mask_decoder_hq import (
    select_hq_masks as t_select,
)
from sam_pt_torch.models.sam.predictor import SamPredictor as TPredictor
from sam_pt_torch.models.sam.sam_model import Sam as TSam
from sam_pt_torch.utils.checkpoint import sam_state_dict_from_jax
from sam_pt_tpu.models.sam.mask_decoder_hq import MaskDecoderHQ as JDecoder
from sam_pt_tpu.models.sam.mask_decoder_hq import (
    select_hq_masks as j_select,
)
from sam_pt_tpu.models.sam.predictor import SamPredictor as JPredictor
from sam_pt_tpu.models.sam.sam_model import Sam as JSam
from sam_pt_tpu.utils.checkpoint import (
    _convert_prompt_and_decoder,
    _make_put,
    convert_sam_state_dict,
)
from test_torch_sam_pt_reinit import REINIT, _assert_outputs_match, _video
from torch_port_helpers import (
    random_hq_state_dict,
    random_sam_state_dict,
    tiny_sam_pt_pair,
    torch_sd,
)

torch.set_num_threads(1)


def _decoder_pair(pdim, vit_dim, seed):
    """(JAX params of the decoder, port decoder) on one random state dict."""
    sd = random_sam_state_dict(seed=seed, pdim=pdim)
    sd.update(random_hq_state_dict(seed=seed + 1, vit_dim=vit_dim, pdim=pdim))
    tree = {}
    _convert_prompt_and_decoder(sd, _make_put(tree))
    dec = TDecoder(pdim, vit_dim)
    dec.load_state_dict({k[len("mask_decoder."):]: v
                         for k, v in torch_sd(sd).items()
                         if k.startswith("mask_decoder.")})
    return {"params": tree["mask_decoder"]}, dec.eval().requires_grad_(False)


@pytest.mark.parametrize("pdim,vit_dim,grid,atol", [
    (32, 16, 4, 1e-4),
    # real width: 64 x 64 image tokens, so every image-side attention runs
    # K3's plain version (JAX: the Pallas kernel in interpret mode) with the
    # HQ token as a sixth output token
    (256, 1280, 64, 2e-3)], ids=["tiny", "real_width"])
def test_decoder(pdim, vit_dim, grid, atol):
    """One decoder call with padded prompts (a box-corner row), the port's
    as it composes it: `image_features` of the early features, then
    `forward_features`. The five tokens' masks (atol on logits of order
    10) and the IoUs (1e-4)."""
    jparams, tdec = _decoder_pair(pdim, vit_dim, seed=31)
    rng = np.random.default_rng(32)
    b, n = 2, 6
    emb = rng.standard_normal((b, grid, grid, pdim)).astype(np.float32)
    pe = rng.standard_normal((1, grid, grid, pdim)).astype(np.float32)
    sparse = rng.standard_normal((b, n, pdim)).astype(np.float32)
    dense = 0.1 * rng.standard_normal((b, grid, grid, pdim)).astype(
        np.float32)
    interm = rng.standard_normal((b, grid, grid, vit_dim)).astype(np.float32)
    valid = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 0]], bool)
    ref_m, ref_iou = JDecoder(transformer_dim=pdim, vit_dim=vit_dim).apply(
        jparams, *(jnp.asarray(a) for a in (emb, pe, sparse, dense, interm,
                                            valid)))
    emb_t, pe_t, sparse_t, dense_t, interm_t, valid_t = (
        torch.from_numpy(a) for a in (emb, pe, sparse, dense, interm, valid))
    with torch.no_grad():
        got_m, got_iou = tdec.forward_features(
            emb_t, pe_t, sparse_t, dense_t,
            tdec.image_features(emb_t, interm_t), valid_t)
        with pytest.raises(TypeError, match="forward_features"):
            tdec(emb_t, pe_t, sparse_t, dense_t, interm_t, valid_t)
    assert got_m.shape == (b, 5, 4 * grid, 4 * grid)
    assert got_iou.shape == (b, 4)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(ref_iou),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("multimask", [False, True])
@pytest.mark.parametrize("hq_token_only", [False, True])
def test_select_hq_masks(multimask, hq_token_only):
    """Exact: the same selection and one addition."""
    rng = np.random.default_rng(33)
    masks = rng.standard_normal((3, 5, 8, 8)).astype(np.float32)
    iou = rng.random((3, 4)).astype(np.float32)
    ref = j_select(jnp.asarray(masks), jnp.asarray(iou), multimask,
                   hq_token_only)
    got = t_select(torch.from_numpy(masks), torch.from_numpy(iou), multimask,
                   hq_token_only)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("hq_token_only", [False, True])
def test_sam_hq_encode_and_decode(hq_token_only):
    """The tiny ViT with the HQ decoder through the predictors: the
    {'emb', 'interm'} embeddings (interm: the first global block's output)
    and the masks of token 0 (HQ) and tokens 1-3 (SAM) decoded from
    them after the feature step (`decode_ready`), with a mask input.
    Tolerance 1e-4 on embeddings, 2e-3 on logits."""
    sd = random_sam_state_dict(seed=34)
    sd.update(random_hq_state_dict(seed=35, vit_dim=32))
    params = convert_sam_state_dict(sd)
    jsam = JSam(encoder_variant="vit_tiny_test", image_size=64, use_hq=True,
                hq_token_only=hq_token_only)
    tsam = TSam(jtesting.TINY_VIT, image_size=64, use_hq=True,
                hq_token_only=hq_token_only)
    back = sam_state_dict_from_jax(params)
    assert set(back) == set(tsam.state_dict())
    for key, value in back.items():  # the converter round trip is exact
        np.testing.assert_array_equal(value.numpy(), sd[key], err_msg=key)
    tsam.load_state_dict(back)
    jpred = JPredictor(jsam, params)
    tpred = TPredictor(tsam.eval().requires_grad_(False))

    rng = np.random.default_rng(36)
    frames = rng.integers(0, 255, (2, 48, 80, 3)).astype(np.uint8)
    ref = jpred.encode_frames(jnp.asarray(frames), (48, 80))
    got = tpred.encode_frames(torch.from_numpy(frames), (48, 80))
    assert set(got) == {"emb", "interm"}
    assert got["interm"].shape == (2, 4, 4, 32)
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, rtol=0, err_msg=key)

    pts = rng.uniform(0, 64, (2, 4, 2)).astype(np.float32)
    lbl = np.array([[1, 0, -1, -1], [1, 1, 2, 3]], np.int32)
    mask_in = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    ref_m, ref_iou = jpred._decode(params, ref, jnp.asarray(pts),
                                   jnp.asarray(lbl), jnp.asarray(mask_in),
                                   jnp.ones((2,), bool), only_token0=True)
    got_m, got_iou = tpred.decode(tpred.decode_ready(got),
                                  torch.from_numpy(pts),
                                  torch.from_numpy(lbl).long(),
                                  torch.from_numpy(mask_in),
                                  torch.ones(2, dtype=torch.bool),
                                  only_token0=True)
    assert got_m.shape == (2, 4, 16, 16)  # only_token0 ignored with HQ
    np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), atol=2e-3,
                               rtol=0)
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(ref_iou),
                               atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def hq_forward():
    jsampt, tsampt = tiny_sam_pt_pair(hq=True)
    video = _video()
    return jsampt.forward(dict(video)), tsampt.forward(video)


def test_sam_pt_hq_forward(hq_forward):
    """The tiny SamPt with HQ-SAM on the device flow (two objects, query
    frames 0 and 3): tolerances of test_torch_sam_pt_reinit.py."""
    jout, tout = hq_forward
    assert tout["logits"].shape == (2, 7, 48, 64)
    _assert_outputs_match(jout, tout)


def test_sam_pt_hq_reinit():
    """Re-initialisation with HQ-SAM: the dict embeddings flipped for the
    backward pass and sliced per window; both directions ran."""
    jsampt, tsampt = tiny_sam_pt_pair(hq=True, **REINIT)
    video = _video()
    jout = jsampt.forward(dict(video))
    tout = tsampt.forward(video)
    assert {d for d, *_ in tsampt.reinit_windows} == {"forward", "backward"}
    _assert_outputs_match(jout, tout)
