"""MobileSAM's TinyViT and Light HQ-SAM in the port against the JAX
package, same weights, in float32, at MobileSAM's widths (64, 128, 160,
320; depths 2, 2, 6, 2) on a 128-pixel image (an 8 x 8 token grid, every
stage's window padding exercised); and a MobileSAM-named state dict
loading as it is.

Weights: `random_like` draws for the port's own modules (MobileSAM's
names), converted for the JAX side by its own converter. Tolerance 1e-4
on LayerNorm-scale embeddings and early features, 2e-3 on logits of
order 10.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_pt_torch.models.sam import tiny_vit as ttv
from sam_pt_torch.models.sam.factory import build_predictor
from sam_pt_torch.models.sam.predictor import SamPredictor as TPredictor
from sam_pt_torch.models.sam.sam_model import Sam as TSam
from sam_pt_torch.utils.checkpoint import sam_state_dict_from_jax
from sam_pt_tpu.models.sam import tiny_vit as jtv
from sam_pt_tpu.models.sam.predictor import SamPredictor as JPredictor
from sam_pt_tpu.models.sam.sam_model import Sam as JSam
from sam_pt_tpu.utils.checkpoint import convert_sam_state_dict
from torch_port_helpers import as_float32, random_like, torch_sd

torch.set_num_threads(1)

SIZE = 128


def _random_sam(seed, hq):
    """A random state dict of the port's `Sam("vit_t")`, MobileSAM's (and
    with `hq`, `segment_anything_hq`'s) names, numpy float32."""
    return as_float32(random_like(
        TSam("vit_t", image_size=SIZE, use_hq=hq).state_dict(), seed))


@pytest.fixture(scope="module", params=[False, True], ids=["mobile_sam",
                                                            "light_hq_sam"])
def pair(request):
    hq = request.param
    sd = _random_sam(41, hq)
    params = convert_sam_state_dict(sd)
    jsam = JSam(encoder_variant="vit_t", image_size=SIZE, use_hq=hq)
    tsam = TSam("vit_t", image_size=SIZE, use_hq=hq)
    back = sam_state_dict_from_jax(params)
    assert set(back) == set(tsam.state_dict())
    for key, value in back.items():  # the converter round trip is exact
        np.testing.assert_array_equal(value.numpy(), sd[key], err_msg=key)
    tsam.load_state_dict(back)
    return hq, params, jsam, tsam.eval().requires_grad_(False)


@pytest.mark.parametrize("return_interm", [False, True])
def test_encoder(pair, return_interm):
    """The encoder alone on a normalised image, bare and with the pre-neck
    stage-3 features (320 wide)."""
    _, params, _, tsam = pair
    x = np.random.default_rng(42).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    ref = jtv.TinyViT(img_size=SIZE).apply(
        {"params": params["params"]["image_encoder"]}, jnp.asarray(x),
        return_interm=return_interm)
    with torch.no_grad():
        got = tsam.image_encoder(torch.from_numpy(x),
                                 return_interm=return_interm)
    if not return_interm:
        got, ref = (got,), (ref,)
    assert got[0].shape == (2, SIZE // 16, SIZE // 16, 256)
    if return_interm:
        assert got[1].shape == (2, SIZE // 16, SIZE // 16, 320)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


def test_sam_encode_and_decode(pair):
    """MobileSAM and Light HQ-SAM through the predictors: the antialiased
    resize, the embeddings ({'emb', 'interm'} with HQ), and a decode with
    padded prompts and a box row (HQ's after the feature step)."""
    hq, params, jsam, tsam = pair
    jpred, tpred = JPredictor(jsam, params), TPredictor(tsam)
    rng = np.random.default_rng(43)
    frames = rng.integers(0, 255, (2, 72, 128, 3)).astype(np.uint8)
    ref = jpred.encode_frames(jnp.asarray(frames), (72, 128))
    got = tpred.encode_frames(torch.from_numpy(frames), (72, 128))
    pairs = ([(got[k], ref[k]) for k in ("emb", "interm")] if hq
             else [(got, ref)])
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)
    pts = rng.uniform(0, SIZE, (2, 4, 2)).astype(np.float32)
    lbl = np.array([[1, 1, 0, -1], [1, 0, 2, 3]], np.int32)
    ref_m, ref_iou = jpred._decode(params, ref, jnp.asarray(pts),
                                   jnp.asarray(lbl), None, None)
    got_m, got_iou = tpred.decode(tpred.decode_ready(got),
                                  torch.from_numpy(pts),
                                  torch.from_numpy(lbl).long())
    np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), atol=2e-3,
                               rtol=0)
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(ref_iou),
                               atol=1e-4, rtol=0)


def test_rel_bias_index_is_the_jax_table():
    for window in (7, 14):
        np.testing.assert_array_equal(ttv._rel_bias_index(window),
                                      jtv._rel_bias_index(window))


def test_mobile_sam_file_loads_as_it_is(tmp_path):
    """A state dict in `mobile_sam.pt`'s layout, with the keys the port
    does not use (BatchNorm step counters, TinyViT's classifier head),
    loads through `build_predictor` as it is: the same embedding as the
    module given the weights directly."""
    sd = torch_sd(_random_sam(44, False))
    ref_model = TSam("vit_t", image_size=SIZE)
    ref_model.load_state_dict(sd)
    extra = {"image_encoder.norm_head.weight": torch.ones(320),
             "image_encoder.norm_head.bias": torch.zeros(320),
             "image_encoder.head.weight": torch.zeros(1000, 320),
             "image_encoder.head.bias": torch.zeros(1000)}
    extra.update({k.replace("running_var", "num_batches_tracked"):
                  torch.tensor(7) for k in sd if k.endswith("running_var")})
    assert "image_encoder.layers.1.blocks.0.attn.attention_biases" in sd
    assert "image_encoder.patch_embed.seq.2.c.weight" in sd
    assert "image_encoder.layers.2.downsample.conv2.bn.running_mean" in sd
    path = tmp_path / "mobile_sam.pt"
    torch.save({**sd, **extra}, path)
    pred = build_predictor("vit_t", checkpoint=str(path), dtype="float32",
                           image_size=SIZE, device="cpu")
    frames = torch.from_numpy(np.random.default_rng(45).integers(
        0, 255, (1, 72, 128, 3)).astype(np.uint8))
    got = pred.encode_frames(frames, (72, 128))
    want = TPredictor(ref_model.eval()).encode_frames(frames, (72, 128))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
