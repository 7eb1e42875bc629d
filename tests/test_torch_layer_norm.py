"""K5's plain version, its route and the call sites that fuse a LayerNorm2d
with the GELU after it (`sam_pt_torch/ops/layer_norm.py`), on the CPU.

The CPU takes the plain version, which is PyTorch's LayerNorm and GELU as
the port called them before the kernel, so every comparison here is bit
for bit. The kernel itself runs only on the card
(`tests/test_torch_kernels_cuda.py`); its row addressing is checked here
through `row_layout`, by gathering each row from the tensor's storage as
the kernel computes the offsets.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from sam_pt_torch.models.sam.image_encoder import LayerNorm2d, conv_nhwc
from sam_pt_torch.models.sam.mask_decoder import MaskDecoder
from sam_pt_torch.models.sam.mask_decoder_hq import (
    MaskDecoderHQ,
    _apply_block,
)
from sam_pt_torch.models.sam.prompt_encoder import PromptEncoder
from sam_pt_torch.ops import layer_norm as ln

EPS = 1e-6


def _randn(rng, *shape, dtype=torch.float32, std=1.0, mean=0.0):
    return torch.from_numpy(
        (mean + std * rng.standard_normal(shape)).astype(np.float32)).to(dtype)


def _live_norms(module: nn.Module, rng) -> nn.Module:
    """Random affines on every LayerNorm (the default 1 / 0 would hide a
    weight or bias dropped on the way)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.copy_(_randn(rng, *m.weight.shape, mean=1.0,
                                      std=0.2))
                m.bias.copy_(_randn(rng, *m.bias.shape, std=0.2))
    return module


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [4, 16, 64, 256])
@pytest.mark.parametrize("gelu", [False, True])
def test_plain_is_pytorch_layer_norm_then_gelu(width, dtype, gelu):
    """On the CPU `layer_norm` and the `LayerNorm2d` module give what the
    port computed before: `F.layer_norm` with the weights cast to the
    input's dtype, then `F.gelu`, bit for bit."""
    rng = np.random.default_rng(width)
    x = _randn(rng, 3, 5, 7, width, dtype=dtype, std=2.0, mean=0.5)
    weight = _randn(rng, width, mean=1.0, std=0.2)
    bias = _randn(rng, width, std=0.2)
    ref = F.layer_norm(x, (width,), weight.to(dtype), bias.to(dtype), EPS)
    if gelu:
        ref = F.gelu(ref)
    got = ln.layer_norm(x, weight, bias, EPS, gelu=gelu)
    assert got.dtype == dtype and torch.equal(got, ref)
    module = LayerNorm2d(width)
    with torch.no_grad():
        module.weight.copy_(weight)
        module.bias.copy_(bias)
    assert torch.equal(module(x, gelu=gelu), ref)


@pytest.mark.parametrize("device,width,route", [
    ("cpu", 64, "plain"), ("cuda", 1, "kernel"), ("cuda", 4, "kernel"),
    ("cuda", 16, "kernel"), ("cuda", 64, "kernel"), ("cuda", 160, "kernel"),
    ("cuda", 256, "kernel"), ("cuda", 257, "plain"), ("cuda", 768, "plain"),
    ("cuda", 1280, "plain")])
def test_route_sends_narrow_card_rows_to_the_kernel(monkeypatch, device,
                                                     width, route):
    """A CUDA tensor of rows up to 256 wide takes the kernel; wider rows
    (the ViT blocks' 768-1280) and CPU tensors take PyTorch's LayerNorm.
    The CUDA tensors are fake (shapes and devices without data)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    taken = []
    monkeypatch.setattr(ln, "layer_norm_cuda",
                        lambda x, *a, **k: taken.append("kernel") or x)
    monkeypatch.setattr(ln, "layer_norm_plain",
                        lambda x, *a, **k: taken.append("plain") or x)
    with FakeTensorMode():
        x = torch.empty(2, 8, width, device=device, dtype=torch.bfloat16)
        w = torch.empty(width, device=device)
        ln.layer_norm(x, w, w, EPS, gelu=True)
    assert taken == [route]


def _gather_rows(x: torch.Tensor) -> torch.Tensor:
    """x's rows [rows, C] read from its storage at the offsets the kernel
    computes from `row_layout`."""
    rows, h, w, s_n, s_h, s_w, s_c = ln.row_layout(x)
    flat = torch.as_strided(x, (x.untyped_storage().nbytes()
                                // x.element_size() - x.storage_offset(),),
                            (1,))
    out = torch.empty(rows, x.shape[-1], dtype=x.dtype)
    for r in range(rows):
        if w >= rows:
            off = r * s_w
        else:
            hn = r // w
            off = (hn // h) * s_n + (hn % h) * s_h + (r % w) * s_w
        out[r] = flat[off + s_c * torch.arange(x.shape[-1])]
    return out


def _layouts():
    base = torch.arange(2 * 4 * 6 * 5, dtype=torch.float32)
    nchw = base.reshape(2, 5, 4, 6)
    return {
        "nhwc contiguous": base.reshape(2, 4, 6, 5),
        # a conv's NCHW output seen as NHWC: channels 24 apart
        "nchw as nhwc": nchw.permute(0, 2, 3, 1),
        "token rows": base.reshape(8, 6, 5),
        "cropped rows": base.reshape(2, 4, 6, 5)[:, 1:3, 2:5],
        "every other row": base.reshape(2, 4, 6, 5)[:, ::2],
        "broadcast": base[:5].reshape(1, 1, 1, 5).expand(2, 4, 6, 5),
        "one row": base[:5].reshape(1, 1, 5),
    }


@pytest.mark.parametrize("name", list(_layouts()))
def test_row_layout_addresses_every_row(name):
    x = _layouts()[name]
    assert torch.equal(_gather_rows(x), x.reshape(-1, x.shape[-1]))


def test_row_layout_refuses_four_unmerged_axes():
    x = torch.zeros(3, 4, 5, 6, 7)[::2, ::2, ::2, ::2]
    with pytest.raises(ValueError, match="do not merge"):
        ln.row_layout(x)


# The parent's formulas of the call sites that now make one call.
def _old_upscale(dec, src_out, h, w):
    up = dec.output_upscaling
    x = conv_nhwc(up[0], src_out.reshape(src_out.shape[0], h, w, -1))
    x = F.gelu(up[1](x))
    return F.gelu(conv_nhwc(up[3], x))


def _old_block(block, x):
    x = block[1](conv_nhwc(block[0], x))
    return conv_nhwc(block[3], F.gelu(x))


def _old_encode_masks(pe, masks):
    md = pe.mask_downscaling
    x = conv_nhwc(md[0], masks.to(md[0].weight.dtype))
    x = F.gelu(md[1](x))
    x = conv_nhwc(md[3], x)
    x = F.gelu(md[4](x))
    return conv_nhwc(md[6], x)


def _site(name, rng, dtype):
    """(new output, the parent's) of one fused call site, at a small
    size."""
    if name == "mask_decoder.upscale":
        dec = _live_norms(MaskDecoder(transformer_dim=32), rng).to(dtype)
        src = _randn(rng, 3, 16, 32, dtype=dtype)
        return dec.upscale(src, 4, 4), _old_upscale(dec, src, 4, 4)
    if name == "prompt_encoder.encode_masks":
        pe = _live_norms(PromptEncoder(
            embed_dim=32, image_embedding_size=(8, 8),
            input_image_size=(32, 32)), rng).to(dtype)
        masks = _randn(rng, 3, 32, 32, 1, std=4.0)
        return pe.encode_masks(masks), _old_encode_masks(pe, masks)
    hq = _live_norms(MaskDecoderHQ(transformer_dim=32, vit_dim=48),
                     rng).to(dtype)
    if name == "mask_decoder_hq.image_features":
        emb = _randn(rng, 2, 4, 4, 32, dtype=dtype)
        interm = _randn(rng, 2, 4, 4, 48, dtype=dtype)
        return (hq.image_features(emb, interm),
                _old_block(hq.embedding_encoder, emb)
                + _old_block(hq.compress_vit_feat, interm))
    x = _randn(rng, 2, 16, 16, 4, dtype=dtype)  # upscaled_sam, C/8
    return (_apply_block(hq.embedding_maskfeature, x),
            _old_block(hq.embedding_maskfeature, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", [
    "mask_decoder.upscale", "prompt_encoder.encode_masks",
    "mask_decoder_hq.image_features", "mask_decoder_hq.maskfeature"])
def test_fused_call_sites_give_the_parents_outputs(name, dtype):
    """`MaskDecoder.upscale` (also `MaskDecoderHQ.forward_features`'),
    `PromptEncoder.encode_masks` and HQ-SAM's `_apply_block` (its
    image-level features and `embedding_maskfeature`) equal the parent's
    LayerNorm2d-then-`F.gelu` formulas bit for bit on the CPU."""
    with torch.no_grad():
        got, ref = _site(name, np.random.default_rng(7), dtype)
    assert got.dtype == dtype and torch.equal(got, ref)
