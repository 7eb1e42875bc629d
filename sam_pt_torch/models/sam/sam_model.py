"""The composed SAM model (counterpart of
`sam_pt_tpu/models/sam/sam_model.py`): image encoder + prompt encoder +
mask decoder, with the public parameter names (`segment_anything`,
`segment_anything_hq` for the HQ decoder, MobileSAM's for TinyViT)."""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from .image_encoder import VIT_VARIANTS, ImageEncoderViT
from .mask_decoder import MaskDecoder
from .mask_decoder_hq import MaskDecoderHQ, select_hq_masks
from .prompt_encoder import PromptEncoder
from .tiny_vit import TinyViT

# The width of TinyViT's early features (its last stage), which Light
# HQ-SAM's decoder reads.
TINY_VIT_INTERM_DIM = 320

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


@functools.lru_cache(maxsize=None)
def pixel_stats(device: torch.device):
    """(PIXEL_MEAN, PIXEL_STD) as float32 tensors on `device`, uploaded
    once."""
    return (torch.tensor(PIXEL_MEAN, device=device),
            torch.tensor(PIXEL_STD, device=device))


class Sam(nn.Module):
    """Promptable segmentation; mask threshold 0.0 (logits > 0).

    `encoder` is a ViT variant name (`vit_b`, `vit_l`, `vit_h`), `vit_t`
    (MobileSAM's TinyViT) or a dict of `ImageEncoderViT` arguments. The
    working dtype is the parameters' dtype (`.to(torch.bfloat16)` for the
    bf16 path). `crop_pad_tokens` (opt-in, off by default as in the JAX
    package; ViT encoders only): the encoder runs only on the tokens that
    cover the resized frame, and the embedding is zero off it. `use_hq`
    takes HQ-SAM's decoder, which also reads the encoder's early features:
    the encoder then gives {'emb', 'interm'} dicts, and the decoder takes
    {'emb', 'hq'}, its image-level features computed from them once a
    frame (`SamPredictor.hq_features`); `hq_token_only` keeps the HQ mask
    alone in the single-mask output. `tp_axis` names the mesh axis a ViT
    encoder's heads and MLP are sharded over and `dp_axis` the one frames
    are split over on a 2-D (data x model) mesh, as the JAX model's do;
    `SamPredictor(mesh=...)` shards the encoder
    (`parallel/tensor_parallel.py`). TinyViT refuses `tp_axis`.
    """

    mask_threshold = 0.0

    def __init__(self, encoder="vit_h", image_size: int = 1024,
                 prompt_embed_dim: int = 256, mask_in_chans: int = 16,
                 crop_pad_tokens: bool = False, use_hq: bool = False,
                 hq_token_only: bool = False, tp_axis: Optional[str] = None,
                 dp_axis: Optional[str] = None):
        super().__init__()
        if encoder == "vit_t" and tp_axis is not None:
            raise ValueError("tp_axis is only supported for ViT encoder "
                             "variants (vit_b/l/h), not TinyViT")
        self.tp_axis = tp_axis
        self.dp_axis = dp_axis
        self.crop_pad_tokens = crop_pad_tokens
        self.use_hq = use_hq
        self.hq_token_only = hq_token_only
        grid = image_size // 16
        self.image_size = image_size
        if encoder == "vit_t":
            self.image_encoder = TinyViT(img_size=image_size,
                                         out_chans=prompt_embed_dim)
            vit_dim = TINY_VIT_INTERM_DIM
        else:
            cfg = VIT_VARIANTS[encoder] if isinstance(encoder, str) else encoder
            self.image_encoder = ImageEncoderViT(
                img_size=image_size, out_chans=prompt_embed_dim, **cfg)
            vit_dim = cfg["embed_dim"]
        self.prompt_encoder = PromptEncoder(
            embed_dim=prompt_embed_dim, image_embedding_size=(grid, grid),
            input_image_size=(image_size, image_size),
            mask_in_chans=mask_in_chans)
        self.mask_decoder = (
            MaskDecoderHQ(transformer_dim=prompt_embed_dim, vit_dim=vit_dim)
            if use_hq else MaskDecoder(transformer_dim=prompt_embed_dim))

    @property
    def dtype(self) -> torch.dtype:
        return self.mask_decoder.iou_token.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.mask_decoder.iou_token.weight.device

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """[B, h, w, 3] float RGB 0-255 (longest side already resized) ->
        normalised, zero-padded [B, S, S, 3] in the working dtype."""
        mean, std = pixel_stats(images.device)
        x = (images.float() - mean) / std
        _, h, w, _ = x.shape
        x = torch.nn.functional.pad(
            x, (0, 0, 0, self.image_size - w, 0, self.image_size - h))
        return x.to(self.dtype)

    def encode_images(self, images: torch.Tensor):
        """[B, h, w, 3] float 0-255 -> embeddings [B, g, g, 256]; with
        `use_hq`, {'emb': that, 'interm': [B, g, g, vit_dim]}."""
        kwargs = {}
        if isinstance(self.image_encoder, ImageEncoderViT):
            valid_hw = None
            if self.crop_pad_tokens:
                patch = self.image_encoder.patch_embed.proj.kernel_size[0]
                valid_hw = (-(-images.shape[1] // patch),
                            -(-images.shape[2] // patch))
            kwargs["valid_hw"] = valid_hw
        x = self.preprocess(images)
        if self.use_hq:
            emb, interm = self.image_encoder(x, return_interm=True, **kwargs)
            return {"emb": emb, "interm": interm}
        return self.image_encoder(x, **kwargs)

    def decode_masks(self, image_embeddings,
                     points: torch.Tensor, labels: torch.Tensor,
                     mask_input: Optional[torch.Tensor] = None,
                     mask_valid: Optional[torch.Tensor] = None,
                     only_token0: bool = False):
        """Batched prompt -> mask decoding with padded prompts, from
        decode-ready embeddings: [B, g, g, 256], or with `use_hq`
        {'emb': those, 'hq': the image-level features [B, 4g, 4g, 32]}.

        Returns (low-res logits [B, T, 4g, 4g], iou_pred [B, 4]) in f32;
        T = 4, or 1 with `only_token0` (ignored with `use_hq`, whose token
        0 needs the HQ token's mask).
        As `segment_anything` does, one not-a-point pad token is appended
        and attended when no box is given; every other pad slot (and, on
        rows with box corners, every pad slot) is masked out of the
        decoder's token attention.
        """
        if self.use_hq and "hq" not in image_embeddings:
            raise ValueError("HQ-SAM decodes {'emb', 'hq'}: take the "
                             "feature step, SamPredictor.hq_features "
                             "(decode_ready), once a frame first")
        b = points.shape[0]
        points = torch.cat([points, points.new_zeros((b, 1, 2))], dim=1)
        labels = torch.cat([labels, labels.new_full((b, 1), -1)], dim=1)
        is_pad = labels == -1
        first_pad = is_pad & (torch.cumsum(is_pad.int(), dim=1) == 1)
        has_box = (labels >= 2).any(dim=1)
        prompt_valid = ~is_pad | (first_pad & ~has_box[:, None])

        sparse, dense = self.prompt_encoder(points, labels, mask_input,
                                            mask_valid)
        image_pe = self.prompt_encoder.get_dense_pe(points.device)
        dtype = self.dtype
        if self.use_hq:
            masks, iou_pred = self.mask_decoder.forward_features(
                image_embeddings["emb"].to(dtype), image_pe.to(dtype),
                sparse.to(dtype), dense.to(dtype),
                image_embeddings["hq"].to(dtype), prompt_valid)
            masks, iou_pred = masks.float(), iou_pred.float()
            # HQ-SAM's single-mask result as token 0, SAM's multimask
            # tokens 1-3 as they are: the layout callers read.
            single, single_iou = select_hq_masks(
                masks, iou_pred, multimask_output=False,
                hq_token_only=self.hq_token_only)
            return (torch.cat([single, masks[:, 1:4]], dim=1),
                    torch.cat([single_iou, iou_pred[:, 1:4]], dim=1))
        masks, iou_pred = self.mask_decoder(
            image_embeddings.to(dtype), image_pe.to(dtype), sparse.to(dtype),
            dense.to(dtype), prompt_valid, only_token0=only_token0)
        return masks.float(), iou_pred.float()


def build_sam(variant="vit_b", dtype: torch.dtype = torch.float32,
              device="cuda", **kw) -> Sam:
    """`Sam(variant, **kw)` in `dtype` on `device` (PyTorch's default
    initialisation; load a checkpoint with `load_state_dict` or
    `models/sam/factory.py::build_predictor`)."""
    return Sam(variant, **kw).to(device=device, dtype=dtype)
