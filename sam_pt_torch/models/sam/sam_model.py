"""The composed SAM model (counterpart of
`sam_pt_tpu/models/sam/sam_model.py`): image encoder + prompt encoder +
mask decoder, with the public `segment_anything` parameter names."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .image_encoder import VIT_VARIANTS, ImageEncoderViT
from .mask_decoder import MaskDecoder
from .prompt_encoder import PromptEncoder

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


class Sam(nn.Module):
    """Promptable segmentation; mask threshold 0.0 (logits > 0).

    `encoder` is a ViT variant name (`vit_b`, `vit_l`, `vit_h`) or a dict of
    `ImageEncoderViT` arguments. The working dtype is the parameters' dtype
    (`.to(torch.bfloat16)` for the bf16 path). `crop_pad_tokens` (opt-in,
    off by default as in the JAX package): the encoder runs only on the
    tokens that cover the resized frame, and the embedding is zero off it.
    """

    mask_threshold = 0.0

    def __init__(self, encoder="vit_h", image_size: int = 1024,
                 prompt_embed_dim: int = 256, mask_in_chans: int = 16,
                 crop_pad_tokens: bool = False):
        super().__init__()
        self.crop_pad_tokens = crop_pad_tokens
        cfg = VIT_VARIANTS[encoder] if isinstance(encoder, str) else encoder
        grid = image_size // 16
        self.image_size = image_size
        self.image_encoder = ImageEncoderViT(
            img_size=image_size, out_chans=prompt_embed_dim, **cfg)
        self.prompt_encoder = PromptEncoder(
            embed_dim=prompt_embed_dim, image_embedding_size=(grid, grid),
            input_image_size=(image_size, image_size),
            mask_in_chans=mask_in_chans)
        self.mask_decoder = MaskDecoder(transformer_dim=prompt_embed_dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.image_encoder.pos_embed.dtype

    @property
    def device(self) -> torch.device:
        return self.image_encoder.pos_embed.device

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """[B, h, w, 3] float RGB 0-255 (longest side already resized) ->
        normalised, zero-padded [B, S, S, 3] in the working dtype."""
        mean = torch.tensor(PIXEL_MEAN, device=images.device)
        std = torch.tensor(PIXEL_STD, device=images.device)
        x = (images.float() - mean) / std
        _, h, w, _ = x.shape
        x = torch.nn.functional.pad(
            x, (0, 0, 0, self.image_size - w, 0, self.image_size - h))
        return x.to(self.dtype)

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """[B, h, w, 3] float 0-255 -> embeddings [B, g, g, 256]."""
        valid_hw = None
        if self.crop_pad_tokens:
            patch = self.image_encoder.patch_embed.proj.kernel_size[0]
            valid_hw = (-(-images.shape[1] // patch),
                        -(-images.shape[2] // patch))
        return self.image_encoder(self.preprocess(images), valid_hw)

    def decode_masks(self, image_embeddings: torch.Tensor,
                     points: torch.Tensor, labels: torch.Tensor,
                     mask_input: Optional[torch.Tensor] = None,
                     mask_valid: Optional[torch.Tensor] = None,
                     only_token0: bool = False):
        """Batched prompt -> mask decoding with padded prompts.

        Returns (low-res logits [B, T, 4g, 4g], iou_pred [B, 4]) in f32.
        As `segment_anything` does, one not-a-point pad token is appended
        and attended when no box is given; every other pad slot (and, on
        rows with box corners, every pad slot) is masked out of the
        decoder's token attention.
        """
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
        masks, iou_pred = self.mask_decoder(
            image_embeddings.to(dtype), image_pe.to(dtype), sparse.to(dtype),
            dense.to(dtype), prompt_valid, only_token0=only_token0)
        return masks.float(), iou_pred.float()
