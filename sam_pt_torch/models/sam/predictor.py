"""Batched SAM predictor (counterpart of `sam_pt_tpu/models/sam/predictor.py`).

`encode_frames` embeds a batch of frames (the antialiased longest-side
resize runs on the device); `decode` decodes a batch of (embedding,
prompt-set) pairs with label -1 padding, in model-input coordinates;
`predict` does the same from original image pixels and picks SAM's single
or multimask output tokens. `scale_coords` maps original pixels to
model-input coordinates. With an HQ-SAM model the embeddings are
{'emb', 'interm'} dicts (`Sam.encode_images`), passed on as they are.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...ops.resize import (
    get_longest_side_target_hw,
    resize_bilinear,
    resize_planes,
)
from .sam_model import Sam


class SamPredictor:
    def __init__(self, model: Sam, *, antialias: bool = True):
        self.model = model
        self.antialias = antialias

    @torch.no_grad()
    def encode_frames(self, images: torch.Tensor,
                      original_hw: Tuple[int, int]):
        """images [B, H, W, 3] uint8/float RGB at original resolution, on
        the model's device -> embeddings [B, g, g, 256] (with HQ-SAM, the
        dict of `Sam.encode_images`)."""
        target_hw = get_longest_side_target_hw(
            original_hw[0], original_hw[1], self.model.image_size)
        x = resize_bilinear(images.float(), target_hw,
                            antialias=self.antialias)
        return self.model.encode_images(x)

    def scale_coords(self, coords: torch.Tensor,
                     original_hw: Tuple[int, int]) -> torch.Tensor:
        """Original-pixel (x, y) -> model-input coordinates."""
        th, tw = get_longest_side_target_hw(
            original_hw[0], original_hw[1], self.model.image_size)
        scale = torch.tensor([tw / original_hw[1], th / original_hw[0]],
                             dtype=torch.float32, device=coords.device)
        return coords * scale

    @torch.no_grad()
    def decode(self, embeddings, points: torch.Tensor,
               labels: torch.Tensor, mask_input: Optional[torch.Tensor] = None,
               mask_valid: Optional[torch.Tensor] = None,
               only_token0: bool = False):
        """Model-space prompts -> (logits [B, T, 4g, 4g], iou [B, 4]); an
        HQ-SAM model decodes every token (its token 0 reads the HQ one)."""
        return self.model.decode_masks(
            embeddings, points, labels, mask_input, mask_valid,
            only_token0=only_token0 and not self.model.use_hq)

    @torch.no_grad()
    def predict(self, embeddings, points, labels,
                original_hw: Tuple[int, int],
                mask_input: Optional[torch.Tensor] = None,
                mask_valid: Optional[torch.Tensor] = None,
                multimask_output: bool = False):
        """Batched predict from original-pixel prompts: embeddings
        [B, g, g, 256], points [B, N, 2] (x, y), labels [B, N] (-1 = pad).
        Returns (low-res logits [B, K, 4g, 4g], iou [B, K], the token
        slice) with K = 3 (tokens 1-3) if `multimask_output`, else 1
        (token 0)."""
        device = self.model.device
        pts = self.scale_coords(
            torch.as_tensor(points, dtype=torch.float32, device=device),
            original_hw)
        lbl = torch.as_tensor(labels, device=device).long()
        masks, iou = self.decode(embeddings, pts, lbl, mask_input, mask_valid)
        tokens = slice(1, 4) if multimask_output else slice(0, 1)
        return masks[:, tokens], iou[:, tokens], tokens

    def upscale_logits(self, low_res_logits: torch.Tensor,
                       original_hw: Tuple[int, int]) -> torch.Tensor:
        """[..., 4g, 4g] -> [..., H, W]: bilinear to the model size, crop
        the padding, bilinear to the original size."""
        th, tw = get_longest_side_target_hw(
            original_hw[0], original_hw[1], self.model.image_size)
        size = self.model.image_size
        x = resize_planes(low_res_logits, (size, size), crop_hw=(th, tw))
        return resize_planes(x, original_hw)
