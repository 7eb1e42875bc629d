"""SAM prompt encoder, batched with padded prompts (counterpart of
`sam_pt_tpu/models/sam/prompt_encoder.py`).

Prompts are fixed-shape: points [B, N, 2] (x, y) in model-input pixels and
labels [B, N] with 1 = positive, 0 = negative, 2/3 = box corners and
-1 = padding (the not-a-point embedding). Parameter names follow
`segment_anything` (`prompt_encoder.mask_downscaling.0.weight`, ...).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .image_encoder import LayerNorm2d, conv_nhwc


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding of [0, 1] coordinates."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:
        c = 2.0 * coords01 - 1.0
        c = (2.0 * math.pi) * (
            c @ self.positional_encoding_gaussian_matrix.to(c.dtype))
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024),
                 mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(
            [nn.Embedding(1, embed_dim) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, 2),
            LayerNorm2d(mask_in_chans // 4),
            nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, 2),
            LayerNorm2d(mask_in_chans),
            nn.GELU(),
            nn.Conv2d(mask_in_chans, embed_dim, 1),
        )
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self, device) -> torch.Tensor:
        """Positional encoding of the embedding grid: [1, H, W, C] f32."""
        h, w = self.image_embedding_size
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
        return self.pe_layer(grid)[None]

    def encode_points(self, points: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
        """points [B, N, 2], labels [B, N] -> sparse embeddings [B, N, C]."""
        size = torch.tensor(
            [self.input_image_size[1], self.input_image_size[0]],
            dtype=points.dtype, device=points.device)
        pe = self.pe_layer((points + 0.5) / size)
        table = torch.cat(
            [self.not_a_point_embed.weight]
            + [e.weight for e in self.point_embeddings], dim=0
        ).to(pe.dtype)  # [5, C]: label -1, 0, 1, 2, 3
        pe = torch.where((labels == -1)[..., None], torch.zeros_like(pe), pe)
        return pe + table[labels.long() + 1]

    def encode_boxes(self, boxes) -> torch.Tensor:
        """boxes [B, 4] (x1, y1, x2, y2) in model-input pixels, numpy or a
        tensor -> corner embeddings [B, 2, C] (labels 2 and 3), on the
        encoder's device."""
        device = self.not_a_point_embed.weight.device
        corners = torch.as_tensor(boxes, dtype=torch.float32,
                                  device=device).reshape(-1, 2, 2)
        labels = torch.tensor([2, 3], device=device).expand(
            corners.shape[0], 2)
        return self.encode_points(corners, labels)

    def encode_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """masks [B, 4H, 4W, 1] logits -> dense embedding [B, H, W, C]."""
        md = self.mask_downscaling
        x = md[1](conv_nhwc(md[0], masks.to(md[0].weight.dtype)), gelu=True)
        x = md[4](conv_nhwc(md[3], x), gelu=True)
        return conv_nhwc(md[6], x)

    def no_mask_dense(self, batch: int) -> torch.Tensor:
        h, w = self.image_embedding_size
        return self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
            batch, h, w, self.embed_dim)

    def forward(self, points: torch.Tensor, labels: torch.Tensor,
                masks: Optional[torch.Tensor] = None,
                mask_valid: Optional[torch.Tensor] = None):
        """Returns (sparse [B, N, C], dense [B, H, W, C]). Rows whose
        `mask_valid` is False use the no-mask embedding."""
        sparse = self.encode_points(points, labels)
        batch = points.shape[0]
        if masks is None:
            return sparse, self.no_mask_dense(batch)
        dense = self.encode_masks(masks)
        if mask_valid is not None:
            dense = torch.where(mask_valid[:, None, None, None], dense,
                                self.no_mask_dense(batch).to(dense.dtype))
        return sparse, dense
