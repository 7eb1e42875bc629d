"""HQ-SAM mask decoder (counterpart of
`sam_pt_tpu/models/sam/mask_decoder_hq.py`).

SAM's mask decoder plus a fifth mask token (the HQ token), a
high-resolution feature path built from the image embedding and an early
encoder output (`interm`: the first global block's output of a ViT, the
pre-neck stage-3 output of TinyViT), and an HQ mask head on the fused
features. The path's image-level part (`image_features`) depends on the
image alone: `forward` computes it for its batch, `forward_features`
takes it computed once a frame. The token layout is [iou, sam0,
multi1..3, hq]; the decoder's cross-attention runs kernel K3 with the one
more output token. Parameter
names follow `segment_anything_hq` (`mask_decoder.hf_token`,
`hf_mlp.layers.j`, `embedding_encoder`, `compress_vit_feat` and
`embedding_maskfeature` at `.0`, `.1`, `.3`), so a public
`sam_hq_vit_*.pth` loads as it is.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .image_encoder import LayerNorm2d, conv_nhwc
from .mask_decoder import HyperMLP, MaskDecoder


def _upscale_block(cin: int, mid: int, cout: int, transposed: bool
                   ) -> nn.Sequential:
    """conv, LayerNorm2d, GELU, conv: two 2x2 stride-2 transposed convs
    (`transposed`) or two 3x3 convs at the same size."""
    if transposed:
        first, second = (nn.ConvTranspose2d(cin, mid, 2, 2),
                         nn.ConvTranspose2d(mid, cout, 2, 2))
    else:
        first, second = (nn.Conv2d(cin, mid, 3, 1, 1),
                         nn.Conv2d(mid, cout, 3, 1, 1))
    return nn.Sequential(first, LayerNorm2d(mid), nn.GELU(), second)


def _apply_block(block: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """`_upscale_block` on a channels-last map (its LayerNorm2d and GELU
    in one call)."""
    return conv_nhwc(block[3], block[1](conv_nhwc(block[0], x), gelu=True))


class MaskDecoderHQ(MaskDecoder):
    def __init__(self, transformer_dim: int = 256, vit_dim: int = 1024,
                 num_multimask_outputs: int = 3, iou_head_depth: int = 3,
                 iou_head_hidden_dim: int = 256):
        super().__init__(transformer_dim, num_multimask_outputs,
                         iou_head_depth, iou_head_hidden_dim)
        c = transformer_dim
        self.hf_token = nn.Embedding(1, c)
        self.hf_mlp = HyperMLP(c, c, c // 8)
        self.compress_vit_feat = _upscale_block(vit_dim, c, c // 8, True)
        self.embedding_encoder = _upscale_block(c, c // 4, c // 8, True)
        self.embedding_maskfeature = _upscale_block(c // 8, c // 4, c // 8,
                                                    False)

    def image_features(self, image_embeddings: torch.Tensor,
                       interm_embeddings: torch.Tensor) -> torch.Tensor:
        """The image-level HQ features [B, 4H, 4W, C/8] of embeddings
        [B, H, W, C] and early features [B, H, W, vit_dim]: what the
        published decoder computes once an image and repeats over its
        prompts (`hq_features`)."""
        dtype = image_embeddings.dtype
        return (_apply_block(self.embedding_encoder, image_embeddings)
                + _apply_block(self.compress_vit_feat,
                               interm_embeddings.to(dtype)))

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt,
                interm_embeddings, prompt_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (mask logits [B, 5, 4H, 4W] for tokens [sam0, multi1..3,
        hq], iou_pred [B, 4]); `select_hq_masks` combines them."""
        return self.forward_features(
            image_embeddings, image_pe, sparse_prompt, dense_prompt,
            self.image_features(image_embeddings, interm_embeddings),
            prompt_valid)

    def forward_features(self, image_embeddings, image_pe, sparse_prompt,
                         dense_prompt, hq_features: torch.Tensor,
                         prompt_valid: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`forward` with the image-level features `hq_features` [B, 4H,
        4W, C/8] (`image_features`) given, computed once a frame."""
        b = sparse_prompt.shape[0]
        out_tokens = torch.cat([self.iou_token.weight,
                                self.mask_tokens.weight,
                                self.hf_token.weight], dim=0)
        n_out = out_tokens.shape[0]
        out_tokens = out_tokens[None].expand(b, -1, -1).to(sparse_prompt.dtype)
        tokens = torch.cat([out_tokens, sparse_prompt], dim=1)
        token_valid = None
        if prompt_valid is not None:
            token_valid = torch.cat([
                torch.ones((b, n_out), dtype=torch.bool,
                           device=prompt_valid.device), prompt_valid], dim=1)

        src = image_embeddings + dense_prompt
        hs, src_out = self.transformer(src, image_pe, tokens, token_valid)
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1:n_out, :]

        upscaled_sam = self.upscale(src_out, image_embeddings.shape[1],
                                    image_embeddings.shape[2])
        upscaled_hq = (_apply_block(self.embedding_maskfeature, upscaled_sam)
                       + hq_features)

        mlps = list(self.output_hypernetworks_mlps) + [self.hf_mlp]
        hyper_in = torch.stack([mlp(mask_tokens_out[:, i, :])
                                for i, mlp in enumerate(mlps)], dim=1)
        n_sam = self.num_mask_tokens
        masks = torch.cat([
            torch.einsum("btc,bhwc->bthw", hyper_in[:, :n_sam], upscaled_sam),
            torch.einsum("btc,bhwc->bthw", hyper_in[:, n_sam:], upscaled_hq),
        ], dim=1)
        return masks, self.iou_prediction_head(iou_token_out)


def select_hq_masks(masks: torch.Tensor, iou_pred: torch.Tensor,
                    multimask_output: bool, hq_token_only: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HQ-SAM's output selection: masks [B, 5, h, w] (tokens [sam0,
    multi1..3, hq]), iou_pred [B, 4] -> ([B, 1, h, w], [B, 1]): the SAM
    mask (token 0, or with `multimask_output` the best of tokens 1-3 by
    predicted IoU) plus the HQ mask, or the HQ mask alone with
    `hq_token_only`; the SAM mask's IoU."""
    if multimask_output:
        iou_multi = iou_pred[:, 1:4]
        best = iou_multi.argmax(dim=1)
        rows = torch.arange(masks.shape[0], device=masks.device)
        sam_mask = masks[:, 1:4][rows, best][:, None]
        iou_out = iou_multi[rows, best][:, None]
    else:
        sam_mask = masks[:, 0:1]
        iou_out = iou_pred[:, 0:1]
    hq = masks[:, 4:5]
    return (hq if hq_token_only else sam_mask + hq), iou_out
