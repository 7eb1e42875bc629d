"""SAM mask decoder: TwoWayTransformer + hypernetwork mask heads (counterpart
of `sam_pt_tpu/models/sam/mask_decoder.py`).

Batched over (image embedding, prompt set) pairs. Image-side attention
(a query or key side of >= 1024 tokens) runs kernel K3
(`ops/flash_attention.cross_attention`): token-to-image unmasked,
image-to-token with the prompt-token validity as its key mask. Token
self-attention stays plain, with the -1e9 key mask. Parameter names follow
`segment_anything`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import flash_attention as fa
from .image_encoder import LayerNorm, LayerNorm2d, conv_nhwc


def _ln(dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=1e-6)


class Attention(nn.Module):
    """MHA with an internally downsampled channel dim (SAM decoder style)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 downsample_rate: int = 1):
        super().__init__()
        self.num_heads = num_heads
        internal = embed_dim // downsample_rate
        self.head_dim = internal // num_heads
        self.q_proj = nn.Linear(embed_dim, internal)
        self.k_proj = nn.Linear(embed_dim, internal)
        self.v_proj = nn.Linear(embed_dim, internal)
        self.out_proj = nn.Linear(internal, embed_dim)

    def forward(self, q, k, v, kv_valid: Optional[torch.Tensor] = None):
        qp, kp, vp = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        divisor = self.head_dim ** 0.5
        if q.shape[1] >= 1024 or k.shape[1] >= 1024:
            out = fa.cross_attention(qp, kp, vp, heads=self.num_heads,
                                     divisor=divisor, kv_valid=kv_valid)
            return self.out_proj(out)
        b = q.shape[0]

        def split(x):
            return x.reshape(b, x.shape[1], self.num_heads,
                             self.head_dim).transpose(1, 2)

        logits = (split(qp) @ split(kp).transpose(-1, -2)) / divisor
        if kv_valid is not None:
            logits = torch.where(kv_valid[:, None, None, :], logits,
                                 torch.tensor(-1e9, dtype=logits.dtype,
                                              device=logits.device))
        attn = torch.softmax(logits.float(), dim=-1).to(qp.dtype)
        out = (attn @ split(vp)).transpose(1, 2).reshape(b, q.shape[1], -1)
        return self.out_proj(out)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = Attention(embed_dim, num_heads)
        self.norm1 = _ln(embed_dim)
        self.cross_attn_token_to_image = Attention(
            embed_dim, num_heads, attention_downsample_rate)
        self.norm2 = _ln(embed_dim)
        self.mlp = MLPBlock(embed_dim, mlp_dim)
        self.norm3 = _ln(embed_dim)
        self.norm4 = _ln(embed_dim)
        self.cross_attn_image_to_token = Attention(
            embed_dim, num_heads, attention_downsample_rate)

    def forward(self, queries, keys, query_pe, key_pe, token_valid=None):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries, token_valid)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries, token_valid)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))

        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(
            keys + self.cross_attn_image_to_token(k, q, queries, token_valid))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embed_dim: int = 256,
                 num_heads: int = 8, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2):
        super().__init__()
        self.layers = nn.ModuleList([
            TwoWayAttentionBlock(embed_dim, num_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0))
            for i in range(depth)
        ])
        self.final_attn_token_to_image = Attention(
            embed_dim, num_heads, attention_downsample_rate)
        self.norm_final_attn = _ln(embed_dim)

    def forward(self, image_embedding, image_pe, point_embedding,
                token_valid=None):
        """image_embedding/image_pe [B, H, W, C]; point_embedding [B, T, C];
        token_valid [B, T] bool or None."""
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(-1, h * w, c).expand_as(keys)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe,
                                  token_valid)
        q = queries + point_embedding
        k = keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class HyperMLP(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 3):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(
            [nn.Linear(i, o) for i, o in zip(dims, dims[1:] + [output_dim])])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256,
                 num_multimask_outputs: int = 3, iou_head_depth: int = 3,
                 iou_head_hidden_dim: int = 256):
        super().__init__()
        c = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(embed_dim=c)
        self.iou_token = nn.Embedding(1, c)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, c)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(c, c // 4, 2, 2),
            LayerNorm2d(c // 4),
            nn.GELU(),
            nn.ConvTranspose2d(c // 4, c // 8, 2, 2),
            nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(
            [HyperMLP(c, c, c // 8) for _ in range(self.num_mask_tokens)])
        self.iou_prediction_head = HyperMLP(
            c, iou_head_hidden_dim, self.num_mask_tokens, iou_head_depth)

    def upscale(self, src_out: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """The transformer's image side [B, H*W, C] -> [B, 4H, 4W, C/8]:
        transposed conv, LayerNorm2d and GELU in one call, transposed conv,
        GELU."""
        up = self.output_upscaling
        x = up[1](conv_nhwc(up[0], src_out.reshape(src_out.shape[0], h, w,
                                                   -1)), gelu=True)
        return F.gelu(conv_nhwc(up[3], x))

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt,
                prompt_valid: Optional[torch.Tensor] = None,
                only_token0: bool = False):
        """Returns (mask logits [B, T, 4H, 4W], iou_pred [B, 4]) with T = 4,
        or T = 1 (token 0 only) when `only_token0`."""
        b = sparse_prompt.shape[0]
        out_tokens = torch.cat([self.iou_token.weight,
                                self.mask_tokens.weight], dim=0)
        out_tokens = out_tokens[None].expand(b, -1, -1).to(sparse_prompt.dtype)
        tokens = torch.cat([out_tokens, sparse_prompt], dim=1)
        token_valid = None
        if prompt_valid is not None:
            token_valid = torch.cat([
                torch.ones((b, 1 + self.num_mask_tokens), dtype=torch.bool,
                           device=prompt_valid.device),
                prompt_valid], dim=1)

        src = image_embeddings + dense_prompt
        hs, src_out = self.transformer(src, image_pe, tokens, token_valid)
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens, :]

        upscaled = self.upscale(src_out, image_embeddings.shape[1],
                                image_embeddings.shape[2])

        n_tok = 1 if only_token0 else self.num_mask_tokens
        hyper_in = torch.stack(
            [self.output_hypernetworks_mlps[i](mask_tokens_out[:, i, :])
             for i in range(n_tok)], dim=1)  # [B, n_tok, C/8]
        masks = torch.einsum("btc,bhwc->bthw", hyper_in, upscaled)
        iou_pred = self.iou_prediction_head(iou_token_out)
        return masks, iou_pred
