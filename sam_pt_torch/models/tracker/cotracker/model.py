"""CoTracker v1 window model (counterpart of
`sam_pt_tpu/models/tracker/cotracker/model.py`).

BasicEncoder features (stride 4), a 4-level correlation pyramid sampled at
radius 3, and the UpdateFormer: time-attention blocks over each track's
window frames interleaved with space-attention blocks across tracks, with
not-yet-active tracks masked out of the space attention. Parameter names
follow the published CoTracker v1 checkpoint (`fnet.*`,
`updateformer.time_blocks.{i}.attn.qkv.weight`, `norm.*`,
`ffeat_updater.0.*`, `vis_predictor.0.*`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.posemb import (
    get_1d_sincos_embedding,
    get_2d_sincos_embedding,
    sincos_pos_embed_2d_grid,
)
from ....ops.sampling import bilinear_sample
from ..pips.model import BasicEncoder, correlation_pyramid, sample_corr_pyramid


class MHA(nn.Module):
    """timm-style attention; keys where `key_mask` is False get a -1e30
    logit in f32 (an exact zero weight, finite if all are masked)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, key_mask: Optional[torch.Tensor] = None):
        b, l, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(b, l, 3, self.num_heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = ((q @ k.transpose(-1, -2)) / (hd ** 0.5)).float()
        if key_mask is not None:
            attn = attn.masked_fill(~key_mask[None, None, None, :], -1e30)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, l, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def _plain_ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm (float32 statistics inside PyTorch's kernel)."""
    return F.layer_norm(x, x.shape[-1:], eps=eps)


class AttnBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.attn = MHA(dim, num_heads)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, key_mask=None):
        x = x + self.attn(_plain_ln(x), key_mask)
        return x + self.mlp(_plain_ln(x))


class UpdateFormer(nn.Module):
    """Interleaved time/track attention over [N, S, C] window tokens."""

    def __init__(self, space_depth: int = 6, time_depth: int = 6,
                 input_dim: int = 456, hidden_size: int = 384,
                 num_heads: int = 8, output_dim: int = 130,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.input_transform = nn.Linear(input_dim, hidden_size)
        self.time_blocks = nn.ModuleList(
            [AttnBlock(hidden_size, num_heads, mlp_ratio)
             for _ in range(time_depth)])
        self.space_blocks = nn.ModuleList(
            [AttnBlock(hidden_size, num_heads, mlp_ratio)
             for _ in range(space_depth)])
        self.flow_head = nn.Linear(hidden_size, output_dim)

    def forward(self, tokens, active: Optional[torch.Tensor] = None):
        """tokens [N, S, input_dim]; active [N] bool (tracks visible to the
        cross-track attention)."""
        x = self.input_transform(tokens)
        time_depth, space_depth = len(self.time_blocks), len(self.space_blocks)
        stride = max(1, time_depth // max(space_depth, 1))
        j = 0
        for i, block in enumerate(self.time_blocks):
            x = block(x)
            if i % stride == 0 and j < space_depth:
                x = self.space_blocks[j](x.transpose(0, 1),
                                         key_mask=active).transpose(0, 1)
                j += 1
        return self.flow_head(x)


class CoTracker(nn.Module):
    """Window model over precomputed feature maps."""

    def __init__(self, s: int = 8, stride: int = 4, latent_dim: int = 128,
                 corr_levels: int = 4, corr_radius: int = 3,
                 input_dim: int = 456, hidden_size: int = 384,
                 num_heads: int = 8, space_depth: int = 6,
                 time_depth: int = 6):
        super().__init__()
        self.s = s
        self.stride = stride
        self.latent_dim = latent_dim
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.input_dim = input_dim
        self.fnet = BasicEncoder(output_dim=latent_dim, stride=stride)
        self.updateformer = UpdateFormer(
            space_depth=space_depth, time_depth=time_depth,
            input_dim=input_dim, hidden_size=hidden_size,
            num_heads=num_heads, output_dim=latent_dim + 2)
        self.norm = nn.LayerNorm(latent_dim, eps=1e-5)
        self.ffeat_updater = nn.Sequential(nn.Linear(latent_dim, latent_dim),
                                           nn.GELU())
        self.vis_predictor = nn.Sequential(nn.Linear(latent_dim, 1))

    @property
    def dtype(self) -> torch.dtype:
        return self.norm.weight.dtype

    def encode_frames(self, rgbs: torch.Tensor) -> torch.Tensor:
        """[T, H, W, 3] float 0-255 -> fmaps [T, H/stride, W/stride, C]."""
        x = 2.0 * (rgbs.float() / 255.0) - 1.0
        return self.fnet(x.to(self.dtype))

    def forward(self, fmaps, coords_init, feats_init, track_mask,
                iters: int = 4, vis_init: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None):
        """One window refinement.

        fmaps [S, H8, W8, C]; coords_init [S, N, 2] feature-grid coords;
        feats_init [N, C]; track_mask [S, N] float; vis_init [S, N] (None =
        10.0); active [N] bool. Returns (coords [S, N, 2], vis_logits
        [S, N], feats [S, N, C]).
        """
        s, h8, w8, c = fmaps.shape
        n = coords_init.shape[1]
        device = fmaps.device
        pe_table = sincos_pos_embed_2d_grid(self.input_dim, (h8, w8), device)
        pos = bilinear_sample(pe_table[None], coords_init[0:1, :, 0],
                              coords_init[0:1, :, 1])[0]  # [N, input_dim]
        times = get_1d_sincos_embedding(
            torch.arange(s, dtype=torch.float32, device=device),
            self.input_dim)  # [S, input_dim]

        coords = coords_init.float()
        ffeats = feats_init.float()[None].expand(s, n, c)
        vis_chan = (torch.full((s, n, 1), 10.0, device=device)
                    if vis_init is None else vis_init[..., None].float())
        for _ in range(iters):
            pyramid = correlation_pyramid(fmaps, ffeats, self.corr_levels)
            fcorrs = sample_corr_pyramid(pyramid, coords, self.corr_radius)
            flows_emb = get_2d_sincos_embedding(coords - coords[0:1], 64,
                                                cat_coords=True)
            tokens = torch.cat([flows_emb, fcorrs, ffeats], dim=-1)
            pad = self.input_dim - tokens.shape[-1] - 2
            if pad > 0:
                tokens = torch.cat(
                    [tokens, tokens.new_zeros((s, n, pad))], dim=-1)
            tokens = torch.cat(
                [tokens, track_mask[..., None].float(), vis_chan], dim=-1)
            tokens = tokens + pos[None] + times[:, None]

            delta = self.updateformer(
                tokens.transpose(0, 1).to(self.dtype), active)
            delta = delta.transpose(0, 1)  # [S, N, C + 2]
            upd = self.ffeat_updater(self.norm(delta[..., 2:]))
            ffeats = ffeats + upd
            coords = coords + delta[..., :2]
        vis_logits = self.vis_predictor(ffeats.to(self.dtype))[..., 0]
        return coords, vis_logits.float(), ffeats
