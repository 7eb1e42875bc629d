"""TinyViT-5M image encoder of MobileSAM (counterpart of
`sam_pt_tpu/models/sam/tiny_vit.py`).

Embed dims (64, 128, 160, 320), depths (2, 2, 6, 2), heads (2, 4, 5, 10),
windows (7, 7, 14, 7): a conv stem (/4), one MBConv stage, then three
window-attention stages with LeViT-style learned attention biases, patch
merging between stages (stride 1 into the 320-wide stage, so the grid stays
64 x 64 at 1024 pixels), then SAM's neck to 256 channels. Channels-last
throughout, as the JAX package; BatchNorm at inference, from its running
statistics. Parameter names follow MobileSAM's `mobile_sam.pt`
(`patch_embed.seq.{0,2}`, `layers.i.blocks.j.*`, `layers.i.downsample.*`,
`attention_biases`), so the public file loads as it is (its classifier
head's keys are not used).

`TinyAttention` is plain attention (no Pallas kernel in the JAX package
either). As in the JAX package, the LayerNorms take flax's default
epsilon 1e-6 (the original TinyViT uses torch's 1e-5).
"""
from __future__ import annotations

import functools
import itertools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..batch_norm import InferenceBatchNorm
from .image_encoder import LayerNorm, LayerNorm2d, conv_nhwc

LN_EPS = 1e-6


class ConvBN(nn.Module):
    """Conv2d (no bias) + inference BatchNorm, on channels-last maps
    (MobileSAM's Conv2d_BN: `c`, `bn`)."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 padding: int = 0, groups: int = 1):
        super().__init__()
        self.c = nn.Conv2d(cin, cout, kernel, stride, padding, groups=groups,
                           bias=False)
        self.bn = InferenceBatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.c(x.permute(0, 3, 1, 2))
        return self.bn(x).permute(0, 2, 3, 1)


class PatchEmbed(nn.Module):
    """Two stride-2 3x3 ConvBNs with a GELU between: /4."""

    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.seq = nn.Sequential(ConvBN(cin, dim // 2, 3, 2, 1), nn.GELU(),
                                 ConvBN(dim // 2, dim, 3, 2, 1))

    def forward(self, x):
        return self.seq[2](F.gelu(self.seq[0](x)))


class MBConv(nn.Module):
    def __init__(self, dim: int, expand_ratio: float = 4.0):
        super().__init__()
        hidden = int(dim * expand_ratio)
        self.conv1 = ConvBN(dim, hidden)
        self.conv2 = ConvBN(hidden, hidden, 3, 1, 1, groups=hidden)
        self.conv3 = ConvBN(hidden, dim)

    def forward(self, x):
        y = F.gelu(self.conv1(x))
        y = F.gelu(self.conv2(y))
        return F.gelu(x + self.conv3(y))


class PatchMerging(nn.Module):
    """1x1 expand, 3x3 depthwise (stride 2, or 1 into a 320/448/576-wide
    stage), 1x1 project."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        stride = 1 if out_dim in (320, 448, 576) else 2
        self.conv1 = ConvBN(dim, out_dim)
        self.conv2 = ConvBN(out_dim, out_dim, 3, stride, 1, groups=out_dim)
        self.conv3 = ConvBN(out_dim, out_dim)

    def forward(self, x):
        y = F.gelu(self.conv1(x))
        y = F.gelu(self.conv2(y))
        return self.conv3(y)


@functools.lru_cache(maxsize=None)
def _rel_bias_index(window: int) -> np.ndarray:
    """LeViT's table: each (query, key) pair of a window's points -> the
    slot of its (|dy|, |dx|) offset, slots numbered in order of first
    appearance."""
    points = list(itertools.product(range(window), range(window)))
    offsets = {}
    idxs = np.zeros((len(points), len(points)), np.int64)
    for i, p1 in enumerate(points):
        for j, p2 in enumerate(points):
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs[i, j] = offsets[off]
    return idxs


@functools.lru_cache(maxsize=None)
def _device_rel_bias_index(window: int, device: torch.device) -> torch.Tensor:
    """`_rel_bias_index` on `device`, uploaded once."""
    return torch.as_tensor(_rel_bias_index(window), device=device)


class TinyAttention(nn.Module):
    """LeViT attention over a window's tokens: LayerNorm, fused qkv (key
    dim = value dim = dim / heads), a learned bias per head and offset."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.key_dim = dim // num_heads
        self.window = window
        self.norm = LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        slots = int(_rel_bias_index(window).max()) + 1
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, slots))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, L, C]
        b, n, _ = x.shape
        heads, kd = self.num_heads, self.key_dim
        qkv = self.qkv(self.norm(x)).reshape(b, n, heads, 3 * kd)
        q, k, v = qkv.permute(0, 2, 1, 3).split(kd, dim=-1)
        idx = _device_rel_bias_index(self.window, x.device)
        bias = self.attention_biases[:, idx].to(x.dtype)  # [heads, L, L]
        attn = (q @ k.transpose(-1, -2)) * kd ** -0.5 + bias[None]
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, n, heads * kd)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm = LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.norm(x))))


class TinyViTBlock(nn.Module):
    """Window attention (the grid zero-padded to a multiple of the window),
    a residual, the 3x3 depthwise `local_conv` in place on the stream, then
    the MLP with its residual."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window = window
        self.attn = TinyAttention(dim, num_heads, window)
        self.local_conv = ConvBN(dim, dim, 3, 1, 1, groups=dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        b, h, w, c = x.shape
        win = self.window
        pad_h, pad_w = (win - h % win) % win, (win - w % win) % win
        y = F.pad(x, (0, 0, 0, pad_w, 0, pad_h)) if pad_h or pad_w else x
        hp, wp = h + pad_h, w + pad_w
        y = y.reshape(b, hp // win, win, wp // win, win, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)
        y = self.attn(y)
        y = y.reshape(b, hp // win, wp // win, win, win, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)[:, :h, :w]
        x = self.local_conv(x + y)
        return x + self.mlp(x)


class BasicLayer(nn.Module):
    """A stage's blocks and the patch merging that ends it (MobileSAM's
    layout: `layers.i.downsample` leads into stage i + 1)."""

    def __init__(self, blocks: Sequence[nn.Module], downsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return self.downsample(x) if self.downsample is not None else x


class TinyViT(nn.Module):
    """[B, S, S, 3] normalised -> [B, S/16, S/16, out_chans]."""

    def __init__(self, img_size: int = 1024, in_chans: int = 3,
                 embed_dims: Sequence[int] = (64, 128, 160, 320),
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (2, 4, 5, 10),
                 window_sizes: Sequence[int] = (7, 7, 14, 7),
                 mlp_ratio: float = 4.0, out_chans: int = 256):
        super().__init__()
        self.img_size = img_size
        self.patch_embed = PatchEmbed(in_chans, embed_dims[0])
        layers = []
        for s, depth in enumerate(depths):
            if s == 0:
                blocks = [MBConv(embed_dims[0]) for _ in range(depth)]
            else:
                blocks = [TinyViTBlock(embed_dims[s], num_heads[s],
                                       window_sizes[s], mlp_ratio)
                          for _ in range(depth)]
            merge = (PatchMerging(embed_dims[s], embed_dims[s + 1])
                     if s + 1 < len(depths) else None)
            layers.append(BasicLayer(blocks, merge))
        self.layers = nn.ModuleList(layers)
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dims[-1], out_chans, 1, bias=False),
            LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm2d(out_chans),
        )

    def forward(self, x: torch.Tensor, return_interm: bool = False):
        """With `return_interm`, also the pre-neck output of the last stage
        [B, g, g, 320] (the JAX package's choice of Light HQ-SAM's early
        features)."""
        x = self.patch_embed(x.to(self.neck[0].weight.dtype))
        for layer in self.layers:
            x = layer(x)
        interm = x
        x = self.neck[1](conv_nhwc(self.neck[0], x))
        x = self.neck[3](conv_nhwc(self.neck[2], x))
        if return_interm:
            return x, interm
        return x
