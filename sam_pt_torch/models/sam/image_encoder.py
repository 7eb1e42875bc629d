"""SAM ViT-det image encoder (counterpart of
`sam_pt_tpu/models/sam/image_encoder.py`).

Parameter names follow the public `segment_anything` checkpoint
(`image_encoder.blocks.{i}.attn.qkv.weight`, ...), so a real checkpoint
loads with `load_state_dict`. Activations are channels-last ([B, H, W, C]
grids, [B, N, C] token rows), as in the JAX package.

Semantics kept from the JAX package:
  - LayerNorm statistics in float32, output in the working dtype.
  - tanh-GELU in the ViT MLP when the working dtype is bfloat16, exact
    erf-GELU otherwise.
  - Runs of consecutive windowed blocks ("spans") stay window-partitioned;
    the 64-token grid pads to 70 (25 windows of 14 x 14 per frame), and
    the pad slots are zeroed at every block's attention input, then still
    attended, which reproduces SAM's per-block zero padding.
  - At real scale (grid >= 32) the blocks take the raw-qkv route: window
    blocks run kernel K1 and global blocks kernel K2
    (`ops/flash_attention.py`), at the native head dim (80 at ViT-H: no
    padding to 128). Smaller grids take the plain path. An `Attention`
    built on its own runs K4 from 1024 tokens.
  - Tensor parallelism (`parallel/tensor_parallel.py::shard_params_tp`):
    each block of a sharded encoder keeps its rank's heads and hidden
    units and closes its attention and MLP with one `psum` each over the
    model group; the attention runs K1/K2 at the local head count.
  - Pad-token cropping (opt-in, `valid_hw`): the transformer runs only on
    the token rows and columns that cover the resized frame (window spans
    over real windows only, global blocks over the cropped grid with
    center-sliced rel-pos tables), and the embedding's pad region is
    zero-filled. It deviates from the reference, as in the JAX package.
  - The constants a forward reads (`rel_pos_index`, `window_pad_mask`)
    are built and uploaded once per shape and device, so that no call
    waits on the host. The video path (`SamPt._encode_all_frames`)
    captures each encode chunk, from the uint8 frames to the
    embeddings, as one CUDA graph on CUDA and replays it
    (`encode_graphs.py`); `SamPtInteractive` encodes its videos there
    too. The automatic mask generator, the VOS one-point query, a
    predictor on a mesh and a tensor-parallel encoder call the encoder
    eagerly.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import flash_attention as fa
from ...ops.layer_norm import layer_norm
from ...ops.resize import resize_bilinear
from ...parallel import tensor_parallel as tp

VIT_VARIANTS = {
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12,
                  global_attn_indexes=(2, 5, 8, 11)),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16,
                  global_attn_indexes=(5, 11, 17, 23)),
    "vit_h": dict(embed_dim=1280, depth=32, num_heads=16,
                  global_attn_indexes=(7, 15, 23, 31)),
}


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis in the input's dtype: the statistics
    and the affine in float32, one rounding at the output, which is the
    JAX package's FastLayerNorm semantics; parameters are cast to the
    input's dtype. `gelu`: the exact GELU of that output, rounded again, in
    the same call. Rows of at most 256 on the card run kernel K5
    (`ops/layer_norm.py`), wider rows and the CPU PyTorch's LayerNorm."""

    def forward(self, x: torch.Tensor, gelu: bool = False) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, gelu=gelu)


class LayerNorm2d(LayerNorm):
    """SAM's channel LayerNorm (eps 1e-6), on channels-last maps."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(channels, eps=eps)


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW torch convolution to a channels-last tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch_size: int = 16, in_chans: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.proj, x.to(self.proj.weight.dtype))


def rel_pos_table(rel_pos: torch.Tensor, q_size: int, k_size: int,
                  cropped: bool = False) -> torch.Tensor:
    """Resolve a rel-pos parameter [L, C] to the table [q_size, k_size, C]
    (linearly resized first when L != 2 * max(q, k) - 1). `cropped`: the
    grid is a crop of the one the table was sized for, so the table's
    center (the same relative distances) is taken instead of a resize."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if cropped and rel_pos.shape[0] > max_rel_dist:
        center, half = rel_pos.shape[0] // 2, max_rel_dist // 2
        rel_pos = rel_pos[center - half:center + half + 1]
    if rel_pos.shape[0] != max_rel_dist:
        table = resize_bilinear(rel_pos[None, :, :, None],
                                (max_rel_dist, rel_pos.shape[1]))
        rel_pos = table[0, :, :, 0]
    return rel_pos[rel_pos_index(q_size, k_size, rel_pos.device)]


@functools.lru_cache(maxsize=256)
def rel_pos_index(q_size: int, k_size: int,
                  device: torch.device) -> torch.Tensor:
    """The table's row for each (query, key) pair [q_size, k_size], int64
    on `device`, built and uploaded once: the gather from the parameter
    stays in each call, so the table follows the parameter."""
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return torch.as_tensor(rel.astype(np.int64), device=device)


class Attention(nn.Module):
    """Multi-head attention with decomposed rel-pos over a token grid given
    as rows [B, N, C] (N = h * w).

    `raw_qkv` says which route the weights take, as the JAX module's
    `padded_head_dim` / `fused_window` do (`image_encoder.py:283-376`):
      - True (the encoder's blocks at grid >= 32): the kernels read the
        fused qkv projection, K2 from 1024 tokens (any kh x kw), K1 for
        square grids it takes (up to 208 tokens), the plain path below for
        other grids (cropped global grids under 1024 tokens);
      - False (the module built on its own, the default): split q/k/v, K4
        from 1024 tokens, the unfused plain path below.
    The JAX module sends a default-built module whose head dim is a multiple
    of 128 lanes to its raw-qkv kernel; that TPU lane condition has no
    counterpart here, and such a module takes K4 too.
    """

    # Ranks of the model axis this module's heads are sharded over, and
    # their group (`shard_params_tp`); 1: not sharded.
    tp_size = 1
    tp_group = None

    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int],
                 raw_qkv: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.raw_qkv = raw_qkv
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(
            torch.zeros(2 * input_size[0] - 1, self.head_dim))
        self.rel_pos_w = nn.Parameter(
            torch.zeros(2 * input_size[1] - 1, self.head_dim))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                cropped: bool = False) -> torch.Tensor:
        if self.tp_size > 1:
            return tp.tp_shardmap_attention(x, self, hw, cropped)
        return self.proj(self.attend(self.qkv(x), hw, cropped))

    def attend(self, qkv: torch.Tensor, hw: Tuple[int, int],
               cropped: bool = False) -> torch.Tensor:
        """qkv [B, N, 3*H*D], last axis laid out (3, H, D) -> the heads'
        outputs [B, N, H*D] (H: this rank's heads when sharded)."""
        h, w = hw
        heads = self.num_heads
        rh = rel_pos_table(self.rel_pos_h, h, h, cropped).to(qkv.dtype)
        rw = rel_pos_table(self.rel_pos_w, w, w, cropped).to(qkv.dtype)
        if self.raw_qkv and h * w >= 1024:
            return fa.global_attention(qkv, rh, rw, scale=self.scale, kh=h,
                                       kw=w, heads=heads)
        if self.raw_qkv and h == w and h * w <= fa.WINDOW_MAX_TOKENS:
            return fa.window_attention(qkv, rh, rw, scale=self.scale,
                                       heads=heads)
        return self._split_heads(qkv, rh, rw, h, w)

    def _split_heads(self, qkv, rh, rw, h, w):
        """The JAX module's split-q/k/v routes: K4 from 1024 tokens
        (`:319-344`), the unfused path below (`:345-376`). The bias einsums
        run in the input dtype."""
        b, n, _ = qkv.shape
        heads, d = self.num_heads, self.head_dim
        x = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = (t.reshape(b * heads, n, d) for t in x)
        rq = q.reshape(-1, h, w, d)
        bias_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)
        bias_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)
        if n >= 1024:
            out = fa.relpos_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                bias_h.reshape(-1, n, h).contiguous(),
                bias_w.reshape(-1, n, w).contiguous(), scale=self.scale)
        else:
            attn = (q * self.scale) @ k.transpose(-1, -2)
            attn = (attn.reshape(-1, h, w, h, w) + bias_h[..., :, None]
                    + bias_w[..., None, :]).reshape(-1, n, n)
            attn = torch.softmax(attn.float(), dim=-1).to(qkv.dtype)
            out = attn @ v
        out = out.reshape(b, heads, n, d)
        return out.permute(0, 2, 1, 3).reshape(b, n, heads * d)


class MLPBlock(nn.Module):
    tp_size = 1  # as `Attention`'s
    tp_group = None

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    @staticmethod
    def activation(y: torch.Tensor) -> torch.Tensor:
        return F.gelu(y, approximate="tanh" if y.dtype == torch.bfloat16
                      else "none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_size > 1:
            return tp.tp_mlp(x, self)
        return self.lin2(self.activation(self.lin1(x)))


class Block(nn.Module):
    """Pre-norm ViT-det block over token rows [B', N, C]."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 attn_size: Tuple[int, int], raw_qkv: bool):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, attn_size, raw_qkv)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                pad_mask: Optional[torch.Tensor] = None,
                cropped: bool = False) -> torch.Tensor:
        y = self.norm1(x)
        if pad_mask is not None:
            y = y * pad_mask
        x = x + self.attn(y, hw, cropped)
        return x + self.mlp(self.norm2(x))


def window_partition(x: torch.Tensor, window: int):
    """[B, H, W, C] -> ([B * nWin, window^2, C], padded (Hp, Wp)), with
    zero padding to a multiple of the window."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)
    return x, (hp, wp)


def window_unpartition(x: torch.Tensor, window: int, padded_hw, hw):
    """Inverse of `window_partition`, cropping the padding."""
    hp, wp = padded_hw
    h, w = hw
    b = x.shape[0] // ((hp // window) * (wp // window))
    x = x.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w, :]


@functools.lru_cache(maxsize=256)
def window_pad_mask(batch: int, hw, padded_hw, window: int, device,
                    dtype) -> Optional[torch.Tensor]:
    """[B * nWin, window^2, 1]: 1 on real tokens, 0 on pad slots (None
    when the grid divides evenly); built and uploaded once per arguments,
    so it is shared: read it, do not write it."""
    h, w = hw
    hp, wp = padded_hw
    if (hp, wp) == (h, w):
        return None
    real = np.zeros((hp, wp), np.float32)
    real[:h, :w] = 1.0
    m = real.reshape(hp // window, window, wp // window, window)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window * window, 1)
    m = np.tile(m, (batch, 1, 1))
    return torch.as_tensor(m, device=device, dtype=dtype)


class ImageEncoderViT(nn.Module):
    """SAM image encoder: [B, S, S, 3] normalised -> [B, S/16, S/16, 256]."""

    tp_size = 1  # ranks of the model axis (`shard_params_tp`)

    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, out_chans: int = 256,
                 window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11)):
        super().__init__()
        self.grid = img_size // patch_size
        self.window_size = window_size
        self.global_attn_indexes = tuple(global_attn_indexes)
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid, self.grid, embed_dim))
        raw_qkv = self.grid >= 32
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio,
                  (self.grid, self.grid) if i in self.global_attn_indexes
                  else (window_size, window_size), raw_qkv)
            for i in range(depth)
        ])
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, 1, bias=False),
            LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm2d(out_chans),
        )

    def forward(self, x: torch.Tensor,
                valid_hw: Optional[Tuple[int, int]] = None,
                return_interm: bool = False):
        """`valid_hw`: the (rows, cols) of tokens that cover the frame, for
        pad-token cropping; None runs the whole grid. With `return_interm`,
        also the first global block's output [B, g, g, embed_dim] (the
        early features HQ-SAM's decoder reads), zero-filled off the frame
        when cropped."""
        x = self.patch_embed(x)
        x = x + self.pos_embed.to(x.dtype)
        grid = x.shape[1]
        cropped = valid_hw is not None and tuple(valid_hw) != (grid, grid)
        if cropped:
            x = x[:, :valid_hw[0], :valid_hw[1]]
        b, gh, gw, c = x.shape
        win = self.window_size
        i, depth = 0, len(self.blocks)
        interm = None
        while i < depth:
            if i in self.global_attn_indexes:
                x = self.blocks[i](x.reshape(b, gh * gw, c), (gh, gw),
                                   cropped=cropped)
                x = x.reshape(b, gh, gw, c)
                if interm is None:
                    interm = x
                i += 1
                continue
            end = i
            while end < depth and end not in self.global_attn_indexes:
                end += 1
            xw, padded = window_partition(x, win)
            mask = window_pad_mask(b, (gh, gw), padded, win, x.device,
                                   x.dtype)
            for j in range(i, end):
                xw = self.blocks[j](xw, (win, win), mask)
            x = window_unpartition(xw, win, padded, (gh, gw))
            i = end
        x = conv_nhwc(self.neck[0], x)
        x = self.neck[1](x)
        x = conv_nhwc(self.neck[2], x)
        x = self.neck[3](x)
        if cropped:  # the decoder reads the whole grid: zeros off the frame
            x = F.pad(x, (0, 0, 0, grid - gw, 0, grid - gh))
            if interm is not None:
                interm = F.pad(interm, (0, 0, 0, grid - gw, 0, grid - gh))
        if return_interm:
            return x, interm
        return x


def build_image_encoder(variant: str, dtype: torch.dtype = torch.float32,
                        device="cuda", **kw) -> ImageEncoderViT:
    """The ViT encoder of `variant` (`VIT_VARIANTS`), its arguments
    overridden by `kw`, in `dtype` on `device`."""
    cfg = dict(VIT_VARIANTS[variant])
    cfg.update(kw)
    return ImageEncoderViT(**cfg).to(device=device, dtype=dtype)
