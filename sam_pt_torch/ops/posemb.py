"""Sinusoidal positional embeddings (counterpart of `sam_pt_tpu/ops/posemb.py`).

The feature layouts match the JAX package exactly, because converted
checkpoints expect them.
"""
from __future__ import annotations

import torch


def get_1d_sincos_embedding(x: torch.Tensor, dim: int,
                            temperature: float = 10000.0) -> torch.Tensor:
    """Generic [...] -> [..., dim] transformer sincos embedding."""
    half = dim // 2
    freqs = torch.arange(half, dtype=torch.float32, device=x.device)
    inv = 1.0 / (temperature ** (freqs / half))
    ang = x[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _interleaved(v: torch.Tensor, div_term: torch.Tensor) -> torch.Tensor:
    """v [..., 1] -> [..., C] with slot 2k = sin(v f_k), 2k+1 = cos(v f_k)."""
    ang = v * div_term
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).flatten(-2)


def get_2d_sincos_embedding(xy: torch.Tensor, num_channels: int,
                            cat_coords: bool = True) -> torch.Tensor:
    """Per-coordinate interleaved sin/cos embedding of [..., 2] coords.

    Frequencies f_k = 2k * 1000 / C; blocks [emb_x, emb_y], with the raw
    coords PREPENDED when `cat_coords` (CoTracker v1's layout).
    """
    c = num_channels
    div_term = torch.arange(0, c, 2, dtype=torch.float32,
                            device=xy.device) * (1000.0 / c)
    pe = torch.cat([_interleaved(xy[..., 0:1], div_term),
                    _interleaved(xy[..., 1:2], div_term)], dim=-1)
    if cat_coords:
        pe = torch.cat([xy, pe], dim=-1)
    return pe


def get_3d_sincos_embedding(xyz: torch.Tensor, num_channels: int,
                            cat_coords: bool = True) -> torch.Tensor:
    """PIPS flow embedding of [B, N, 3] vectors: [emb_x, emb_y, emb_z] with
    the raw (x, y, z) APPENDED when `cat_coords`."""
    c = num_channels
    div_term = torch.arange(0, c, 2, dtype=torch.float32,
                            device=xyz.device) * (1000.0 / c)
    pe = torch.cat([_interleaved(xyz[..., i:i + 1], div_term)
                    for i in range(3)], dim=-1)
    if cat_coords:
        pe = torch.cat([pe, xyz], dim=-1)
    return pe


def posemb_sincos_2d_xy(xy: torch.Tensor, num_channels: int,
                        temperature: float = 10000.0,
                        cat_coords: bool = False) -> torch.Tensor:
    """PIPS++ embedding of [B, S, 2] coords: omega_k = 1 / T^(k / (C/4 - 1))
    for k < C/4, blocks [sin(x w), cos(x w), sin(y w), cos(y w)], with the
    raw (x, y) APPENDED when `cat_coords`."""
    c = num_channels
    if c % 4:
        raise ValueError("the feature dimension must be a multiple of 4")
    omega = torch.arange(c // 4, dtype=torch.float32,
                         device=xy.device) / (c // 4 - 1)
    omega = 1.0 / (temperature ** omega)
    x = xy[..., 0:1] * omega
    y = xy[..., 1:2] * omega
    pe = torch.cat([torch.sin(x), torch.cos(x), torch.sin(y), torch.cos(y)],
                   dim=-1)
    if cat_coords:
        pe = torch.cat([pe, xy], dim=-1)
    return pe


def sincos_pos_embed_2d_grid(embed_dim: int, grid_hw,
                             device=None) -> torch.Tensor:
    """MAE-style 2D sincos table [H, W, embed_dim]: first half of the
    channels encodes x, second half y; each half is [sin, cos] over
    omega_k = 1 / 10000^(k / (d/4))."""
    h, w = grid_hw
    d_half = embed_dim // 2
    d_quart = d_half // 2
    omega = 1.0 / (10000.0 ** (
        torch.arange(d_quart, dtype=torch.float32, device=device) / d_quart))
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None] * omega
    xs = torch.arange(w, dtype=torch.float32, device=device)[:, None] * omega
    emb_y = torch.cat([torch.sin(ys), torch.cos(ys)], dim=-1)  # [H, d/2]
    emb_x = torch.cat([torch.sin(xs), torch.cos(xs)], dim=-1)  # [W, d/2]
    return torch.cat([emb_x[None, :, :].expand(h, w, d_half),
                      emb_y[:, None, :].expand(h, w, d_half)], dim=-1)
