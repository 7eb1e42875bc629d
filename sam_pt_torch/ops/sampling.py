"""Bilinear and neighbourhood sampling (counterpart of
`sam_pt_tpu/ops/sampling.py`).

`bilinear_sample` gathers the four integer taps around each point and
blends them, with the JAX package's `clamp` and `zeros` padding modes;
`bilinear_sample_nchw` is its clamped form on channels-first maps;
`grid_sample_nearest` takes the nearest pixel, clamped.
`separable_neighborhood_sample` samples a regular (dy, dx) grid around
centres as two small products against bilinear "hat" weight matrices,
exactly as the JAX package does (grid_sample zero padding, align_corners
grid convention).
"""
from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    *, pad_mode: str = "clamp") -> torch.Tensor:
    """Sample img [B, H, W, C] at pixel coords x, y [B, P] -> [B, P, C] f32.

    pad_mode "clamp" clamps out-of-range taps to the border; "zeros" gives
    out-of-range taps zero weight.
    """
    b, h, w, c = img.shape
    x = x.float()
    y = y.float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    if pad_mode == "zeros":
        wx0 = wx0 * ((x0 >= 0) & (x0 <= w - 1))
        wx1 = wx1 * ((x1 >= 0) & (x1 <= w - 1))
        wy0 = wy0 * ((y0 >= 0) & (y0 <= h - 1))
        wy1 = wy1 * ((y1 >= 0) & (y1 <= h - 1))
    elif pad_mode != "clamp":
        raise ValueError(f"unknown pad_mode: {pad_mode}")

    ix0 = x0.long().clamp(0, w - 1)
    ix1 = x1.long().clamp(0, w - 1)
    iy0 = y0.long().clamp(0, h - 1)
    iy1 = y1.long().clamp(0, h - 1)
    flat = img.reshape(b, h * w, c)

    def tap(iy, ix):
        idx = (iy * w + ix)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx)

    return (tap(iy0, ix0) * (wy0 * wx0)[..., None]
            + tap(iy0, ix1) * (wy0 * wx1)[..., None]
            + tap(iy1, ix0) * (wy1 * wx0)[..., None]
            + tap(iy1, ix1) * (wy1 * wx1)[..., None])


def bilinear_sample_nchw(img: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """Sample img [B, C, H, W] at pixel coords x, y [B, N] -> [B, C, N]
    f32, taps clamped to the border (the reference's `bilinear_sample2d`)."""
    b, c, h, w = img.shape
    x = x.float()
    y = y.float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    ix0 = x0.long().clamp(0, w - 1)
    ix1 = (x0.long() + 1).clamp(0, w - 1)
    iy0 = y0.long().clamp(0, h - 1)
    iy1 = (y0.long() + 1).clamp(0, h - 1)
    flat = img.float().reshape(b, c, h * w)

    def tap(iy, ix):
        return torch.gather(flat, 2, (iy * w + ix)[:, None].expand(-1, c, -1))

    return (tap(iy0, ix0) * (wy0 * wx0)[:, None]
            + tap(iy0, ix1) * (wy0 * wx1)[:, None]
            + tap(iy1, ix0) * (wy1 * wx0)[:, None]
            + tap(iy1, ix1) * (wy1 * wx1)[:, None])


def grid_sample_nearest(img: torch.Tensor, x: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample of img [H, W, C] at pixel coords x, y of
    shape [...] -> [..., C], in img's dtype: each coordinate rounded half
    to even and clamped to the image."""
    h, w = img.shape[0], img.shape[1]
    ix = torch.round(x).long().clamp(0, w - 1)
    iy = torch.round(y).long().clamp(0, h - 1)
    return img[iy, ix]


def _hat_weights(coords: torch.Tensor, size: int,
                 zero_pad: bool) -> torch.Tensor:
    """[...] fractional positions -> [..., size] weights
    max(0, 1 - |coord - j|); clamped to the range first unless zero_pad."""
    if not zero_pad:
        coords = coords.clamp(0.0, float(size - 1))
    j = torch.arange(size, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - torch.abs(coords[..., None] - j), min=0.0)


def separable_neighborhood_sample(plane: torch.Tensor, cx: torch.Tensor,
                                  cy: torch.Tensor, dy: torch.Tensor,
                                  dx: torch.Tensor, *,
                                  zero_pad: bool = True) -> torch.Tensor:
    """Bilinear samples of plane [..., H, W] at (cy + dy[p], cx + dx[q]).

    cx, cy: [...] centres in pixel coordinates; dy [Ky], dx [Kx] offsets.
    Returns [..., Ky, Kx].
    """
    h, w = plane.shape[-2], plane.shape[-1]
    wy = _hat_weights(cy[..., None] + dy, h, zero_pad)  # [..., Ky, H]
    wx = _hat_weights(cx[..., None] + dx, w, zero_pad)  # [..., Kx, W]
    tmp = torch.matmul(wy, plane)                      # [..., Ky, W]
    return torch.matmul(tmp, wx.transpose(-1, -2))     # [..., Ky, Kx]


def patch_sample(img: torch.Tensor, points_xy: torch.Tensor,
                 patch_size: int) -> torch.Tensor:
    """Square patches around pixel coordinates, bilinear, zero padding.

    img [..., H, W, C]; points_xy [..., N, 2] (x, y) with the same leading
    dims. Returns [..., N, K * K, C] with K = 2 * (patch_size // 2) + 1,
    the patch laid out (dy, dx) row-major: entry dy * K + dx samples the
    pixel coordinate (x + dx - K // 2, y + dy - K // 2), as the reference's
    grid_sample(align_corners=False) on (xy + offset + 0.5) does; taps
    outside the image read zero.
    """
    half = patch_size // 2
    k = 2 * half + 1
    lead = img.shape[:-3]
    h, w, c = img.shape[-3:]
    n = points_xy.shape[-2]
    offs = torch.arange(-half, half + 1, dtype=torch.float32,
                        device=img.device)
    pts = points_xy.reshape(-1, n, 2).float()
    xs = (pts[:, :, None, None, 0] + offs[None, None, None, :]).expand(
        -1, -1, k, k)
    ys = (pts[:, :, None, None, 1] + offs[None, None, :, None]).expand(
        -1, -1, k, k)
    out = bilinear_sample(img.reshape(-1, h, w, c).float(),
                          xs.reshape(xs.shape[0], -1),
                          ys.reshape(ys.shape[0], -1), pad_mode="zeros")
    return out.reshape(*lead, n, k * k, c)
