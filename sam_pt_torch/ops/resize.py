"""Image resizing as separable weight-matrix products.

Counterpart of `sam_pt_tpu/ops/resize.py`. A resize along one axis is a
dense [out, in] weight matrix applied to that axis; bilinear and
antialiased (PIL-style triangle filter) resizes differ only in the weights.
The matrices are the same numpy matrices the JAX package builds, so the
antialiased SAM preprocessing (`predictor.encode_frames`) matches it; they
are applied in float32 with `torch.matmul`.

Conventions (all channels-last, [..., H, W, C]):
  - "half_pixel": F.interpolate(mode='bilinear', align_corners=False)
  - "align_corners": F.interpolate(..., align_corners=True)
  - antialias=True: PIL-style triangle filter
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, mode: str,
                   antialias: bool) -> np.ndarray:
    """Dense [out_size, in_size] resize weight matrix (host-computed)."""
    j = np.arange(in_size, dtype=np.float64)
    if mode == "align_corners":
        if out_size == 1:
            centers = np.zeros((1,))
        else:
            centers = np.arange(out_size) * (in_size - 1) / (out_size - 1)
        support = 1.0
    elif mode == "half_pixel":
        scale = in_size / out_size
        centers = (np.arange(out_size) + 0.5) * scale - 0.5
        support = max(scale, 1.0) if antialias else 1.0
    else:
        raise ValueError(f"unknown resize mode: {mode}")
    dist = np.abs(j[None, :] - centers[:, None]) / support
    w = np.maximum(0.0, 1.0 - dist)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


_DEVICE_MATRICES: dict = {}


def _matrix(in_size, out_size, mode, antialias, device) -> torch.Tensor:
    """The resize matrix as a float32 tensor on `device` (cached)."""
    key = (in_size, out_size, mode, antialias, str(device))
    m = _DEVICE_MATRICES.get(key)
    if m is None:
        m = torch.from_numpy(
            _resize_matrix(in_size, out_size, mode, antialias)).to(device)
        _DEVICE_MATRICES[key] = m
    return m


def _apply_axis(x: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    x = torch.movedim(x, axis, -1)
    y = torch.matmul(x, w.t())
    return torch.movedim(y, -1, axis)


def resize_bilinear(
    x: torch.Tensor,
    out_hw,
    *,
    align_corners: bool = False,
    antialias: bool = False,
    h_axis: int = -3,
    w_axis: int = -2,
) -> torch.Tensor:
    """Bilinear resize of the (H, W) axes of an [..., H, W, C] tensor.

    Computed in float32; floating inputs come back in their own dtype,
    integer inputs as float32.
    """
    in_h, in_w = x.shape[h_axis], x.shape[w_axis]
    out_h, out_w = out_hw
    mode = "align_corners" if align_corners else "half_pixel"
    dtype = x.dtype
    x = x.float()
    if in_h != out_h:
        x = _apply_axis(
            x, _matrix(in_h, out_h, mode, antialias, x.device), h_axis)
    if in_w != out_w:
        x = _apply_axis(
            x, _matrix(in_w, out_w, mode, antialias, x.device), w_axis)
    return x.to(dtype) if dtype.is_floating_point else x


def resize_planes(x: torch.Tensor, out_hw, *,
                  crop_hw=None) -> torch.Tensor:
    """Bilinear (half-pixel) resize of the last two axes of [..., H, W] in
    float32 as two matrix products, Wh @ x @ Ww^T; the same weights as
    `resize_bilinear`. `crop_hw` keeps only the first (rows, cols) of the
    result (the matrices are cropped, so the dropped part is not computed)."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    out_h, out_w = out_hw
    rows, cols = crop_hw or out_hw
    x = x.float()
    if in_h != out_h:
        x = torch.matmul(
            _matrix(in_h, out_h, "half_pixel", False, x.device)[:rows], x)
    elif rows != in_h:
        x = x[..., :rows, :]
    if in_w != out_w:
        x = torch.matmul(
            x, _matrix(in_w, out_w, "half_pixel", False, x.device)[:cols].t())
    elif cols != in_w:
        x = x[..., :cols]
    return x


def get_longest_side_target_hw(h: int, w: int, long_side: int):
    """Target (h, w) after scaling so the longest side equals `long_side`
    (SAM's ResizeLongestSide.get_preprocess_shape: round half up)."""
    scale = long_side / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def resize_longest_side(image: torch.Tensor, long_side: int, *,
                        antialias: bool = True) -> torch.Tensor:
    """Resize [H, W, C] so the longest side equals `long_side`."""
    h, w = image.shape[0], image.shape[1]
    target = get_longest_side_target_hw(h, w, long_side)
    return resize_bilinear(image.float(), target, antialias=antialias)
