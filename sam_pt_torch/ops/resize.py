"""Image resizing as separable banded taps.

Counterpart of `sam_pt_tpu/ops/resize.py`. A resize along one axis is an
[out, in] weight matrix applied to that axis; bilinear and antialiased
(PIL-style triangle filter) resizes differ only in the weights. The port
builds the same float64 weights the JAX package builds, rounded to float32,
but keeps of each output row only its band of nonzero taps: two for a
bilinear upscale, about 2 x scale + 2 for an antialiased downscale. A
resize gathers the band's inputs tap by tap (`index_select`) and sums
them with their weights in float32, so it gives the JAX package's numbers
to float32 rounding without the dense products.

Conventions (all channels-last, [..., H, W, C]):
  - "half_pixel": F.interpolate(mode='bilinear', align_corners=False)
  - "align_corners": F.interpolate(..., align_corners=True)
  - antialias=True: PIL-style triangle filter
  - `resize_nearest`: F.interpolate(mode='nearest'), torch's floor
    convention, as a gather of the source rows and columns (the JAX
    package's one-hot matrices in float32 give the same numbers for
    finite values)
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _resize_weights(in_size: int, out_size: int, mode: str,
                    antialias: bool) -> np.ndarray:
    """Dense [out_size, in_size] resize weights, float32 (host-computed)."""
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


@functools.lru_cache(maxsize=256)
def _band(in_size: int, out_size: int, mode: str,
          antialias: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Each output row's band of the resize weights: (index [out, K] int64,
    weights [out, K] float32), K the widest row's span from its first to
    its last nonzero column. Narrower rows are padded with zero weights on
    clamped indices."""
    w = _resize_weights(in_size, out_size, mode, antialias)
    nonzero = w != 0
    first = nonzero.argmax(axis=1)
    last = in_size - 1 - nonzero[:, ::-1].argmax(axis=1)
    k = int((last - first).max()) + 1
    cols = first[:, None] + np.arange(k)
    inside = cols <= last[:, None]
    index = np.minimum(cols, in_size - 1)
    weights = np.where(inside, np.take_along_axis(w, index, axis=1), 0.0)
    return index.astype(np.int64), weights.astype(np.float32)


_DEVICE_BANDS: dict = {}
_DEVICE_MATRICES: dict = {}


def _device_band(in_size, out_size, mode, antialias, device):
    """`_band` tap-major ([K, out], each tap's row contiguous) as tensors
    on `device` (cached)."""
    key = (in_size, out_size, mode, antialias, str(device))
    band = _DEVICE_BANDS.get(key)
    if band is None:
        band = tuple(torch.from_numpy(np.ascontiguousarray(a.T)).to(device)
                     for a in _band(in_size, out_size, mode, antialias))
        _DEVICE_BANDS[key] = band
    return band


def _apply_dense(x: torch.Tensor, in_size, out_size, mode, antialias,
                 axis: int) -> torch.Tensor:
    """Resize float32 `x` along `axis` by the dense weight matrix, one
    float32 matrix product (cached on the device)."""
    key = (in_size, out_size, mode, antialias, str(x.device))
    w = _DEVICE_MATRICES.get(key)
    if w is None:
        w = torch.from_numpy(_resize_weights(in_size, out_size, mode,
                                             antialias)).to(x.device)
        _DEVICE_MATRICES[key] = w
    y = torch.matmul(torch.movedim(x, axis, -1), w.t())
    return torch.movedim(y, -1, axis)


def _apply_band(x: torch.Tensor, band, axis: int,
                rows: int = None) -> torch.Tensor:
    """Resize float32 `x` along `axis` with a tap-major band (index,
    weights [K, out]): each output row is the weighted sum of its band's
    inputs, accumulated tap by tap in place (a gather and a fused
    multiply-add a tap). `rows` keeps only the first output rows (the rest
    is not computed)."""
    index, weights = band
    if rows is not None:
        index, weights = index[:, :rows], weights[:, :rows]
    axis = axis % x.ndim
    shape = [1] * x.ndim
    shape[axis] = index.shape[1]
    out = x.index_select(axis, index[0]) * weights[0].view(shape)
    for k in range(1, index.shape[0]):
        out.addcmul_(x.index_select(axis, index[k]), weights[k].view(shape))
    return out


def resize_bilinear(
    x: torch.Tensor,
    out_hw,
    *,
    align_corners: bool = False,
    antialias: bool = False,
    h_axis: int = -3,
    w_axis: int = -2,
    dense: bool = False,
) -> torch.Tensor:
    """Bilinear resize of the (H, W) axes of an [..., H, W, C] tensor.

    Computed in float32; floating inputs come back in their own dtype,
    integer inputs as float32. `dense` applies the whole weight matrix by
    a matrix product instead of the band: the point trackers' resizes keep
    it, since a tracker carries a last-bit difference of its input into
    its trajectories.
    """
    in_h, in_w = x.shape[h_axis], x.shape[w_axis]
    out_h, out_w = out_hw
    mode = "align_corners" if align_corners else "half_pixel"
    dtype = x.dtype
    x = x.float()
    for axis, n_in, n_out in ((h_axis, in_h, out_h), (w_axis, in_w, out_w)):
        if n_in == n_out:
            continue
        if dense:
            x = _apply_dense(x, n_in, n_out, mode, antialias, axis)
        else:
            x = _apply_band(x, _device_band(n_in, n_out, mode, antialias,
                                            x.device), axis)
    return x.to(dtype) if dtype.is_floating_point else x


def resize_planes(x: torch.Tensor, out_hw, *,
                  crop_hw=None) -> torch.Tensor:
    """Bilinear (half-pixel) resize of the last two axes of [..., H, W] in
    float32, rows then columns; the same weights as `resize_bilinear`.
    `crop_hw` keeps only the first (rows, cols) of the result (the dropped
    part is not computed)."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    out_h, out_w = out_hw
    rows, cols = crop_hw or out_hw
    x = x.float()
    if in_h != out_h:
        x = _apply_band(x, _device_band(in_h, out_h, "half_pixel", False,
                                        x.device), -2, rows)
    elif rows != in_h:
        x = x[..., :rows, :]
    if in_w != out_w:
        x = _apply_band(x, _device_band(in_w, out_w, "half_pixel", False,
                                        x.device), -1, cols)
    elif cols != in_w:
        x = x[..., :cols]
    return x


def resize_nearest(x: torch.Tensor, out_hw, *, h_axis: int = -3,
                   w_axis: int = -2) -> torch.Tensor:
    """Nearest-neighbour resize of the (H, W) axes, torch's floor
    convention: output row i reads row floor(i * in / out), clamped. The
    dtype is kept."""
    for axis, out in ((h_axis, out_hw[0]), (w_axis, out_hw[1])):
        size = x.shape[axis]
        if size != out:
            src = np.clip(np.floor(np.arange(out) * (size / out)), 0,
                          size - 1).astype(np.int64)
            x = x.index_select(axis, torch.as_tensor(src, device=x.device))
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
