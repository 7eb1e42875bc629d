"""Basic tensor utilities (counterpart of `sam_pt_tpu/ops/basic.py`):
meshgrids, masked reductions, 2-D argmax, separable gaussian blur, on the
tensors' device."""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch


def meshgrid2d(h: int, w: int, stack_dim: int = -1,
               device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """(y, x) meshgrid as float32 [h, w, 2] (stacked on `stack_dim`)."""
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([gy, gx], dim=stack_dim)


def reduce_masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None,
                       keepdim: bool = False, eps: float = 1e-10
                       ) -> torch.Tensor:
    """Mean of x over the elements where mask > 0 (mask as weights)."""
    prod = x * mask
    if dim is None:
        return prod.sum() / (eps + mask.sum())
    return (prod.sum(dim=dim, keepdim=keepdim)
            / (eps + mask.sum(dim=dim, keepdim=keepdim)))


def reduce_masked_median(x: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Median of each row over its elements where mask > 0, 0 for a row
    with none (on the host, numpy's median: the mean of the two middle
    values)."""
    out = np.zeros(x.shape[0], x.dtype)
    for i in range(x.shape[0]):
        vals = x[i][mask[i] > 0]
        out[i] = np.median(vals) if len(vals) else 0.0
    return out


def argmax2d(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, x) float32 of the maximum of each [..., H, W] map (the first
    in row-major order on ties)."""
    h, w = x.shape[-2:]
    idx = x.reshape(*x.shape[:-2], h * w).argmax(dim=-1)
    return (idx // w).float(), (idx % w).float()


def gaussian_kernel_1d(size: int, sigma: float,
                       device: Union[str, torch.device] = "cuda"
                       ) -> torch.Tensor:
    ax = torch.arange(size, dtype=torch.float32, device=device) - (
        size - 1) / 2.0
    k = torch.exp(-0.5 * (ax / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(x: torch.Tensor, kernel_size: int,
                  sigma: float) -> torch.Tensor:
    """Separable gaussian blur of [..., H, W, C], edges replicated."""
    k = gaussian_kernel_1d(kernel_size, sigma, device=x.device)
    pad = kernel_size // 2

    def conv_axis(v, axis):
        v = v.movedim(axis, -1)
        n = v.shape[-1]
        idx = torch.arange(-pad, n + pad, device=v.device).clamp(0, n - 1)
        vp = v[..., idx]
        out = torch.zeros_like(v)
        for i in range(kernel_size):
            out = out + k[i] * vp[..., i:i + n]
        return out.movedim(-1, axis)

    return conv_axis(conv_axis(x, -3), -2)
