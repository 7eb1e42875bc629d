"""Colour-space conversions (counterpart of `sam_pt_tpu/ops/color.py`).

`rgb_to_lab` follows skimage.color.rgb2lab (D65, 2 degree observer) with
skimage's own truncated constants, as the reference's patch-similarity
filter goes through skimage; `rgb_to_gray` uses OpenCV's RGB2GRAY weights.
Both run on the tensor's device in float32.
"""
from __future__ import annotations

import torch

# skimage.color.colorconv.xyz_from_rgb, rows X, Y, Z.
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
# D65 reference white.
_WHITE = (0.95047, 1.00000, 1.08883)
_GRAY = (0.299, 0.587, 0.114)


def _srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    return torch.where(srgb <= 0.04045, srgb / 12.92,
                       ((srgb + 0.055) / 1.055) ** 2.4)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB (uint8 0-255 or float 0-1) -> CIE-LAB float32."""
    if not rgb.is_floating_point():
        rgb = rgb.float() / 255.0
    linear = _srgb_to_linear(rgb.float())
    matrix = torch.tensor(_RGB2XYZ, dtype=torch.float32, device=rgb.device)
    xyz = torch.einsum("...c,dc->...d", linear, matrix)
    xyz = xyz / torch.tensor(_WHITE, dtype=torch.float32, device=rgb.device)
    # skimage's xyz2lab thresholds as they are: 0.008856 and 7.787.
    f = torch.where(xyz > 0.008856, xyz.clamp(min=0.0) ** (1.0 / 3.0),
                    7.787 * xyz + 16.0 / 116.0)
    fx, fy, fz = f.unbind(-1)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB -> grey with OpenCV's BT.601 weights, float32."""
    weights = torch.tensor(_GRAY, dtype=torch.float32, device=rgb.device)
    return torch.einsum("...c,c->...", rgb.float(), weights)
