"""The PIPS-family pieces CoTracker shares (counterpart of part of
`sam_pt_tpu/models/tracker/pips/model.py`): the BasicEncoder CNN, instance
norm, and the correlation pyramid with its neighbourhood sampling.

Feature maps are channels-last [T, H, W, C], as in the JAX package;
convolutions run in NCHW inside. Parameter names follow the public
checkpoints (`fnet.conv1.weight`, `fnet.layer1.0.conv1.weight`,
`fnet.layer2.0.downsample.0.weight`, ...).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.resize import resize_bilinear
from ....ops.sampling import separable_neighborhood_sample


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) of an NCHW map, statistics in f32."""
    xf = x.float()
    mu = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.downsample = (nn.Sequential(nn.Conv2d(in_planes, planes, 1,
                                                   stride))
                           if stride != 1 else None)

    def forward(self, x):
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Frames [T, H, W, 3] in [-1, 1] -> features [T, H/s, W/s, C]: four
    residual stages at strides 2/4/8/16, each resized (align_corners) to
    H/s and fused."""

    def __init__(self, output_dim: int = 128, stride: int = 8):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3)
        dims = [(64, 64, 1), (64, 96, 2), (96, 128, 2), (128, 128, 2)]
        for i, (cin, cout, s) in enumerate(dims, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                ResidualBlock(cin, cout, s), ResidualBlock(cout, cout, 1)))
        self.conv2 = nn.Conv2d(64 + 96 + 128 + 128, output_dim * 2, 3,
                               padding=1)
        self.conv3 = nn.Conv2d(output_dim * 2, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        target = (h // self.stride, w // self.stride)
        x = x.permute(0, 3, 1, 2).to(self.conv1.weight.dtype)
        x = F.relu(instance_norm(self.conv1(x)))
        a = self.layer1(x)
        b = self.layer2(a)
        c = self.layer3(b)
        d = self.layer4(c)
        feats = [resize_bilinear(t, target, align_corners=True, h_axis=-2,
                                 w_axis=-1) for t in (a, b, c, d)]
        x = F.relu(instance_norm(self.conv2(torch.cat(feats, dim=1))))
        return self.conv3(x).permute(0, 2, 3, 1)


def correlation_pyramid(fmaps: torch.Tensor, targets: torch.Tensor,
                        num_levels: int) -> List[torch.Tensor]:
    """fmaps [S, H, W, C], targets [S, N, C] -> [corr_l [S, N, H_l, W_l]]
    over 2x2 average-pooled levels, scaled by 1/sqrt(C), in f32."""
    c = fmaps.shape[-1]
    out = []
    fm = fmaps.permute(0, 3, 1, 2)  # [S, C, H, W]
    t = targets.float()
    for lvl in range(num_levels):
        s, _, hl, wl = fm.shape
        corr = torch.bmm(t, fm.float().reshape(s, c, hl * wl))
        out.append(corr.reshape(s, -1, hl, wl) / (c ** 0.5))
        if lvl < num_levels - 1:
            fm = F.avg_pool2d(fm, 2, 2)
    return out


def sample_corr_pyramid(pyramid: List[torch.Tensor], coords: torch.Tensor,
                        radius: int) -> torch.Tensor:
    """(2r+1)^2 taps from each level around coords / 2^level.

    pyramid[l] [S, N, H_l, W_l]; coords [S, N, 2] -> [S, N, L*(2r+1)^2],
    each window flattened x-major as the trained weights expect.
    """
    d = torch.linspace(-radius, radius, 2 * radius + 1,
                       device=coords.device)
    outs = []
    for lvl, corr in enumerate(pyramid):
        centers = coords / (2.0 ** lvl)
        patch = separable_neighborhood_sample(
            corr, centers[..., 0], centers[..., 1], d, d, zero_pad=True)
        patch = patch.transpose(-1, -2)
        outs.append(patch.reshape(*patch.shape[:2], -1))
    return torch.cat(outs, dim=-1)
