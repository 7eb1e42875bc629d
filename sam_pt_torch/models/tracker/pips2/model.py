"""PIPS++ window model (counterpart of
`sam_pt_tpu/models/tracker/pips2/model.py`): the PIPS BasicEncoder (stride
8), a 1-D convolutional residual delta block over the window's frames, and
multi-delay correlation: the query features and the features sampled at
the trajectory 2 and 4 frames earlier, each against every frame, at 4
pyramid levels of radius 3.

Parameter names follow the public PIPS++ checkpoint
(`delta_block.first_block_conv.conv.weight`,
`delta_block.basicblock_list.{i}.conv1.conv.weight`,
`delta_block.dense.weight`, `fnet.*`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.posemb import posemb_sincos_2d_xy
from ....ops.sampling import bilinear_sample
from ..pips.model import BasicEncoder, correlation_pyramid, sample_corr_pyramid


def instance_norm_1d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm1d(affine=False) of [B, C, S]: each channel over S."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


class Conv1dSame(nn.Module):
    """A stride-1 Conv1d padded to keep the length (`.conv`, as the
    original's MyConv1dPadSame)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              padding=(kernel_size - 1) // 2)

    def forward(self, x):
        return self.conv(x)


class ResidualBlock1d(nn.Module):
    """[B, C_in, S] -> [B, C_out, S]: (norm, relu,) conv, norm, relu, conv,
    plus the input zero-padded on both sides of the channel axis."""

    def __init__(self, in_channels: int, out_channels: int,
                 is_first_block: bool = False, kernel_size: int = 3):
        super().__init__()
        self.is_first_block = is_first_block
        self.conv1 = Conv1dSame(in_channels, out_channels, kernel_size)
        self.conv2 = Conv1dSame(out_channels, out_channels, kernel_size)

    def forward(self, x):
        out = x if self.is_first_block else F.relu(instance_norm_1d(x))
        out = self.conv2(F.relu(instance_norm_1d(self.conv1(out))))
        extra = out.shape[1] - x.shape[1]
        if extra:
            x = F.pad(x, (0, 0, extra // 2, extra - extra // 2))
        return out + x


class DeltaBlock1d(nn.Module):
    """Per-point [B, S, 3 L(2r+1)^2] correlations and [B, S, 2] flows ->
    [B, S, 2] coordinate deltas. The filters double every
    `increasefilter_gap` blocks from `base_filters`."""

    def __init__(self, latent_dim: int = 128, base_filters: int = 128,
                 n_block: int = 8, increasefilter_gap: int = 2,
                 corr_levels: int = 4, corr_radius: int = 3):
        super().__init__()
        self.latent_dim = latent_dim
        in_dim = 3 * corr_levels * (2 * corr_radius + 1) ** 2 + latent_dim + 2
        self.first_block_conv = Conv1dSame(in_dim, base_filters)
        blocks, channels = [], base_filters
        for i in range(n_block):
            out = base_filters
            if i:
                out = base_filters * 2 ** ((i - 1) // increasefilter_gap)
                out *= 2 if i % increasefilter_gap == 0 else 1
            blocks.append(ResidualBlock1d(channels, out, i == 0))
            channels = out
        self.basicblock_list = nn.ModuleList(blocks)
        self.dense = nn.Linear(channels, 2)

    def forward(self, fcorr, flow):
        emb = posemb_sincos_2d_xy(flow, self.latent_dim, cat_coords=True)
        x = torch.cat([fcorr, emb], dim=-1).transpose(1, 2)
        x = F.relu(self.first_block_conv(x.to(self.dense.weight.dtype)))
        for block in self.basicblock_list:
            x = block(x)
        return self.dense(F.relu(x).transpose(1, 2)).float()


class PipsPlusPlus(nn.Module):
    """Window model over precomputed feature maps.

    forward(fmaps [S, H/8, W/8, C], coords_init [S, N, 2] pixels,
            feat_init (feats1, feats2, feats4) each [S, N, C] or None)
      -> (coords [S, N, 2] pixels, (feats1, feats2, feats4)).

    Iterations share their weights. The first keeps the given (or query)
    features 2 and 4 frames back; later ones sample them at the current
    trajectory. Frame 0 stays locked to the query.
    """

    def __init__(self, stride: int = 8, latent_dim: int = 128,
                 corr_levels: int = 4, corr_radius: int = 3):
        super().__init__()
        self.stride = stride
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.fnet = BasicEncoder(output_dim=latent_dim, stride=stride)
        self.delta_block = DeltaBlock1d(latent_dim, corr_levels=corr_levels,
                                        corr_radius=corr_radius)

    def encode_frames(self, rgbs: torch.Tensor) -> torch.Tensor:
        """[T, H, W, 3] 0-255 -> [T, H/stride, W/stride, C]."""
        return self.fnet(2.0 * (rgbs.float() / 255.0) - 1.0)

    def forward(self, fmaps: torch.Tensor, coords_init: torch.Tensor,
                feat_init: Optional[Tuple[torch.Tensor, ...]] = None,
                iters: int = 16):
        s, _, _, c = fmaps.shape
        n = coords_init.shape[1]
        fmaps = fmaps.float()
        coords = coords_init.float() / float(self.stride)
        coords0 = coords[0]
        if feat_init is None:
            feat1 = bilinear_sample(fmaps[:1], coords0[None, :, 0],
                                    coords0[None, :, 1])[0]
            feats1 = feats2 = feats4 = feat1[None].expand(s, n, c)
        else:
            feats1, feats2, feats4 = feat_init

        frame = torch.arange(s, device=fmaps.device)

        def delayed_feats(delay):
            idx = (frame - delay).clamp(min=0)
            at = coords[idx]
            return bilinear_sample(fmaps[idx], at[..., 0], at[..., 1])

        pyr1 = correlation_pyramid(fmaps, feats1, self.corr_levels)
        for it in range(iters):
            if it:
                feats2, feats4 = delayed_feats(2), delayed_feats(4)
            fcorr = torch.cat([
                sample_corr_pyramid(pyr, coords, self.corr_radius)
                for pyr in (pyr1,
                            correlation_pyramid(fmaps, feats2,
                                                self.corr_levels),
                            correlation_pyramid(fmaps, feats4,
                                                self.corr_levels))], dim=-1)
            flows = coords[1:] - coords[:-1]
            flows = torch.cat([flows, flows[-1:]])
            delta = self.delta_block(fcorr.transpose(0, 1),
                                     flows.transpose(0, 1))
            coords = coords + delta.transpose(0, 1)
            coords = torch.cat([coords0[None], coords[1:]])
        return coords * float(self.stride), (feats1, feats2, feats4)
