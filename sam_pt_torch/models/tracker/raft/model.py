"""RAFT optical flow (counterpart of
`sam_pt_tpu/models/tracker/raft/model.py`): feature and context encoders,
all-pairs correlation with a 4-level pyramid looked up at radius 4, the
SepConvGRU update block and convex upsampling of the last flow. The
configuration is raft-things.pth's (features 256, context 128 + 128,
hidden 128).

Maps are NCHW, as in the original; parameter names follow raft-things.pth
(`fnet.*`, `cnet.norm1.running_var`, `cnet.layer2.0.downsample.1.weight`,
`update_block.gru.convz1.weight`, `update_block.mask.2.bias`, ...).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.sampling import separable_neighborhood_sample
from ...batch_norm import InferenceBatchNorm
from ..pips.model import instance_norm


class InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


def _norm(kind: str, channels: int) -> nn.Module:
    return InferenceBatchNorm(channels) if kind == "batch" else InstanceNorm()


class RaftResBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class RaftEncoder(nn.Module):
    """[B, 3, H, W] -> [B, output_dim, H/8, W/8]."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3)
        self.norm1 = _norm(norm_fn, 64)
        planes = 64
        for i, (out, stride) in enumerate(((64, 1), (96, 2), (128, 2)), 1):
            setattr(self, f"layer{i}", nn.Sequential(
                RaftResBlock(planes, out, norm_fn, stride),
                RaftResBlock(out, out, norm_fn, 1)))
            planes = out
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


def all_pairs_correlation(f1: torch.Tensor, f2: torch.Tensor,
                          num_levels: int) -> List[torch.Tensor]:
    """[B, C, h, w] twice -> [corr_l [B, h*w, h_l, w_l]]: every pixel of
    f1 against every pixel of f2, scaled by 1/sqrt(C), then 2x2
    average-pooled per level, in float32."""
    b, c, h, w = f1.shape
    corr = torch.bmm(f1.float().reshape(b, c, h * w).transpose(1, 2),
                     f2.float().reshape(b, c, h * w)) / (c ** 0.5)
    pyramid = [corr.reshape(b, h * w, h, w)]
    for _ in range(num_levels - 1):
        hh, ww = pyramid[-1].shape[2:]
        pyramid.append(F.avg_pool2d(
            pyramid[-1].reshape(b * h * w, 1, hh, ww), 2, 2).reshape(
                b, h * w, hh // 2, ww // 2))
    return pyramid


def lookup_correlation(pyramid, coords: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """coords [B, h, w, 2] (x, y) feature-grid positions -> [B, L(2r+1)^2,
    h, w]: each level's (2r+1)^2 window around coords / 2^level, flattened
    x-major as the trained motion encoder expects."""
    b, h, w, _ = coords.shape
    d = torch.linspace(-radius, radius, 2 * radius + 1, device=coords.device)
    flat = coords.reshape(b, h * w, 2)
    outs = []
    for lvl, corr in enumerate(pyramid):
        centers = flat / (2.0 ** lvl)
        patch = separable_neighborhood_sample(
            corr, centers[..., 0], centers[..., 1], d, d, zero_pad=True)
        outs.append(patch.transpose(-1, -2).reshape(b, h * w, -1))
    return torch.cat(outs, dim=-1).transpose(1, 2).reshape(b, -1, h, w)


class SepConvGRU(nn.Module):
    """A ConvGRU over (1, 5) then (5, 1) kernels."""

    def __init__(self, hidden: int = 128, input_dim: int = 256):
        super().__init__()
        for axis, (k, p) in ((1, ((1, 5), (0, 2))), (2, ((5, 1), (2, 0)))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{axis}",
                        nn.Conv2d(hidden + input_dim, hidden, k, padding=p))

    def forward(self, h, x):
        for axis in (1, 2):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{axis}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{axis}")(hx))
            q = torch.tanh(getattr(self, f"convq{axis}")(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow], dim=1)


class FlowHead(nn.Module):
    def __init__(self, hidden: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(hidden, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, hidden: int = 128, corr_channels: int = 4 * 81):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channels)
        self.gru = SepConvGRU(hidden, 128 + hidden)
        self.flow_head = FlowHead(hidden)
        self.mask = nn.Sequential(nn.Conv2d(hidden, 256, 3, padding=1),
                                  nn.ReLU(), nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, 2, h, w] flow and [B, 9*64, h, w] weights -> [B, 2, 8h, 8w]:
    each fine pixel a softmax-weighted mix of its coarse 3 x 3
    neighbourhood."""
    b, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h, w), dim=2)
    patches = F.unfold(8.0 * flow, (3, 3), padding=1)
    patches = patches.reshape(b, 2, 9, 1, 1, h, w)
    up = (mask * patches).sum(dim=2)  # [B, 2, 8, 8, h, w]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, 8 * h, 8 * w)


class Raft(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 hidden: int = 128, context: int = 128):
        super().__init__()
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.hidden = hidden
        self.fnet = RaftEncoder(256, "instance")
        self.cnet = RaftEncoder(hidden + context, "batch")
        self.update_block = BasicUpdateBlock(
            hidden, corr_levels * (2 * corr_radius + 1) ** 2)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: int = 32) -> torch.Tensor:
        """Images [B, 3, H, W] in [-1, 1], H and W multiples of 8 -> the
        flow from image1 to image2, [B, 2, H, W]. The update iterations
        share their weights; only the last flow is upsampled."""
        dtype = self.fnet.conv1.weight.dtype
        image1, image2 = image1.to(dtype), image2.to(dtype)
        b, _, h, w = image1.shape
        h8, w8 = h // 8, w // 8
        pyramid = all_pairs_correlation(self.fnet(image1), self.fnet(image2),
                                        self.corr_levels)
        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :self.hidden])
        inp = F.relu(cnet[:, self.hidden:])

        gy, gx = torch.meshgrid(
            torch.arange(h8, dtype=torch.float32, device=image1.device),
            torch.arange(w8, dtype=torch.float32, device=image1.device),
            indexing="ij")
        coords0 = torch.stack([gx, gy], dim=-1)[None].expand(b, h8, w8, 2)
        coords1 = coords0
        mask = torch.zeros((b, 64 * 9, h8, w8), device=image1.device)
        for _ in range(iters):
            corr = lookup_correlation(pyramid, coords1, self.corr_radius)
            flow = (coords1 - coords0).permute(0, 3, 1, 2)
            net, mask, delta = self.update_block(
                net, inp, corr.to(dtype), flow.to(dtype))
            coords1 = coords1 + delta.float().permute(0, 2, 3, 1)
        return convex_upsample((coords1 - coords0).permute(0, 3, 1, 2),
                               mask.float())
