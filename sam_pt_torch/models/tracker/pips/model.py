"""PIPS (counterpart of `sam_pt_tpu/models/tracker/pips/model.py`): the
BasicEncoder CNN, instance norm and the correlation pyramid with its
neighbourhood sampling, which CoTracker and PIPS++ share, and the PIPS
window model (MLP-Mixer delta block, feature updater, visibility head).

Feature maps are channels-last [T, H, W, C], as in the JAX package;
convolutions run in NCHW inside. Parameter names follow the public
checkpoints (`fnet.conv1.weight`, `fnet.layer1.0.conv1.weight`,
`fnet.layer2.0.downsample.0.weight`, `delta_block.to_delta.1.0.fn.0.weight`,
`norm.weight`, `vis_predictor.0.bias`, ...).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.posemb import get_3d_sincos_embedding
from ....ops.resize import resize_bilinear
from ....ops.sampling import bilinear_sample, separable_neighborhood_sample


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
                                 w_axis=-1, dense=True) for t in (a, b, c, d)]
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


# The mixer's LayerNorms take flax's default epsilon, as the JAX package's
# do (the original PIPS uses torch's 1e-5).
MIXER_LN_EPS = 1e-6


class PreNormResidual(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = nn.LayerNorm(dim, eps=MIXER_LN_EPS)

    def forward(self, x):
        return self.fn(self.norm(x)) + x


def feed_forward(dim: int, expansion: int, dense) -> nn.Sequential:
    """dense -> exact GELU -> dense, at the public indices 0 and 3 (the
    original's dropouts, identities at inference, hold 2 and 4)."""
    return nn.Sequential(dense(dim, dim * expansion), nn.GELU(), nn.Identity(),
                         dense(dim * expansion, dim), nn.Identity())


class MixerBlock(nn.Sequential):
    """Token mixing over the window's S frames (a kernel-1 Conv1d with S
    input channels, as in the original), then channel mixing over C; each
    pre-normed and residual. [B, S, C] -> [B, S, C]."""

    def __init__(self, seq_len: int, dim: int, expansion: int = 4):
        super().__init__(
            PreNormResidual(dim, feed_forward(
                seq_len, expansion, lambda i, o: nn.Conv1d(i, o, 1))),
            PreNormResidual(dim, feed_forward(dim, expansion, nn.Linear)))


class MeanOverFrames(nn.Module):
    def forward(self, x):
        return x.mean(dim=1)


class DeltaBlock(nn.Module):
    """Per-point window state [B, S, latent + L(2r+1)^2 + 64*3+3] ->
    (coordinate, feature) deltas [B, S, 2 + latent], through
    `to_delta`: input projection, `depth` mixer blocks, LayerNorm, the mean
    over frames and the output projection."""

    def __init__(self, latent_dim: int = 128, hidden_dim: int = 512,
                 depth: int = 12, s: int = 8, corr_levels: int = 4,
                 corr_radius: int = 3):
        super().__init__()
        self.s = s
        self.latent_dim = latent_dim
        in_dim = latent_dim + corr_levels * (2 * corr_radius + 1) ** 2 + 195
        self.to_delta = nn.Sequential(
            nn.Linear(in_dim, hidden_dim),
            *[MixerBlock(s, hidden_dim) for _ in range(depth)],
            nn.LayerNorm(hidden_dim, eps=MIXER_LN_EPS),
            MeanOverFrames(),
            nn.Linear(hidden_dim, s * (latent_dim + 2)))

    def forward(self, fhid, fcorr, flow):
        flow_emb = get_3d_sincos_embedding(flow, 64, cat_coords=True)
        x = torch.cat([fhid, fcorr, flow_emb], dim=-1)
        x = self.to_delta(x.to(self.to_delta[0].weight.dtype))
        return x.reshape(x.shape[0], self.s, self.latent_dim + 2)


class Pips(nn.Module):
    """PIPS window model over precomputed feature maps.

    forward(fmaps [S, H/s, W/s, C], xys [N, 2] pixels at the window's frame
    0, feat_init [N, C] or None) -> (coords [S, N, 2] pixels, visibility
    logits [S, N], the query features [N, C]).

    Each of `iters` weight-shared iterations builds the correlation pyramid
    of the current per-frame point features, samples it around the current
    coordinates and lets the mixer move coordinates and features; frame 0
    stays locked to the query.
    """

    def __init__(self, s: int = 8, stride: int = 8, latent_dim: int = 128,
                 hidden_dim: int = 512, corr_levels: int = 4,
                 corr_radius: int = 3, mixer_depth: int = 12):
        super().__init__()
        self.s = s
        self.stride = stride
        self.latent_dim = latent_dim
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.fnet = BasicEncoder(output_dim=latent_dim, stride=stride)
        self.delta_block = DeltaBlock(latent_dim, hidden_dim, mixer_depth, s,
                                      corr_levels, corr_radius)
        # GroupNorm(1, C) over [rows, C]: a LayerNorm over C, eps 1e-5.
        self.norm = nn.GroupNorm(1, latent_dim)
        self.ffeat_updater = nn.Sequential(nn.Linear(latent_dim, latent_dim),
                                           nn.GELU())
        self.vis_predictor = nn.Sequential(nn.Linear(latent_dim, 1))

    @property
    def dtype(self) -> torch.dtype:
        return self.norm.weight.dtype

    def encode_frames(self, rgbs: torch.Tensor) -> torch.Tensor:
        """[T, H, W, 3] 0-255 -> [T, H/stride, W/stride, C]."""
        return self.fnet(2.0 * (rgbs.float() / 255.0) - 1.0)

    def forward(self, fmaps: torch.Tensor, xys: torch.Tensor,
                feat_init: Optional[torch.Tensor] = None, iters: int = 6
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        s, _, _, c = fmaps.shape
        n = xys.shape[0]
        if s != self.s:
            raise ValueError(f"window of {s} frames, the model takes {self.s}")
        coords0 = xys.float() / float(self.stride)
        coords = coords0[None].expand(s, n, 2)
        if feat_init is None:
            feat_init = bilinear_sample(fmaps[:1], coords0[None, :, 0],
                                        coords0[None, :, 1])[0]
        feat_init = feat_init.float()
        ffeats = feat_init[None].expand(s, n, c)
        # Channels-first once: correlation_pyramid's permute of this view is
        # contiguous, so no iteration copies the maps.
        fmaps = fmaps.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        times = torch.linspace(0.0, float(s), s, device=fmaps.device)
        times = times[None, :, None].expand(n, s, 1)
        for _ in range(iters):
            pyramid = correlation_pyramid(fmaps, ffeats, self.corr_levels)
            fcorrs = sample_corr_pyramid(pyramid, coords, self.corr_radius)
            flows = torch.cat([(coords - coords[:1]).transpose(0, 1), times],
                              dim=-1)
            delta = self.delta_block(ffeats.transpose(0, 1),
                                     fcorrs.transpose(0, 1), flows)
            upd = self.ffeat_updater(self.norm(delta[..., 2:].reshape(-1, c)))
            ffeats = upd.float().reshape(n, s, c).transpose(0, 1) + ffeats
            coords = coords + delta[..., :2].float().transpose(0, 1)
            coords = torch.cat([coords0[None], coords[1:]])
        vis_logits = self.vis_predictor(ffeats.to(self.dtype))[..., 0]
        return coords * float(self.stride), vis_logits.float(), feat_init
