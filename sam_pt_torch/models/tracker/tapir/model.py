"""TAPIR (counterpart of `sam_pt_tpu/models/tracker/tapir/model.py`).

- A ResNet-v2 backbone (affine instance norm, basic blocks, strides
  1/2/2/1, channels 64/128/256/256, a projection shortcut first in each
  group, no max-pool): 'hires' features are group 1's output (/4, 128
  channels), 'lowres' group 3's (/8, 256), both L2-normalised.
- Initial tracks from a cost volume: the query's lowres feature against
  every frame, a conv regression head, a spatial softmax at temperature
  20 and a soft-argmax truncated to radius 5 around the argmax; an
  occlusion / expected-distance head on the same hidden maps.
- 4 PIPs-style refinement passes: 7 x 7 correlation patches around the
  current track on [hires, lowres] (and, with `pyramid_level` 1, the
  2 x 2-pooled lowres), with the running state, through a depthwise-conv
  MLP-mixer (hidden 512, 12 blocks, kernel 3 over time).

With `use_causal_conv` the mixer's time convs pad on the left only and
`online_step` carries each block's conv context from chunk to chunk.

Time-sharded (`time_shard`, `parallel/temporal.py`; the offline model
only): the video is this rank's block of frames; the mixer's time convs
pad with the neighbours' frames (`ring_halo`) over the padding-zeroed
frames, query features come from the rank that owns the query frame (a
masked `psum`) and query frames are pinned by global frame id.

Layouts are the JAX package's: videos [T, H, W, 3] in [-1, 1], feature
grids [T, h, w, C], tracks [N, T, 2] (x, y) in 256-raster units, query
points [N, 3] (t, y, x). Convolutions run NCHW inside. Parameter names are
the JAX package's module names (`resnet.group1_block0.norm_0.scale`,
`pips_mixer.block_3.dw1.weight`, `cost_volume_occlusion_1.bias`, ...);
`utils/checkpoint.py::load_tapir_checkpoint` reads the public haiku files.
flax's "SAME" padding is TF-style (the smaller half first at stride 2), so
every conv pads explicitly (`same_pad`).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.sampling import bilinear_sample, separable_neighborhood_sample
from ....parallel.comm import psum, ring_halo

TRAIN_SIZE = (256, 256)  # (height, width)


def same_pad(x: torch.Tensor, kernel: int, stride: int = 1,
             value: float = 0.0) -> torch.Tensor:
    """Pad the last two axes of `x` as TF / flax "SAME" does: a total of
    max((ceil(n / s) - 1) * s + k - n, 0), the smaller half first."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


class SameConv2d(nn.Conv2d):
    """Conv2d with flax's "SAME" padding."""

    def forward(self, x):
        return super().forward(same_pad(x, self.kernel_size[0],
                                        self.stride[0]))


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp((x * x).sum(dim, keepdim=True),
                                       min=eps))


def affine_instance_norm(x: torch.Tensor, scale: torch.Tensor,
                         offset: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over the spatial axes of NCHW `x` (population
    variance), then per-channel scale and offset."""
    mu = x.mean((-2, -1), keepdim=True)
    var = x.var((-2, -1), keepdim=True, correction=0)
    return ((x - mu) * torch.rsqrt(var + eps) * scale[:, None, None]
            + offset[:, None, None])


class InstanceNormAffine(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.offset = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return affine_instance_norm(x, self.scale, self.offset)


class BlockV2(nn.Module):
    """Pre-activation basic residual block (haiku's BlockV2, no
    bottleneck); the projection shortcut reads the pre-activation."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 use_projection: bool = True):
        super().__init__()
        self.norm_0 = InstanceNormAffine(in_channels)
        self.shortcut_conv = (nn.Conv2d(in_channels, channels, 1, stride,
                                        bias=False)
                              if use_projection else None)
        self.conv_0 = SameConv2d(in_channels, channels, 3, stride,
                                 bias=False)
        self.norm_1 = InstanceNormAffine(channels)
        self.conv_1 = SameConv2d(channels, channels, 3, bias=False)

    def forward(self, x):
        y = F.relu(self.norm_0(x))
        shortcut = x if self.shortcut_conv is None else self.shortcut_conv(y)
        y = F.relu(self.norm_1(self.conv_0(y)))
        return self.conv_1(y) + shortcut


class TapirResNet(nn.Module):
    """[T, 3, H, W] -> {'resnet_unit_g': group g's output, NCHW}."""

    def __init__(self, channels: Sequence[int] = (64, 128, 256, 256),
                 blocks: Sequence[int] = (2, 2, 2, 2),
                 strides: Sequence[int] = (1, 2, 2, 1)):
        super().__init__()
        self.initial_conv = SameConv2d(3, 64, 7, 2, bias=False)
        self.layout = []
        in_ch = 64
        for gi, (ch, nb, st) in enumerate(zip(channels, blocks, strides)):
            names = []
            for bi in range(nb):
                name = f"group{gi}_block{bi}"
                self.add_module(name, BlockV2(in_ch, ch, st if bi == 0 else 1,
                                              use_projection=bi == 0))
                names.append(name)
                in_ch = ch
            self.layout.append(names)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = self.initial_conv(x)
        out = {}
        for gi, names in enumerate(self.layout):
            for name in names:
                x = getattr(self, name)(x)
            out[f"resnet_unit_{gi}"] = x
        return out


class PIPsConvBlock(nn.Module):
    """Depthwise time convs (channel multiplier 4, the four copies summed)
    and a channel MLP, each pre-normed and residual, over x [N, F, C].

    Causal mode (`use_causal_conv`): both time convs pad on the left only,
    and `causal_context` (the last kernel - 1 inputs of each conv from the
    previous chunk) is prepended, so chunks fed one after another give the
    outputs of one causal pass."""

    def __init__(self, channels: int, kernel_shape: int = 3,
                 use_causal_conv: bool = False):
        super().__init__()
        c, k = channels, kernel_shape
        self.kernel_shape = k
        self.use_causal_conv = use_causal_conv
        self.norm1 = nn.LayerNorm(c, eps=1e-6, bias=False)
        self.dw1 = nn.Conv1d(c, 4 * c, k, groups=c)
        self.dw2 = nn.Conv1d(4 * c, 4 * c, k, groups=4 * c)
        self.norm2 = nn.LayerNorm(c, eps=1e-6, bias=False)
        self.mlp2_up = nn.Linear(c, 4 * c)
        self.mlp2_down = nn.Linear(4 * c, c)

    def _time_conv(self, conv: nn.Conv1d, y: torch.Tensor, time_shard=None,
                   frame_valid: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        k = self.kernel_shape
        if time_shard is not None:
            # The zero "SAME" padding of the whole video: the padding
            # frames zeroed, then the neighbours' edge frames (zeros at
            # the video's ends) around this rank's block.
            halo = (k - 1) // 2
            y = y * frame_valid[:, None].to(y.dtype)
            left, right = ring_halo(y[..., :halo, :], y[..., -halo:, :],
                                    time_shard.group)
            y = torch.cat([left, y, right], dim=-2)
            return conv(y.transpose(-1, -2)).transpose(-1, -2)
        pad = (k - 1, 0) if self.use_causal_conv else ((k - 1) // 2, k // 2)
        return conv(F.pad(y.transpose(-1, -2), pad)).transpose(-1, -2)

    def forward(self, x, causal_context: Optional[Dict] = None,
                get_causal_context: bool = False, time_shard=None,
                frame_valid: Optional[torch.Tensor] = None):
        k = self.kernel_shape
        new_ctx = {}
        skip = x
        y = self.norm1(x)
        if causal_context is not None:
            y = torch.cat([causal_context["causal_1"], y], dim=-2)
            extra = causal_context["causal_1"].shape[-2]
        if get_causal_context:
            new_ctx["causal_1"] = y[..., -(k - 1):, :]
        y = F.gelu(self._time_conv(self.dw1, y, time_shard, frame_valid),
                   approximate="tanh")
        if causal_context is not None:
            y = torch.cat([causal_context["causal_2"], y[..., extra:, :]],
                          dim=-2)
            extra = causal_context["causal_2"].shape[-2]
        if get_causal_context:
            new_ctx["causal_2"] = y[..., -(k - 1):, :]
        y = self._time_conv(self.dw2, y, time_shard, frame_valid)
        if causal_context is not None:
            y = y[..., extra:, :]
        y = y[..., 0::4] + y[..., 1::4] + y[..., 2::4] + y[..., 3::4]
        x = skip + y
        y = self.mlp2_down(F.gelu(self.mlp2_up(self.norm2(x)),
                                  approximate="tanh"))
        return x + y, new_ctx


class PIPSMLPMixer(nn.Module):
    def __init__(self, input_channels: int, output_channels: int,
                 hidden_dim: int = 512, num_blocks: int = 12,
                 kernel_shape: int = 3, use_causal_conv: bool = False):
        super().__init__()
        self.num_blocks = num_blocks
        self.input_proj = nn.Linear(input_channels, hidden_dim)
        for i in range(num_blocks):
            self.add_module(f"block_{i}", PIPsConvBlock(
                hidden_dim, kernel_shape, use_causal_conv))
        self.out_norm = nn.LayerNorm(hidden_dim, eps=1e-6, bias=False)
        self.out_proj = nn.Linear(hidden_dim, output_channels)

    def forward(self, x, causal_context: Optional[List[Dict]] = None,
                get_causal_context: bool = False, time_shard=None,
                frame_valid: Optional[torch.Tensor] = None):
        """x [N, F, C_in] -> [N, F, C_out]; with causal context (given or
        asked for), also the list of each block's new context."""
        x = self.input_proj(x)
        all_ctx = []
        for i in range(self.num_blocks):
            ctx = causal_context[i] if causal_context is not None else None
            x, new_ctx = getattr(self, f"block_{i}")(
                x, ctx, get_causal_context, time_shard, frame_valid)
            all_ctx.append(new_ctx)
        out = self.out_proj(self.out_norm(x))
        if get_causal_context or causal_context is not None:
            return out, all_ctx
        return out


def convert_coords(coords: torch.Tensor, src_wh, dst_wh) -> torch.Tensor:
    """(x, y) coordinates scaled by the size ratio per axis (no half-pixel
    shift, as the reference's `convert_grid_coordinates` computes)."""
    ratio = torch.tensor([dst_wh[0] / src_wh[0], dst_wh[1] / src_wh[1]],
                         dtype=torch.float32, device=coords.device)
    return coords * ratio


def soft_argmax_heatmap(heatmap: torch.Tensor,
                        threshold: float = 5.0) -> torch.Tensor:
    """Truncated soft-argmax of probabilities [..., H, W] -> [..., 2] (x,
    y) in cell-centre grid units (index + 0.5): the mean position of the
    cells within `threshold` of the argmax (its first maximum), weighted by
    their probabilities."""
    h, w = heatmap.shape[-2:]
    dev = heatmap.device
    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    am = heatmap.flatten(-2).argmax(-1)
    ay = (am // w).float()[..., None, None] + 0.5
    ax = (am % w).float()[..., None, None] + 0.5
    valid = ((gy - ay) ** 2 + (gx - ax) ** 2 < threshold ** 2).float()
    weights = heatmap * valid
    denom = torch.clamp(weights.sum((-2, -1)), min=1e-12)
    x = (gx * weights).sum((-2, -1)) / denom
    y = (gy * weights).sum((-2, -1)) / denom
    return torch.stack([x, y], dim=-1)


def sample_query_features(grid: torch.Tensor, query_points: torch.Tensor,
                          time_shard=None) -> torch.Tensor:
    """grid [T, h, w, C]; query_points [N, 3] (t, y, x) in 256-raster
    units -> [N, C]: bilinear at the query frame (rounded to the nearest,
    half to even), the raster scaled to the grid then shifted by -0.5 to
    cell centres, taps clamped to the border. Time-sharded, `grid` holds
    this rank's frames: each query is sampled on the rank that owns its
    frame, zero elsewhere, and summed over the ranks."""
    gh, gw = grid.shape[1], grid.shape[2]
    t_idx = torch.round(query_points[:, 0]).long()
    if time_shard is not None:
        t_idx = t_idx - time_shard.index * time_shard.t_local
        owned = (t_idx >= 0) & (t_idx < grid.shape[0])
        t_idx = t_idx.clamp(0, grid.shape[0] - 1)
    y = query_points[:, 1] * (gh / TRAIN_SIZE[0]) - 0.5
    x = query_points[:, 2] * (gw / TRAIN_SIZE[1]) - 0.5
    q = bilinear_sample(grid[t_idx], x[:, None], y[:, None],
                        pad_mode="clamp")[:, 0]
    if time_shard is not None:
        q = psum(q * owned[:, None].to(q.dtype), time_shard.group)
    return q


def pin_query_frames(points: torch.Tensor, query_points: torch.Tensor,
                     frame_ids: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """points [N, T, 2] with each query's own frame set to its (x, y);
    `frame_ids` [T]: the frames' global ids (0..T-1 by default)."""
    t = points.shape[1]
    q_t = torch.round(query_points[:, 0]).long()
    if frame_ids is None:
        frame_ids = torch.arange(t, device=points.device)
    onehot = (q_t[:, None] == frame_ids[None, :]).to(points.dtype)
    q_xy = query_points[:, [2, 1]]
    return (points * (1 - onehot)[..., None]
            + q_xy[:, None, :] * onehot[..., None])


FeaturePyramid = Tuple[torch.Tensor, ...]


class TAPIR(nn.Module):
    def __init__(self, highres_dim: int = 128, lowres_dim: int = 256,
                 num_pips_iter: int = 4, pyramid_level: int = 1,
                 mixer_hidden_dim: int = 512, num_mixer_blocks: int = 12,
                 patch_size: int = 7, softmax_temperature: float = 20.0,
                 use_causal_conv: bool = False):
        super().__init__()
        self.highres_dim = highres_dim
        self.lowres_dim = lowres_dim
        self.num_pips_iter = num_pips_iter
        self.pyramid_level = pyramid_level
        self.patch_size = patch_size
        self.softmax_temperature = softmax_temperature
        self.resnet = TapirResNet()
        feats = highres_dim + lowres_dim
        self.pips_mixer = PIPSMLPMixer(
            4 + feats + (2 + pyramid_level) * patch_size ** 2, 4 + feats,
            hidden_dim=mixer_hidden_dim, num_blocks=num_mixer_blocks,
            use_causal_conv=use_causal_conv)
        self.cost_volume_regression_1 = SameConv2d(1, 16, 3)
        self.cost_volume_regression_2 = SameConv2d(16, 1, 3)
        self.cost_volume_occlusion_1 = SameConv2d(16, 32, 3, 2)
        self.cost_volume_occlusion_2 = nn.Linear(32, 16)
        self.occlusion_out = nn.Linear(16, 2)

    def get_feature_grids(self, video: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """video [T, 256, 256, 3] in [-1, 1] -> (hires [T, 64, 64, 128],
        lowres [T, 32, 32, 256]), L2-normalised over channels."""
        out = self.resnet(video.permute(0, 3, 1, 2))
        return (l2_normalize(out["resnet_unit_1"].permute(0, 2, 3, 1)),
                l2_normalize(out["resnet_unit_3"].permute(0, 2, 3, 1)))

    def feature_pyramid(self, video: torch.Tensor) -> FeaturePyramid:
        """[hires, lowres] and `pyramid_level` 2 x 2 average pools of the
        last: what `track` reads, computed once per video."""
        pyramid = list(self.get_feature_grids(video))
        for _ in range(self.pyramid_level):
            prev = pyramid[-1].permute(0, 3, 1, 2)
            pyramid.append(F.avg_pool2d(prev, 2).permute(0, 2, 3, 1))
        return tuple(pyramid)

    def get_query_features(self, hires, lowres, query_points,
                           time_shard=None):
        return (sample_query_features(hires, query_points, time_shard),
                sample_query_features(lowres, query_points, time_shard))

    def tracks_from_cost_volume(self, query_feats, lowres, query_points,
                                frame_ids=None):
        """query_feats [N, C]; lowres [T, h, w, C]; query_points [N, 3] or
        None; frame_ids [T] the frames' global ids. Returns (points
        [N, T, 2] (x, y) raster, occlusion [N, T], expected_dist [N, T]),
        the query frames pinned to the queries."""
        t, h8, w8, _ = lowres.shape
        n = query_feats.shape[0]
        cost = torch.einsum("nc,thwc->tnhw", query_feats, lowres)
        hid = F.relu(self.cost_volume_regression_1(
            cost.reshape(t * n, 1, h8, w8)))
        pos = self.cost_volume_regression_2(hid)[:, 0]
        pos = pos.reshape(t, n, h8, w8).transpose(0, 1)
        softmaxed = torch.softmax(
            (pos * self.softmax_temperature).reshape(n, t, -1), dim=-1
        ).reshape(n, t, h8, w8)
        points = convert_coords(soft_argmax_heatmap(softmaxed), (w8, h8),
                                (TRAIN_SIZE[1], TRAIN_SIZE[0]))
        occ = F.relu(self.cost_volume_occlusion_1(hid)).mean((-2, -1))
        occ = self.occlusion_out(F.relu(self.cost_volume_occlusion_2(occ)))
        occ = occ.reshape(t, n, 2)
        if query_points is not None:
            points = pin_query_frames(points, query_points, frame_ids)
        return points, occ[..., 0].T, occ[..., 1].T

    def refine_pips(self, query_feats, pyramid, pos_guess, occ_guess,
                    expd_guess, last_iter=None, causal_context=None,
                    get_causal_context=False, time_shard=None,
                    frame_valid=None):
        """One refinement pass. query_feats (hires [N, Ch], lowres [N,
        Cl]); pyramid: grids [T, h, w, C]; pos_guess [N, T, 2] (x, y)
        raster; occ / expd [N, T]; last_iter [N, T, Ch + Cl] or None."""
        n, t = occ_guess.shape
        half = self.patch_size // 2
        offs = torch.arange(-half, half + 1, dtype=torch.float32,
                            device=pos_guess.device)
        queries = [query_feats[0], query_feats[1]]
        queries += [queries[-1]] * self.pyramid_level
        corrs_pyr = []
        for pyridx, (query, grid) in enumerate(zip(queries, pyramid)):
            gh, gw = grid.shape[1], grid.shape[2]
            coords = convert_coords(pos_guess, (TRAIN_SIZE[1], TRAIN_SIZE[0]),
                                    (gw, gh)) - 0.5
            if last_iter is not None:
                q = (last_iter[..., :self.highres_dim] if pyridx == 0
                     else last_iter[..., self.highres_dim:])
                corrs = torch.einsum("thwc,ntc->nthw", grid, q)
            else:
                corrs = torch.einsum("thwc,nc->nthw", grid, query)
            patches = separable_neighborhood_sample(
                corrs, coords[..., 0], coords[..., 1], offs, offs,
                zero_pad=True)
            corrs_pyr.append(patches.reshape(n, t, -1))
        if last_iter is None:
            feats = torch.cat([queries[0], queries[1]], dim=-1)
            feats = feats[:, None, :].expand(n, t, feats.shape[-1])
        else:
            feats = last_iter
        mlp_input = torch.cat([torch.zeros_like(pos_guess),
                               occ_guess[..., None], expd_guess[..., None],
                               feats, *corrs_pyr], dim=-1)
        new_ctx = None
        if causal_context is not None or get_causal_context:
            res, new_ctx = self.pips_mixer(mlp_input, causal_context,
                                           get_causal_context)
        else:
            res = self.pips_mixer(mlp_input, time_shard=time_shard,
                                  frame_valid=frame_valid)
        out = (pos_guess + res[..., :2], occ_guess + res[..., 2],
               expd_guess + res[..., 3], res[..., 4:] + feats)
        if new_ctx is not None:
            return out + (new_ctx,)
        return out

    def track(self, pyramid: FeaturePyramid, query_points: torch.Tensor,
              time_shard=None) -> Dict[str, torch.Tensor]:
        """Tracks of query_points [N, 3] (t, y, x) raster through the video
        whose `feature_pyramid` is given: dict(tracks [N, T, 2] (x, y)
        raster, occlusion [N, T], expected_dist [N, T]) of the last
        refinement pass. With `time_shard`, the pyramid is this rank's
        block of frames, and so are the outputs."""
        frame_ids = frame_valid = None
        if time_shard is not None:
            frame_ids = time_shard.frame_ids(query_points.device)
            frame_valid = (frame_ids < time_shard.t_valid).float()
        q_hi, q_lo = self.get_query_features(pyramid[0], pyramid[1],
                                             query_points, time_shard)
        points, occlusion, expected_dist = self.tracks_from_cost_volume(
            q_lo, pyramid[1], query_points, frame_ids)
        mixer_feats = None
        for _ in range(self.num_pips_iter):
            points, occlusion, expected_dist, mixer_feats = self.refine_pips(
                (q_hi, q_lo), pyramid, points, occlusion, expected_dist,
                last_iter=mixer_feats, time_shard=time_shard,
                frame_valid=frame_valid)
        return {"tracks": points, "occlusion": occlusion,
                "expected_dist": expected_dist}

    def forward(self, video: torch.Tensor, query_points: torch.Tensor,
                time_shard=None) -> Dict[str, torch.Tensor]:
        """video [T, 256, 256, 3] in [-1, 1]; query_points [N, 3] (t, y,
        x) raster -> `track`'s dict."""
        return self.track(self.feature_pyramid(video), query_points,
                          time_shard)

    def get_query_features_online(self, frames, query_points):
        """frames [F, 256, 256, 3] holding the query frames; query_points
        [N, 3] (t, y, x) with t indexing `frames`."""
        hires, lowres = self.get_feature_grids(frames)
        return self.get_query_features(hires, lowres, query_points)

    def online_step(self, frames, q_hi, q_lo, causal_state=None,
                    query_points=None):
        """Track a chunk of new frames [F, 256, 256, 3] with the causal
        context of the chunks before (`causal_state`: per refinement pass,
        per block; None for the first chunk). Returns (`track`'s dict over
        the chunk, the new state)."""
        pyramid = self.feature_pyramid(frames)
        points, occlusion, expected_dist = self.tracks_from_cost_volume(
            q_lo, pyramid[1], query_points)
        mixer_feats = None
        new_state = []
        for i in range(self.num_pips_iter):
            ctx = causal_state[i] if causal_state is not None else None
            points, occlusion, expected_dist, mixer_feats, new_ctx = (
                self.refine_pips((q_hi, q_lo), pyramid, points, occlusion,
                                 expected_dist, last_iter=mixer_feats,
                                 causal_context=ctx,
                                 get_causal_context=True))
            new_state.append(new_ctx)
        return ({"tracks": points, "occlusion": occlusion,
                 "expected_dist": expected_dist}, new_state)
