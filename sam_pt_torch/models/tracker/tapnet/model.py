"""TAP-Net (counterpart of `sam_pt_tpu/models/tracker/tapnet/model.py`).

- A TSM-ResNet-18-v2 video backbone: a 7 x 7 / 2 stem and a 3 x 3 / 2
  max-pool, then three units of two pre-activation basic blocks (channels
  64/128/256, strides 1/2/1: output stride 8), a projection shortcut first
  in each unit, and in the first two units a temporal shift of 1/8 of the
  channels on the pre-activation, in the reference's rolled channel
  layout. The output is L2-normalised.
- One cost volume of each query's feature against every frame, a conv
  regression head, a spatial softmax at temperature 10, a soft-argmax
  truncated to radius 5 around the argmax (TAPIR's helpers), an occlusion
  head, and the query frames pinned to the queries.

Time-sharded (`time_shard`, `parallel/temporal.py`): the video is this
rank's block of frames; the temporal shift takes the neighbours' edge
frames (`ring_halo`), masking a padding frame as the source of the last
real frame's backward shift; query features come from the rank that owns
the query frame (a masked `psum`), and query frames are pinned by global
frame id.

BatchNorm is the inference form (`models/batch_norm.py`), with the
checkpoint's moving averages. Layouts are the JAX package's: videos
[T, H, W, 3] in [-1, 1], tracks [N, T, 2] (x, y) in 256-raster units,
query points [N, 3] (t, y, x); convolutions run NCHW inside. Parameter
names are the JAX package's module names
(`tsm_resnet.unit1_block0.bn_pre.running_var`, `occlusion_out.weight`,
...); `utils/checkpoint.py::load_tapnet_checkpoint` reads the public haiku
files.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ....parallel.comm import ring_halo
from ...batch_norm import InferenceBatchNorm
from ..tapir.model import (TRAIN_SIZE, SameConv2d, convert_coords,
                           l2_normalize, pin_query_frames,
                           sample_query_features, same_pad,
                           soft_argmax_heatmap)


def temporal_shift(x: torch.Tensor, fraction: float, time_shard=None,
                   bwd_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """TSM over x [T, C, H, W] in the reference's rolled layout: the first
    n = int(C * fraction) output channels take the next frame's last n
    channels, the last n take the previous frame's first n (zeros past the
    ends), the middle stays. Time-sharded, the frames past this rank's
    block come from its neighbours (`ring_halo`, zeros at the video's
    ends), and `bwd_valid` [T] zeroes the backward shift where its source
    frame is padding."""
    if fraction <= 0:
        return x
    c = x.shape[1]
    n = int(c * fraction)
    if time_shard is None:
        from_left = torch.zeros_like(x[:1, :n])
        from_right = torch.zeros_like(x[:1, c - n:])
    else:
        # the right neighbour's first frame feeds the backward shift, the
        # left neighbour's last frame the forward one
        from_left, from_right = ring_halo(x[:1, c - n:], x[-1:, :n],
                                          time_shard.group)
    bwd = torch.cat([x[1:, c - n:], from_right])
    if bwd_valid is not None:
        bwd = bwd * bwd_valid[:, None, None, None].to(bwd.dtype)
    fwd = torch.cat([from_left, x[:-1, :n]])
    return torch.cat([bwd, x[:, n:c - n], fwd], dim=1)


class TSMBasicBlockV2(nn.Module):
    """BN + relu pre-activation; a projection shortcut from it (identity
    from the raw input otherwise); TSM on it; conv_0 3 x 3 (the stride);
    BN + relu; conv_2 3 x 3."""

    def __init__(self, in_channels: int, output_channels: int,
                 stride: int = 1, use_projection: bool = False,
                 shift_fraction: float = 0.0):
        super().__init__()
        self.shift_fraction = shift_fraction
        self.bn_pre = InferenceBatchNorm(in_channels)
        self.shortcut_conv = (nn.Conv2d(in_channels, output_channels, 1,
                                        stride, bias=False)
                              if use_projection else None)
        self.conv_0 = SameConv2d(in_channels, output_channels, 3, stride,
                                 bias=False)
        self.bn_1 = InferenceBatchNorm(output_channels)
        self.conv_2 = SameConv2d(output_channels, output_channels, 3,
                                 bias=False)

    def forward(self, x, time_shard=None, bwd_valid=None):
        preact = F.relu(self.bn_pre(x))
        shortcut = (x if self.shortcut_conv is None
                    else self.shortcut_conv(preact))
        y = self.conv_0(temporal_shift(preact, self.shift_fraction,
                                       time_shard, bwd_valid))
        y = self.conv_2(F.relu(self.bn_1(y)))
        return y + shortcut


class TSMResNetV2(nn.Module):
    """[T, 3, H, W] -> [T, 256, H / 8, W / 8]."""

    def __init__(self, blocks_per_unit: Sequence[int] = (2, 2, 2),
                 channels_per_unit: Sequence[int] = (64, 128, 256),
                 strides_per_unit: Sequence[int] = (1, 2, 1),
                 shift_fractions: Sequence[float] = (0.125, 0.125, 0.0)):
        super().__init__()
        self.initial_conv = SameConv2d(3, 64, 7, 2, bias=False)
        self.names = []
        in_ch = 64
        for ui, (nb, ch, st, sf) in enumerate(zip(
                blocks_per_unit, channels_per_unit, strides_per_unit,
                shift_fractions)):
            for bi in range(nb):
                name = f"unit{ui}_block{bi}"
                self.add_module(name, TSMBasicBlockV2(
                    in_ch, ch, st if bi == 0 else 1,
                    use_projection=bi == 0, shift_fraction=sf))
                self.names.append(name)
                in_ch = ch

    def forward(self, x, time_shard=None, bwd_valid=None):
        x = self.initial_conv(x)
        x = F.max_pool2d(same_pad(x, 3, 2, value=float("-inf")), 3, 2)
        for name in self.names:
            x = getattr(self, name)(x, time_shard, bwd_valid)
        return x


class TAPNet(nn.Module):
    def __init__(self, num_heads: int = 1, softmax_temperature: float = 10.0):
        super().__init__()
        self.num_heads = num_heads
        self.softmax_temperature = softmax_temperature
        self.tsm_resnet = TSMResNetV2()
        self.cost_volume_regression_1 = SameConv2d(num_heads, 16, 3)
        self.cost_volume_regression_2 = SameConv2d(16, 1, 3)
        self.cost_volume_occlusion_1 = SameConv2d(16, 32, 3, 2)
        self.cost_volume_occlusion_2 = nn.Linear(32, 16)
        self.occlusion_out = nn.Linear(16, 1)

    def get_feature_grid(self, video: torch.Tensor, time_shard=None
                         ) -> torch.Tensor:
        """video [T, 256, 256, 3] in [-1, 1] -> [T, 32, 32, 256],
        L2-normalised over channels (time-sharded: this rank's frames)."""
        bwd_valid = None
        if time_shard is not None:
            ids = time_shard.frame_ids(video.device)
            bwd_valid = (ids < time_shard.t_valid - 1).float()
        out = self.tsm_resnet(video.permute(0, 3, 1, 2), time_shard,
                              bwd_valid)
        return l2_normalize(out.permute(0, 2, 3, 1))

    def track(self, grid: torch.Tensor, query_points: torch.Tensor,
              time_shard=None) -> Dict[str, torch.Tensor]:
        """Tracks of query_points [N, 3] (t, y, x) raster through the video
        whose `get_feature_grid` is `grid`: dict(tracks [N, T, 2] (x, y)
        raster, occlusion [N, T]) (time-sharded: over this rank's
        frames)."""
        t, gh, gw, c = grid.shape
        n = query_points.shape[0]
        d = self.num_heads
        q_feats = sample_query_features(grid, query_points, time_shard)
        cost = torch.einsum("ncd,thwcd->tnhwd", q_feats.reshape(n, c // d, d),
                            grid.reshape(t, gh, gw, c // d, d))
        hid = F.relu(self.cost_volume_regression_1(
            cost.reshape(t * n, gh, gw, d).permute(0, 3, 1, 2)))
        pos = self.cost_volume_regression_2(hid)[:, 0]
        pos = pos.reshape(t, n, gh, gw).transpose(0, 1)
        softmaxed = torch.softmax(
            (pos * self.softmax_temperature).reshape(n, t, -1), dim=-1
        ).reshape(n, t, gh, gw)
        points = convert_coords(soft_argmax_heatmap(softmaxed), (gw, gh),
                                (TRAIN_SIZE[1], TRAIN_SIZE[0]))
        occ = self.cost_volume_occlusion_1(hid).mean((-2, -1))
        occ = self.occlusion_out(F.relu(self.cost_volume_occlusion_2(occ)))
        frame_ids = (None if time_shard is None
                     else time_shard.frame_ids(grid.device))
        return {"tracks": pin_query_frames(points, query_points, frame_ids),
                "occlusion": occ.reshape(t, n).T}

    def forward(self, video: torch.Tensor, query_points: torch.Tensor,
                time_shard=None) -> Dict[str, torch.Tensor]:
        """video [T, 256, 256, 3] in [-1, 1]; query_points [N, 3] (t, y,
        x) raster -> `track`'s dict."""
        return self.track(self.get_feature_grid(video, time_shard),
                          query_points, time_shard)
