"""SuperPoint keypoint detector and descriptor (counterpart of
`sam_pt_tpu/models/tracker/superglue/superpoint.py`), on a batch of frames.

The VGG encoder, the 65-way cell softmax of the detector head with the
dustbin dropped, the heat map at h8*8 x w8*8, non-maximum suppression as a
max-pool equality test, border and threshold, a top-K over the flat heat
map with a validity mask (fixed shapes, K = max_keypoints), and the
descriptor head sampled at the keypoints. The module and parameter names
are magicleap's (`conv1a` ... `convDb`), so `superpoint_v1.pth` loads as
it is.

Three behaviours of the JAX package are mirrored, so that the port computes
its function (ROADMAP §3): non-maximum suppression keeps only the exact
local maxima, and scores at or above the threshold stay (F10); the border
is masked with the input's size on the heat map, which is only w8*8
columns wide (F11), and the flat top-K indices are decoded with the
input's width (F12). Where the input's sides are multiples of 8 none of
the three changes a keypoint's position.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.sampling import bilinear_sample


def simple_nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """scores [B, H, W]: each score where it is the maximum of its
    (2r+1)^2 window, else 0."""
    pooled = F.max_pool2d(scores[:, None], 2 * radius + 1, stride=1,
                          padding=radius)[:, 0]
    return torch.where(scores == pooled, scores, torch.zeros_like(scores))


def l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / x.norm(dim=dim, keepdim=True).clamp(min=1e-12)


# magicleap's fixed settings: the descriptor width and the border that
# loses its keypoints.
DESCRIPTOR_DIM = 256
REMOVE_BORDERS = 4


class SuperPoint(nn.Module):
    def __init__(self, nms_radius: int = 4, keypoint_threshold: float = 0.005,
                 max_keypoints: int = 1024):
        super().__init__()
        self.nms_radius = nms_radius
        self.keypoint_threshold = keypoint_threshold
        self.max_keypoints = max_keypoints
        widths = {"conv1a": (1, 64), "conv1b": (64, 64), "conv2a": (64, 64),
                  "conv2b": (64, 64), "conv3a": (64, 128),
                  "conv3b": (128, 128), "conv4a": (128, 128),
                  "conv4b": (128, 128), "convPa": (128, 256),
                  "convDa": (128, 256)}
        for name, (cin, cout) in widths.items():
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))
        self.convPb = nn.Conv2d(256, 65, 1)
        self.convDb = nn.Conv2d(256, DESCRIPTOR_DIM, 1)

    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """[B, H, W] grey in [0, 1] -> the shared features [B, 128, h8, w8]."""
        x = image[:, None].float()
        for block in ("1", "2", "3", "4"):
            x = F.relu(getattr(self, f"conv{block}a")(x))
            x = F.relu(getattr(self, f"conv{block}b")(x))
            if block != "4":
                x = F.max_pool2d(x, 2, 2)
        return x

    def heat_map(self, x: torch.Tensor, hw) -> torch.Tensor:
        """The shared features -> the thresholded, suppressed heat map
        [B, h8*8, w8*8]."""
        h, w = hw
        logits = self.convPb(F.relu(self.convPa(x)))
        probs = torch.softmax(logits.float(), dim=1)[:, :64]
        b, _, h8, w8 = probs.shape
        heat = probs.reshape(b, 8, 8, h8, w8).permute(0, 3, 1, 4, 2).reshape(
            b, h8 * 8, w8 * 8)[:, :h, :w]
        heat = simple_nms(heat, self.nms_radius)
        r = REMOVE_BORDERS
        border = torch.zeros_like(heat[0])
        border[r:h - r, r:w - r] = 1.0  # F11: the input's h and w
        heat = heat * border
        return torch.where(heat >= self.keypoint_threshold, heat,
                           torch.zeros_like(heat))

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image [B, H, W] grey in [0, 1] -> keypoints [B, K, 2] (x, y),
        scores [B, K] (0 where not valid), valid [B, K] bool, descriptors
        [B, K, D] float32, K = max_keypoints, in order of falling score
        (ties in order of position)."""
        h, w = image.shape[-2:]
        x = self.encode(image)
        heat = self.heat_map(x, (h, w))
        b = heat.shape[0]
        # A stable sort: equal scores keep their flat order, as
        # `jax.lax.top_k` gives them.
        scores, idx = torch.sort(heat.reshape(b, -1), dim=1,
                                 descending=True, stable=True)
        scores = scores[:, :self.max_keypoints]
        idx = idx[:, :self.max_keypoints]
        # F12: the flat index over w8*8 columns, decoded with the input's w.
        keypoints = torch.stack([(idx % w).float(), (idx // w).float()], -1)
        valid = scores > 0.0

        desc_map = l2_normalize(self.convDb(F.relu(self.convDa(x))).float(),
                                dim=1)
        h8, w8 = desc_map.shape[-2:]
        # The half-cell offset, then the align_corners normalisation over
        # the padded extent (magicleap's `sample_descriptors`).
        s = 8.0
        gx = (keypoints[..., 0] - s / 2 + 0.5) * (w8 - 1) / (
            w8 * s - s / 2 - 0.5)
        gy = (keypoints[..., 1] - s / 2 + 0.5) * (h8 - 1) / (
            h8 * s - s / 2 - 0.5)
        desc = bilinear_sample(desc_map.permute(0, 2, 3, 1), gx, gy,
                               pad_mode="clamp")
        return {"keypoints": keypoints,
                "scores": torch.where(valid, scores,
                                      torch.zeros_like(scores)),
                "valid": valid,
                "descriptors": l2_normalize(desc, dim=-1)}
