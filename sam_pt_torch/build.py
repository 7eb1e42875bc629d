"""Factory for the port's main path (what `bench.py::build_pipeline` builds
for the JAX package): SAM ViT-H + CoTracker (stride 4, window 8, interp
384 x 512, 6 iterations, support grid 2 every 12 frames) under `SamPt`
with the reference's default point configuration.

Weights are random, drawn from an explicit generator: every parameter and
buffer ~ N(0, 0.02^2), in the working dtype, on an explicit device.
"""
from __future__ import annotations

from typing import Union

import torch
from torch import nn

from .models.sam.predictor import SamPredictor
from .models.sam.sam_model import Sam
from .models.sam_pt import SamPt
from .models.tracker.cotracker.model import CoTracker
from .models.tracker.cotracker.tracker import CoTrackerPointTracker

SAM_PT_SETTINGS = dict(
    sam_iou_threshold=0.7,
    positive_point_selection_method="kmedoids",
    negative_point_selection_method="mixed",
    positive_points_per_mask=16,
    negative_points_per_mask=1,
    add_other_objects_positive_points_as_negative_points=True,
    iterative_refinement_iterations=12,
    sam_decode_chunk=48,
    sam_encode_chunk=4,
)


@torch.no_grad()
def randomize_(module: nn.Module, generator: torch.Generator,
               std: float = 0.02) -> nn.Module:
    """Fill every parameter and persistent buffer with N(0, std^2) draws."""
    for tensor in list(module.parameters()) + [
            b for name, b in module.named_buffers()
            if name in module.state_dict()]:
        values = torch.randn(tensor.shape, generator=generator,
                             device=generator.device, dtype=torch.float32)
        tensor.copy_(values * std)
    return module


def build_sam_pt(device: Union[str, torch.device],
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0) -> SamPt:
    """The main-path SamPt on `device` in `dtype`, with random weights
    drawn from a generator on `device` seeded with `seed`."""
    device = torch.device(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    sam = Sam("vit_h")
    tracker_model = CoTracker(s=8, stride=4)
    for model in (sam, tracker_model):
        randomize_(model.to(device), generator)
        model.to(dtype).eval().requires_grad_(False)

    tracker = CoTrackerPointTracker(
        tracker_model, interp_shape=(384, 512), support_grid_size=2,
        support_grid_every_n_frames=12, iters=6)
    return SamPt(point_tracker=tracker, sam_predictor=SamPredictor(sam),
                 **SAM_PT_SETTINGS)
