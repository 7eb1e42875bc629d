"""Factory for the port's SamPt configurations at full width, on random
weights.

With its defaults, `build_sam_pt` builds the main path (what
`bench.py::build_pipeline` builds for the JAX package): SAM ViT-H +
CoTracker (stride 4, window 8, interp 384 x 512, 6 iterations, support grid
2 every 12 frames) under `SamPt` with the reference's default point
configuration. `sam=` picks the SAM encoder (`vit_b`, `vit_l`, `vit_h`, or
`vit_t`, MobileSAM's TinyViT), `hq=True` HQ-SAM's decoder (HQ-SAM ViT-H is
`sam="vit_h", hq=True`, Light HQ-SAM `sam="vit_t", hq=True`), and
`tracker=` the point tracker (`cotracker`, `pips`, `pips_plus_plus`,
`raft`, `superglue`, `tapir`, `tapnet`, each as its
`configs/model/point_tracker/*.yaml` sets it; SuperGlue's quotas are
SamPt's points per mask). The
repo's default model, `configs/model/sam_pt.yaml`, is
`build_sam_pt(device, sam="vit_b", tracker="pips", **DEFAULT_SETTINGS)`;
with `**REINIT_SETTINGS` it builds the point re-initialisation
configuration of `configs/model/sam_pt_reinit.yaml` (`model=sam_pt_reinit`,
for long videos).

Weights are random: SAM's (and CoTracker's, after SAM's) are drawn from one
generator on the device seeded with `seed`, every parameter and buffer
~ N(0, 0.02^2) in the working dtype (TinyViT's BatchNorm statistics then
reset to mean 0, variance 1); PIPS, PIPS++, RAFT, SuperGlue, TAPIR and
TapNet are built in float32 by their own constructors, seeded with
`seed + 1`.
"""
from __future__ import annotations

from typing import Union

import torch

from .models.batch_norm import reset_batch_norm_stats_
from .models.sam.predictor import SamPredictor
from .models.sam.sam_model import Sam
from .models.sam_pt import SamPt
from .models.tracker import TRACKER_REGISTRY
from .models.tracker.cotracker.model import CoTracker
from .models.tracker.cotracker.tracker import CoTrackerPointTracker
from .utils.checkpoint import randomize_

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
# configs/model/sam_pt.yaml: the main path's settings otherwise.
DEFAULT_SETTINGS = dict(sam_decode_chunk=32, point_tracker_mask_batch_size=5,
                        sam_encode_chunk=4)
# configs/model/sam_pt_reinit.yaml: the main path's settings otherwise.
REINIT_SETTINGS = dict(
    use_point_reinit=True,
    reinit_point_tracker_horizon=24,
    reinit_horizon=24,
    reinit_variant="reinit-at-median-of-area-diff",
)
# configs/model/point_tracker/*.yaml, checkpoints aside.
TRACKER_SETTINGS = {
    "pips": dict(stride=4, s=8, initial_next_frame_visibility_threshold=0.9),
    "pips_plus_plus": dict(stride=8, max_sequence_length=128, iters=16,
                           image_size=(512, 896)),
    "raft": dict(iters=32),
    "superglue": dict(max_keypoints=1024, sinkhorn_iterations=100,
                      match_threshold=0.2),
    "tapir": dict(visibility_threshold=0.1, query_chunk_size=64),
    "tapnet": dict(visibility_threshold=0.5, query_chunk_size=16),
}


def build_sam_pt(device: Union[str, torch.device],
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 sam: str = "vit_h", tracker: str = "cotracker",
                 hq: bool = False, **settings) -> SamPt:
    """SamPt with SAM `sam` (HQ-SAM's decoder if `hq`) in `dtype` and the
    point tracker `tracker` on `device`, random weights from `seed`;
    `settings` override SAM_PT_SETTINGS (DEFAULT_SETTINGS for the repo's
    default model, REINIT_SETTINGS for the reinit configuration)."""
    device = torch.device(device)
    settings = dict(SAM_PT_SETTINGS, **settings)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    sam_model = reset_batch_norm_stats_(
        randomize_(Sam(sam, use_hq=hq).to(device), generator))
    sam_model.to(dtype).eval().requires_grad_(False)
    if tracker == "cotracker":
        model = randomize_(CoTracker(s=8, stride=4).to(device), generator)
        point_tracker = CoTrackerPointTracker(
            interp_shape=(384, 512), support_grid_size=2,
            support_grid_every_n_frames=12, iters=6,
            model=model.to(dtype).eval().requires_grad_(False))
    else:
        quotas = {}
        if tracker == "superglue":  # the YAML interpolates SamPt's
            quotas = {k: settings[k] for k in ("positive_points_per_mask",
                                               "negative_points_per_mask")}
        point_tracker = TRACKER_REGISTRY[tracker](
            allow_random_init=True, seed=seed + 1, device=device,
            **TRACKER_SETTINGS[tracker], **quotas)
    return SamPt(point_tracker=point_tracker,
                 sam_predictor=SamPredictor(sam_model), **settings)
