"""A small SamPt on random weights, for smoke runs of the entry points
(counterpart of `build_tiny_sam_pt` in `sam_pt_tpu/utils/testing.py`):
the tiny SAM (ViT of width 32, depth 2, 64-pixel input) and PIPS at width
16 (stride 4, 4-frame windows, 2 iterations), N(0, 0.02^2) weights from a
generator seeded with `seed`. `configs/model/sam_pt_tiny_test.yaml` names
it, so that `model=sam_pt_tiny_test` runs the CLI in seconds on the CPU
(with `+model.interactive=true`, as a `SamPtInteractive`).
`build_tiny_predictor` is the tiny SAM alone (counterpart of the JAX
package's `build_tiny_predictor`), named by `configs/model/sam/
sam_tiny_test.yaml` for the VIS CLI, where the generator and the SamPt
share it; `build_tiny_sam` and `build_tiny_pips` are its SAM and a tiny
PIPS tracker alone (the JAX package's builders of the same names).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..models.sam.predictor import SamPredictor
from ..models.sam.sam_model import Sam
from ..models.sam_pt import SamPt
from ..models.sam_pt_interactive import SamPtInteractive
from ..models.tracker.pips.model import Pips
from ..models.tracker.pips.tracker import PipsPointTracker
from .checkpoint import randomize_

TINY_VIT = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,),
                window_size=2)


def _tiny_sam(device: torch.device, generator: torch.Generator,
              image_size: int = 64) -> Sam:
    sam = randomize_(Sam(TINY_VIT, image_size=image_size).to(device),
                     generator)
    return sam.eval().requires_grad_(False)


def _tiny_pips(device: torch.device, generator: torch.Generator,
               seed: int, s: int = 4, stride: int = 4) -> PipsPointTracker:
    tracker = PipsPointTracker(stride=stride, s=s, iters=2,
                               allow_random_init=True, seed=seed,
                               device=device)
    tracker.model = randomize_(
        Pips(s=s, stride=stride, latent_dim=16, hidden_dim=32,
             mixer_depth=2).to(device), generator).eval().requires_grad_(
                 False)
    return tracker


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def build_tiny_sam(image_size: int = 64, seed: int = 0,
                   device: Union[str, torch.device] = "cuda") -> Sam:
    """The tiny SAM on `device`; at 64 pixels, the weights
    `build_tiny_sam_pt(seed)` gives its SAM."""
    device = torch.device(device)
    return _tiny_sam(device, _generator(device, seed), image_size)


def build_tiny_predictor(seed: int = 0,
                         device: Union[str, torch.device] = "cuda"
                         ) -> SamPredictor:
    """The tiny SAM's predictor: the weights `build_tiny_sam_pt(seed)`
    gives its SAM."""
    return SamPredictor(build_tiny_sam(seed=seed, device=device))


def build_tiny_pips(seed: int = 0, device: Union[str, torch.device] = "cuda",
                    s: int = 4, stride: int = 4) -> PipsPointTracker:
    """A PIPS tracker at width 16 (hidden 32, a mixer of depth 2, 2
    iterations), N(0, 0.02^2) weights from a generator seeded `seed`."""
    device = torch.device(device)
    return _tiny_pips(device, _generator(device, seed), seed, s, stride)


def build_tiny_sam_pt(seed: int = 0,
                      device: Union[str, torch.device] = "cuda",
                      interactive: bool = False,
                      sam_predictor: Optional[SamPredictor] = None,
                      **settings) -> SamPt:
    """The tiny SamPt; with `sam_predictor`, that predictor in place of
    its own tiny SAM (the tracker's weights stay the same)."""
    device = torch.device(device)
    generator = _generator(device, seed)
    own = SamPredictor(_tiny_sam(device, generator))
    tracker = _tiny_pips(device, generator, seed)
    defaults = dict(
        sam_iou_threshold=0.0,
        positive_points_per_mask=4,
        negative_points_per_mask=1,
        positive_point_selection_method="random",
        negative_point_selection_method="random",
        iterative_refinement_iterations=0,
        sam_decode_chunk=16,
        sam_encode_chunk=4,
    )
    defaults.update(settings)
    cls = SamPtInteractive if interactive else SamPt
    if sam_predictor is None:
        sam_predictor = own
    return cls(point_tracker=tracker, sam_predictor=sam_predictor,
               **defaults)
