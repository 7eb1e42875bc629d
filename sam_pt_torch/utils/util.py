"""Point visibility taxonomy (as `sam_pt_tpu.utils.util.PointVisibilityType`):
a point is visible iff its visibility value == 1. Also the visibility
colours of the visualisations and `seed_all`."""
from __future__ import annotations

import enum
import random

import numpy as np
import torch


class PointVisibilityType(enum.IntEnum):
    VISIBLE = 1
    INVISIBLE = 0
    REINIT_FAILED = -1
    OUTSIDE_FRAME = -2
    PATCH_NON_SIMILAR = -3
    REJECTED_AFTER_PATCH_WAS_NON_SIMILAR = -4


# One RGB colour per visibility type for trajectory points.
VISIBILITY_TO_COLOR = {
    PointVisibilityType.VISIBLE: (0, 255, 0),
    PointVisibilityType.INVISIBLE: (255, 0, 0),
    PointVisibilityType.REINIT_FAILED: (0, 0, 0),
    PointVisibilityType.OUTSIDE_FRAME: (255, 255, 0),
    PointVisibilityType.PATCH_NON_SIMILAR: (255, 0, 255),
    PointVisibilityType.REJECTED_AFTER_PATCH_WAS_NON_SIMILAR: (0, 255, 255),
}


def seed_all(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
