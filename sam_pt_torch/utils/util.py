"""Point visibility taxonomy (as `sam_pt_tpu.utils.util.PointVisibilityType`):
a point is visible iff its visibility value == 1. Also the visibility
colours of the visualisations, `seed_all`, `batchify_list` and
`round_up`."""
from __future__ import annotations

import enum
import random
from typing import List, Sequence, TypeVar

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


T = TypeVar("T")


def batchify_list(data: Sequence[T], batch_size: int) -> List[List[T]]:
    """`data` in chunks of at most `batch_size`, in order."""
    return [list(data[i:i + batch_size])
            for i in range(0, len(data), batch_size)]


def round_up(x: int, multiple: int) -> int:
    """x rounded up to a multiple of `multiple`."""
    return ((x + multiple - 1) // multiple) * multiple
