"""Point visibility taxonomy (as `sam_pt_tpu.utils.util.PointVisibilityType`):
a point is visible iff its visibility value == 1."""
from __future__ import annotations

import enum


class PointVisibilityType(enum.IntEnum):
    VISIBLE = 1
    INVISIBLE = 0
    REINIT_FAILED = -1
    OUTSIDE_FRAME = -2
    PATCH_NON_SIMILAR = -3
    REJECTED_AFTER_PATCH_WAS_NON_SIMILAR = -4
