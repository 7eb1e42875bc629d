"""Streaming label registry for index masks with non-contiguous values
(a copy of `sam_pt_tpu/vos_eval/data/mask_mapper.py`).

VOS ground-truth PNGs carry arbitrary palette values (objects may be
labelled 3, 17, 255, ...). The evaluator works on dense per-object channels,
so each distinct value is assigned the next free channel index in the order
it first appears across the video, and predictions are mapped back to the
original values before saving. Mirrors the behavior of the XMem-style
helper the reference evaluates through (sam_pt/vos_eval/data/
mask_mapper.py:19-77), re-done as vectorized numpy lookup tables.

Public surface consumed by `vos_eval/eval.py`:
  - `convert_mask(mask, ...) -> (onehot [L, H, W] float32, new_channel_ids)`
  - `remap_index_mask(dense_mask) -> original-valued mask`
  - `.remappings` (original value -> channel index), `.coherent`
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def all_to_onehot(masks: np.ndarray, labels: List[int]) -> np.ndarray:
    """Stack per-label binary planes: [H, W] or [T, H, W] -> [L, ...] uint8.

    One vectorized comparison against the label vector; `labels` order
    defines the channel order.
    """
    if not labels:
        return np.zeros((0, *masks.shape), dtype=np.uint8)
    lab = np.asarray(labels, dtype=masks.dtype)
    planes = masks[None, ...] == lab.reshape((-1,) + (1,) * masks.ndim)
    return planes.astype(np.uint8)


class MaskMapper:
    """Assigns dense 1-based channel indices to label values as they appear.

    `coherent` stays True while every assignment is the identity
    (value k -> channel k), letting `remap_index_mask` short-circuit —
    the common DAVIS case where GT already uses 1..N.
    """

    def __init__(self) -> None:
        self.remappings: Dict[int, int] = {}
        self.coherent: bool = True

    @property
    def labels(self) -> List[int]:
        """Original label values in registration (= channel) order."""
        return list(self.remappings)

    def convert_mask(
        self,
        mask: np.ndarray,
        exhaustive: bool = False,
        dtype=np.uint8,
        old_labels_allowed: bool = False,
    ) -> Tuple[np.ndarray, List[int]]:
        """Register the mask's labels; return its one-hot planes over ALL
        labels seen so far plus the channel ids that are new this call
        (every channel id when `exhaustive`).

        `exhaustive`: the caller guarantees this mask shows every object at
        once (first-frame GT); re-seen values are then expected, not an
        error. Otherwise a value that was already registered is a protocol
        violation unless `old_labels_allowed`.
        """
        present = np.unique(mask).astype(dtype)
        present = [int(v) for v in present if v != 0]
        fresh = [v for v in present if v not in self.remappings]
        if not (exhaustive or old_labels_allowed) and len(fresh) != len(present):
            raise AssertionError("Old labels found in non-exhaustive mode")

        first_new = len(self.remappings) + 1
        for offset, value in enumerate(fresh):
            channel = first_new + offset
            self.remappings[value] = channel
            self.coherent = self.coherent and channel == value

        total = len(self.remappings)
        if exhaustive:
            announced = list(range(1, total + 1))
        elif self.coherent:
            announced = fresh
        else:
            announced = list(range(first_new, total + 1))

        onehot = all_to_onehot(mask, self.labels).astype(np.float32)
        return onehot, announced

    def remap_index_mask(self, mask: np.ndarray) -> np.ndarray:
        """Dense channel indices -> original label values (save-time inverse)."""
        if self.coherent:
            return mask
        lut = np.zeros(max(self.remappings.values()) + 1, dtype=mask.dtype)
        for value, channel in self.remappings.items():
            lut[channel] = value
        return lut[mask]
