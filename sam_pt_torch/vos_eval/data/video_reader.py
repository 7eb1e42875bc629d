"""Per-video frame/mask reader for VOS datasets (counterpart of
`sam_pt_tpu/vos_eval/data/video_reader.py`).

Iterates a directory of frames (PNG through the port's codec, JPEG and
other formats through Pillow; `image_io`) and index-PNG masks, applying
either a shortest-side resize or SAM's longest-side resize; masks are
resized with nearest interpolation after one-hot mapping (resize_mask,
reference :121-133). Frames come back as uint8 [H, W, 3] numpy arrays.
"""
from __future__ import annotations

import os
from os import path
from typing import Iterator, List, Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from ...ops.resize import get_longest_side_target_hw
from . import image_io


def nearest_resize_index(mask: np.ndarray, hw: tuple) -> np.ndarray:
    """Nearest resize of the last two axes, torch floor convention."""
    h, w = hw
    old_h, old_w = mask.shape[-2:]
    ys = np.minimum((np.arange(h) * old_h / h).astype(np.int64), old_h - 1)
    xs = np.minimum((np.arange(w) * old_w / w).astype(np.int64), old_w - 1)
    return mask[..., ys[:, None], xs[None, :]]


def _resize_image(img: np.ndarray, hw: tuple) -> np.ndarray:
    """uint8 HWC resize, area for downscale / linear for upscale (antialias-like)."""
    if cv2 is None:
        raise ImportError(
            "opencv (cv2) is required for frame resizing "
            "(shortest_size/longest_size runs) but is not installed"
        )
    h, w = hw
    interp = (
        cv2.INTER_AREA if h < img.shape[0] else cv2.INTER_LINEAR
    )
    return cv2.resize(img, (w, h), interpolation=interp)


class VideoReader:
    def __init__(
        self,
        vid_name: str,
        image_dir: str,
        mask_dir: str,
        shortest_size: int = -1,
        longest_size: Optional[int] = None,
        to_save: Optional[List[str]] = None,
        use_all_mask: bool = False,
        size_dir: Optional[str] = None,
        mask_mode: str = "P",
        mask_dtype=np.uint8,
    ):
        assert shortest_size == -1 or longest_size is None, (
            "One size constraint should be given, not both."
        )
        self.vid_name = vid_name
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.to_save = to_save
        self.use_all_mask = use_all_mask
        self.size_dir = size_dir or image_dir
        self.mask_mode = mask_mode
        self.mask_dtype = mask_dtype
        self.shortest_size = shortest_size
        self.longest_size = longest_size

        self.frames = sorted(os.listdir(image_dir))
        mask_files = sorted(os.listdir(mask_dir))
        self.palette = image_io.read_index_mask(
            path.join(mask_dir, mask_files[0]))[1]
        self.first_gt_path = path.join(mask_dir, mask_files[0])

    def __len__(self) -> int:
        return len(self.frames)

    def _target_hw(self, h: int, w: int):
        if self.longest_size is not None:
            return get_longest_side_target_hw(h, w, self.longest_size)
        if self.shortest_size != -1:
            scale = self.shortest_size / min(h, w)
            # torchvision Resize(shortest) convention
            if h < w:
                return self.shortest_size, max(1, round(w * scale))
            return max(1, round(h * scale)), self.shortest_size
        return h, w

    def __getitem__(self, idx: int) -> dict:
        frame = self.frames[idx]
        info = {
            "frame": frame,
            "save": (self.to_save is None) or (frame[:-4] in self.to_save),
        }
        img = image_io.read_rgb(path.join(self.image_dir, frame))
        if self.size_dir == self.image_dir:
            shape = img.shape[:2]
        else:
            # header-only read: never decodes the pixel data
            shape = image_io.image_size(path.join(self.size_dir, frame))

        target_hw = self._target_hw(*img.shape[:2])
        if target_hw != img.shape[:2]:
            img = _resize_image(img, target_hw)

        data = {"rgb": img, "info": info}
        gt_path = path.join(self.mask_dir, frame[:-4] + ".png")
        if (self.use_all_mask or gt_path == self.first_gt_path) and path.exists(gt_path):
            data["mask"] = self.read_mask(gt_path)

        info["shape"] = shape
        info["need_resize"] = self.shortest_size != -1 or self.longest_size is not None
        return data

    def read_mask(self, gt_path: str) -> np.ndarray:
        """An annotation's index array in `mask_dtype`. The codec reads
        palette and grey PNGs, the two that Pillow's `convert("P")` keeps
        as they are: `mask_mode` must be "P"."""
        if self.mask_mode != "P":
            raise NotImplementedError(
                f"mask_mode {self.mask_mode!r}: only palette masks are read")
        return image_io.read_index_mask(gt_path)[0].astype(self.mask_dtype)

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self[i]

    def resize_mask(self, mask: np.ndarray) -> np.ndarray:
        """One-hot mask [L, H, W] -> resized with nearest (reference :121-133).

        Uses the torch F.interpolate(mode='nearest') floor convention
        (src = floor(dst * in/out)), which differs from cv2.INTER_NEAREST.
        """
        old_h, old_w = mask.shape[-2:]
        hw = self._target_hw(old_h, old_w)
        if hw == (old_h, old_w):
            return mask
        return nearest_resize_index(mask, hw)

    @staticmethod
    def nearest_resize(mask: np.ndarray, hw) -> np.ndarray:
        return nearest_resize_index(mask, hw)

    def get_palette(self):
        return self.palette
