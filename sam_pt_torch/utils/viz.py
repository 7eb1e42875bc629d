"""Prediction visualisation: mask overlays, trajectory points, video and
frame export (counterpart of `add_mask_to_frame`, `draw_points`,
`render_predictions`, `save_video` and `save_frames` in
`sam_pt_tpu/utils/viz.py`).

Per-mask coloured alpha overlays and per-point markers coloured by
PointVisibilityType (VISIBILITY_TO_COLOR), saved as mp4 (cv2) or gif
(Pillow), or frame by frame as PNGs (the port's own codec, on every
machine). Points are drawn only where cv2 is installed; Pillow is imported
where a gif is written.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..vos_eval.data.image_io import write_png
from .util import VISIBILITY_TO_COLOR, PointVisibilityType

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

# distinct mask colors (RGB), cycled
MASK_COLORS = [
    (255, 64, 64), (64, 160, 255), (64, 255, 96), (255, 200, 32),
    (200, 64, 255), (64, 255, 230), (255, 128, 190), (160, 255, 64),
]


def add_mask_to_frame(
    frame: np.ndarray, mask: np.ndarray, color, alpha: float = 0.5
) -> np.ndarray:
    """Alpha-blend a binary mask onto an RGB uint8 frame."""
    out = frame.astype(np.float32)
    color = np.asarray(color, np.float32)
    m = mask.astype(bool)
    out[m] = (1 - alpha) * out[m] + alpha * color
    return out.astype(np.uint8)


def draw_points(
    frame: np.ndarray,
    points_xy: np.ndarray,
    visibilities: np.ndarray,
    radius: int = 3,
) -> np.ndarray:
    """Draw trajectory points colored by visibility type."""
    if cv2 is None:
        return frame
    out = np.ascontiguousarray(frame)
    for (x, y), v in zip(points_xy, visibilities):
        try:
            vt = PointVisibilityType(int(round(float(v))))
        except ValueError:
            vt = PointVisibilityType.INVISIBLE
        color = VISIBILITY_TO_COLOR[vt]
        cv2.circle(out, (int(round(x)), int(round(y))), radius, color, -1)
    return out


def render_predictions(
    images: np.ndarray,           # [T, H, W, 3] uint8
    logits: Sequence[np.ndarray],  # list of [T, H, W] per mask
    trajectories: Optional[np.ndarray] = None,  # [T, M, P, 2]
    visibilities: Optional[np.ndarray] = None,  # [T, M, P]
    alpha: float = 0.5,
) -> np.ndarray:
    """Render overlay frames [T, H, W, 3] uint8."""
    t = images.shape[0]
    frames = []
    for f in range(t):
        frame = images[f].copy()
        for mi, ml in enumerate(logits):
            frame = add_mask_to_frame(
                frame, ml[f] > 0, MASK_COLORS[mi % len(MASK_COLORS)], alpha
            )
        if trajectories is not None:
            if visibilities is None:  # default: all points visible
                visibilities = np.ones(trajectories.shape[:-1], np.float32)
            for mi in range(trajectories.shape[1]):
                frame = draw_points(
                    frame, trajectories[f, mi], visibilities[f, mi]
                )
        frames.append(frame)
    return np.stack(frames)


def save_video(frames: np.ndarray, path: str, fps: int = 10) -> None:
    """Save [T, H, W, 3] uint8 RGB frames as mp4 (cv2) or gif (Pillow)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".gif") or cv2 is None:
        from PIL import Image

        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(
            path if path.endswith(".gif") else path + ".gif",
            save_all=True, append_images=imgs[1:],
            duration=int(1000 / fps), loop=0,
        )
        return
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


def save_frames(frames: np.ndarray, out_dir: str, prefix: str = "") -> None:
    """[T, H, W, 3] uint8 RGB frames as `<prefix><t:05d>.png` files under
    `out_dir` (the JAX package writes JPEGs through cv2; PNGs need
    neither cv2 nor Pillow)."""
    os.makedirs(out_dir, exist_ok=True)
    for i, frame in enumerate(frames):
        write_png(os.path.join(out_dir, f"{prefix}{i:05d}.png"), frame)
