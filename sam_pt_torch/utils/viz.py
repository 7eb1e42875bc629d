"""Prediction visualisation: mask overlays, trajectory points, video and
frame export, feature PCA images and a summary writer (counterpart of
`add_mask_to_frame`, `draw_points`, `render_predictions`, `save_video`,
`save_frames`, `pca_feature_image` and `SummWriter` in
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
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"writing {path} as a GIF needs Pillow, "
                              f"which is not installed") from e

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


def pca_feature_image(feats: np.ndarray, valid: Optional[np.ndarray] = None,
                      eps: float = 1e-6) -> np.ndarray:
    """Feature maps as a 3-channel PCA image (the counterpart of the JAX
    package's `pca_feature_image`, on the host): 3 principal components
    fitted on the (valid-masked) pixels of the whole batch jointly (at
    most 16384 of them, drawn with a generator seeded 0), every pixel
    projected, each image scaled to uint8 by its 2nd and 98th
    percentiles.

    feats [H, W, C] or [T, H, W, C]; valid an optional [H, W] (or
    [T, H, W]) mask of the pixels to fit on. Returns uint8 RGB [H, W, 3]
    (or [T, H, W, 3]).
    """
    single = feats.ndim == 3
    x = np.asarray(feats, np.float64)
    if single:
        x = x[None]
    t, h, w, c = x.shape
    flat = x.reshape(t * h * w, c) + eps
    fit = flat
    if valid is not None:
        v = np.asarray(valid, bool).reshape(-1)
        if v.any():
            fit = flat[v]
    mean = fit.mean(axis=0)
    centered = fit - mean
    if len(centered) > 16384:
        idx = np.random.default_rng(0).choice(len(centered), 16384,
                                              replace=False)
        centered = centered[idx]
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    proj = (flat - mean) @ vt[:3].T  # [T*H*W, 3]
    if valid is not None:
        proj = proj * np.asarray(valid, bool).reshape(-1, 1)
    proj = proj.reshape(t, h, w, 3)

    out = np.zeros((t, h, w, 3), np.uint8)
    for i in range(t):
        lo = np.percentile(proj[i], 2, axis=(0, 1), keepdims=True)
        hi = np.percentile(proj[i], 98, axis=(0, 1), keepdims=True)
        img = np.clip((proj[i] - lo) / np.maximum(hi - lo, 1e-12), 0, 1)
        out[i] = (img * 255).astype(np.uint8)
    return out[0] if single else out


class SummWriter:
    """A summary writer to files (the counterpart of the JAX package's
    `SummWriter`): `summ_rgb`, `summ_feat` and `summ_oned` write PNGs by
    the port's codec, `summ_rgbs` a video by `save_video`, as
    `<global_step:06d>_<name>.<ext>` under `output_dir`; it writes only
    where `global_step` is a multiple of a positive `log_freq`."""

    def __init__(self, output_dir: str, global_step: int = 0,
                 log_freq: int = 1, fps: int = 8):
        self.output_dir = output_dir
        self.global_step = global_step
        self.fps = fps
        self.save_this = (log_freq > 0) and (global_step % log_freq == 0)
        os.makedirs(output_dir, exist_ok=True)

    def _path(self, name: str, ext: str) -> str:
        safe = name.replace("/", "_")
        return os.path.join(self.output_dir,
                            f"{self.global_step:06d}_{safe}.{ext}")

    def summ_rgb(self, name: str, rgb: np.ndarray) -> None:
        """rgb: [H, W, 3] uint8 (or float in [0, 1])."""
        if not self.save_this:
            return
        img = np.asarray(rgb)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        write_png(self._path(name, "png"), img)

    def summ_rgbs(self, name: str, rgbs: np.ndarray) -> None:
        """rgbs: [T, H, W, 3] uint8 -> an mp4 (a gif without cv2)."""
        if not self.save_this:
            return
        save_video(np.asarray(rgbs), self._path(name, "mp4"), fps=self.fps)

    def summ_feat(self, name: str, feat: np.ndarray,
                  valid: Optional[np.ndarray] = None) -> None:
        """feat: [H, W, C] (or [T, H, W, C]) -> its PCA image (video)."""
        if not self.save_this:
            return
        img = pca_feature_image(feat, valid=valid)
        if img.ndim == 4:
            self.summ_rgbs(name, img)
        else:
            self.summ_rgb(name, img)

    def summ_oned(self, name: str, x: np.ndarray) -> None:
        """x: [H, W] scalar map -> a min-max normalised grey PNG."""
        if not self.save_this:
            return
        x = np.asarray(x, np.float64)
        lo, hi = x.min(), x.max()
        img = ((x - lo) / max(hi - lo, 1e-12) * 255).astype(np.uint8)
        write_png(self._path(name, "png"), img)
