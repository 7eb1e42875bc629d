"""Video demo of the PyTorch port (counterpart of `demo/demo.py`): SAM-PT
over a frame directory or a video file from query points in a text file,
the overlays written as frames (and as an mp4 where cv2 is installed).

    python -m sam_pt_torch.demo frames_path=<dir of PNG/JPEG frames or a
        video file> query_points_path=<txt> [device=cpu] [key=value ...]

composes `sam_pt_torch/configs/demo.yaml` (the repo's default model, SAM
ViT-B + PIPS, on `device`, cuda by default). The query-points file is
SAM-PT's format: the number of positive points on the first line, then
one line a mask, `timestep ; x1,y1 x2,y2 ...`, positives first, in the
original frames' pixels. PNG frames are read by the port's own codec (JPEG
frames need Pillow, a video file cv2); the longest-side resize needs no
cv2. The JAX demo's cv2 click UI, used when no query-points file is given,
is not ported: the file is required.
"""
from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import compose, instantiate, resolve_interpolations
from .utils.util import seed_all
from .utils.viz import render_predictions, save_frames, save_video
from .vos_eval.data.image_io import read_rgb

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")
FRAME_SUFFIXES = (".png", ".jpg", ".jpeg")


def _area_weights(in_size: int, out_size: int, shrink: bool) -> np.ndarray:
    """cv2's INTER_AREA weights along one axis, [out_size, in_size] float64.

    `shrink` (cv2 takes it when no axis grows): each output pixel averages
    the input pixels its cell covers, weighted by the covered fraction.
    Otherwise cv2's bilinear rule for INTER_AREA: taps floor(dx * scale)
    and the next, the second weighted by how far the output pixel's cell
    reaches past the input pixel's, clamped at the borders.
    """
    scale = in_size / out_size
    w = np.zeros((out_size, in_size))
    for dx in range(out_size):
        if shrink:
            f1 = dx * scale
            f2 = f1 + scale
            s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
            cell = min(scale, in_size - f1)
            if s1 - f1 > 1e-3:
                w[dx, s1 - 1] = (s1 - f1) / cell
            w[dx, s1:min(s2, in_size)] = 1.0 / cell
            if f2 - s2 > 1e-3 and s2 < in_size:
                w[dx, s2] = min(min(f2 - s2, 1.0), cell) / cell
        else:
            sx = int(np.floor(dx * scale))
            fx = (dx + 1) - (sx + 1) / scale
            fx = 0.0 if fx <= 0 else fx - np.floor(fx)
            if sx < 0:
                fx, sx = 0.0, 0
            if sx >= in_size - 1:
                fx, sx = 0.0, in_size - 1
            w[dx, sx] += 1.0 - fx
            if fx:
                w[dx, sx + 1] += fx
    return w


def resize_area(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """[H, W, C] uint8 -> [h, w, C] uint8 with cv2's INTER_AREA (its
    averaging rule when no axis grows, its bilinear rule otherwise),
    computed in float64 and rounded: cv2's own result within one grey
    level. Needs no cv2."""
    h, w, c = image.shape
    oh, ow = out_hw
    shrink = oh <= h and ow <= w
    wy = _area_weights(h, oh, shrink)
    wx = _area_weights(w, ow, shrink)
    x = (wy @ image.reshape(h, w * c).astype(np.float64)).reshape(oh, w, c)
    x = (x.transpose(0, 2, 1) @ wx.T).transpose(0, 2, 1)
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def load_frames(frames_path: str, frame_stride: int = 1,
                max_frames: Optional[int] = None,
                longest_side_length: Optional[int] = None
                ) -> Tuple[np.ndarray, float]:
    """A frame directory (PNG or JPEG files, in name order) or a video file
    (cv2) -> ([T, H, W, 3] uint8 RGB, the resize scale): every
    `frame_stride`-th frame, at most `max_frames`, the longest side resized
    to `longest_side_length` with INTER_AREA (cv2's where it is installed,
    `resize_area` otherwise). Query points in original-frame pixels are
    multiplied by the returned scale."""
    frames: List[np.ndarray] = []
    if os.path.isdir(frames_path):
        names = sorted(f for f in os.listdir(frames_path)
                       if f.lower().endswith(FRAME_SUFFIXES))
        for name in names[::frame_stride]:
            frames.append(read_rgb(os.path.join(frames_path, name)))
            if max_frames and len(frames) >= max_frames:
                break
    elif os.path.exists(frames_path):
        if cv2 is None:
            raise ImportError(f"reading the video file {frames_path} needs "
                              f"cv2; give a directory of PNG frames instead")
        cap = cv2.VideoCapture(frames_path)
        idx = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx % frame_stride == 0:
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                if max_frames and len(frames) >= max_frames:
                    break
            idx += 1
        cap.release()
    if not frames:
        raise FileNotFoundError(f"no frames found at {frames_path}")
    video = np.stack(frames)
    scale = 1.0
    if longest_side_length:
        h, w = video.shape[1:3]
        scale = longest_side_length / max(h, w)
        if scale != 1.0:
            hw = (int(h * scale + 0.5), int(w * scale + 0.5))
            if cv2 is not None:
                video = np.stack([cv2.resize(f, hw[::-1],
                                             interpolation=cv2.INTER_AREA)
                                  for f in video])
            else:
                video = np.stack([resize_area(f, hw) for f in video])
    return video, scale


def load_query_points(path: str, scale: float = 1.0, frame_stride: int = 1
                      ) -> Tuple[np.ndarray, int]:
    """SAM-PT's query-points file -> (query points [M, P, 3] (t, x, y)
    float32, the number of positives). Coordinates are multiplied by
    `scale`, timesteps divided by `frame_stride` (each must be a multiple
    of it); every mask must have the same number of points."""
    with open(path) as f:
        lines = [line.strip() for line in f if line.strip()]
    n_positive = int(lines[0])
    masks = []
    for line in lines[1:]:
        ts, _, rest = line.partition(";")
        t = int(ts)
        if t % frame_stride:
            raise ValueError(f"query timestep {t} is not a multiple of "
                             f"frame_stride {frame_stride}")
        t //= frame_stride
        pts = []
        for tok in rest.split():
            x, y = tok.split(",")
            pts.append((float(t), float(x) * scale, float(y) * scale))
        masks.append(pts)
    if len({len(m) for m in masks}) != 1:
        raise ValueError(f"{path}: the masks have different numbers of "
                         f"query points")
    return np.asarray(masks, np.float32), n_positive


def run_inference(model, images: np.ndarray, query_points: np.ndarray
                  ) -> dict:
    h, w = images.shape[1:3]
    return model.forward({"video_name": "demo", "video_id": 0,
                          "image": images, "target_hw": (h, w),
                          "query_points": query_points})


def main(cfg) -> dict:
    """Load the frames and query points, run the model, write the overlays;
    returns the model's outputs as numpy arrays."""
    seed_all(cfg.get("seed", 72))
    images, resize_scale = load_frames(
        cfg["frames_path"], cfg.get("frame_stride", 1),
        cfg.get("max_frames"), cfg.get("longest_side_length"))
    if not cfg.get("query_points_path"):
        raise ValueError("the demo needs `query_points_path` (the JAX "
                         "demo's click UI is not ported)")
    # Query files use original-frame pixels: scaled by the frames' resize
    # unless `query_points_scale` says otherwise.
    scale = cfg.get("query_points_scale")
    query_points, n_positive = load_query_points(
        cfg["query_points_path"], resize_scale if scale is None else scale,
        cfg.get("frame_stride", 1))

    model = instantiate(cfg["model"])
    model.positive_points_per_mask = n_positive
    model.negative_points_per_mask = query_points.shape[1] - n_positive

    t0 = time.perf_counter()
    outputs = {k: v.float().cpu().numpy() if torch.is_tensor(v) else v
               for k, v in run_inference(model, images, query_points).items()}
    dt = time.perf_counter() - t0
    print(f"Inference: {len(images)} frames in {dt:.2f}s "
          f"({len(images) / dt:.2f} fps, first call included)")

    out_dir = cfg.get("output_dir", "outputs/demo")
    frames = render_predictions(images, list(outputs["logits"]),
                                outputs["trajectories"],
                                outputs["visibilities"])
    if cv2 is not None:
        save_video(frames, os.path.join(out_dir, "overlay.mp4"))
    save_frames(frames, os.path.join(out_dir, "frames"))
    print(f"Demo wrote {len(frames)} frames to {out_dir}")
    print(f"Scores: {outputs['scores']}")
    return outputs


def cli():
    overrides = [a for a in sys.argv[1:] if "=" in a]
    cfg = resolve_interpolations(compose(CONFIG_DIR, "demo", overrides))
    return main(cfg)


if __name__ == "__main__":
    cli()
