"""The one generator of every traffic mix: a fixed cycle of videos, each a
(frames, objects, name) entry at the mix's frame size, run back to back in
a closed loop from the cycle's first video. The entries are a public
dataset's own sequences; the mix's file names its table and its sample.

The seed draws, per video, a texture of 8 x 8 blocks of random colour that
stands still for the first half of the video and then moves right 2
pixels a frame, with noise of +-8 on every frame (so a point's patches stay
similar while the texture is still, and stop being similar after unless
the point follows it), and where each object's box lies. The boxes' sizes
are the mix's, object by object, so every seed gives the same amount of
work in another arrangement. The query masks are on frame 0. Frames are
drawn on the device in one call a video and handed over as host arrays,
as the VOS harness reads them from disk.
"""
from __future__ import annotations

import numpy as np
import torch


def textured_frames(n_frames: int, h: int, w: int, gen: torch.Generator,
                    device) -> torch.Tensor:
    """[T, h, w, 3] uint8 on `device`."""
    texture = torch.randint(0, 255, (h // 8 + 1, w // 8 + 1, 3),
                            generator=gen, device=device, dtype=torch.int16)
    texture = texture.repeat_interleave(8, 0).repeat_interleave(8, 1)[:h, :w]
    still = n_frames // 2
    shifts = [2 * max(0, t - still + 1) for t in range(n_frames)]
    noise = torch.randint(-8, 8, (n_frames, h, w, 3), generator=gen,
                          device=device, dtype=torch.int16)
    frames = torch.stack([torch.roll(texture, s, dims=1) for s in shifts])
    return (frames + noise).clamp(0, 255).to(torch.uint8)


def box_masks(boxes, h: int, w: int, gen: torch.Generator, device
              ) -> np.ndarray:
    """[M, h, w] float32 {0, 1}: box i of size boxes[i] = (bh, bw) at a
    top-left corner drawn uniformly inside the frame."""
    masks = np.zeros((len(boxes), h, w), np.float32)
    corners = torch.rand((len(boxes), 2), generator=gen, device=device).cpu()
    for i, (bh, bw) in enumerate(boxes):
        r0 = int(corners[i, 0] * (h - bh))
        c0 = int(corners[i, 1] * (w - bw))
        masks[i, r0:r0 + bh, c0:c0 + bw] = 1.0
    return masks


def cycle(traffic: dict, seed: int, device) -> list:
    """The mix's videos, in order: dicts of what the VOS harness hands the
    model ('image' [T, H, W, 3] uint8, 'target_hw', 'query_masks',
    'query_point_timestep'), plus 'frames' and 'objects'."""
    h, w = traffic["frame_hw"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    videos = []
    for i, (t, m, name) in enumerate(traffic["cycle"]):
        frames = textured_frames(t, h, w, gen, device).cpu().numpy()
        masks = box_masks(traffic["boxes"][:m], h, w, gen, device)
        videos.append({
            "video_id": f"{i:03d}--{name}--{t}x{m}",
            "image": frames,
            "target_hw": (h, w),
            "query_masks": masks,
            "query_point_timestep": np.zeros(m, np.float32),
            "frames": t,
            "objects": m,
        })
    return videos


def warm_videos(videos: list, frames: int) -> list:
    """One short video per distinct object count of the cycle (its first
    `frames` frames), which reach every shape the cycle's videos reach
    except those that grow with a video's length."""
    seen, out = set(), []
    for v in videos:
        if v["objects"] in seen:
            continue
        seen.add(v["objects"])
        short = dict(v)
        short["image"] = v["image"][:frames]
        short["frames"] = min(frames, v["frames"])
        out.append(short)
    return out
