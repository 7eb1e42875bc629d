"""The standalone tracker demo (counterpart of
`sam_pt_tpu/models/tracker/standalone_demo.py`): TAPIR or TapNet alone on
a clip, a first and a steady-state forward timed, the trajectories
plotted where matplotlib is installed.

    python -m sam_pt_torch.models.tracker.tapir.demo --frames <PNG dir> \
        --query-points <txt> [--checkpoint PATH] [--device cuda]
    python -m sam_pt_torch.models.tracker.tapnet.demo ...

Frames and query points are read as the port's demo reads them
(`sam_pt_torch/demo.py::load_frames`, `load_query_points`); the
repository bundles no clip, so both paths are required. Without a
checkpoint the tracker runs on random weights, which times the forward
and shows that it runs.
"""
from __future__ import annotations

import argparse
import os
import time

import torch


def build_tracker(name: str, checkpoint, device):
    if name == "tapir":
        from .tapir.tracker import TapirPointTracker as tracker
    elif name == "tapnet":
        from .tapnet.tracker import TapNetPointTracker as tracker
    else:
        raise ValueError(f"unknown tracker: {name}")
    return tracker(checkpoint_path=checkpoint,
                   allow_random_init=checkpoint is None, device=device)


def run(name: str, argv=None) -> dict:
    ap = argparse.ArgumentParser(description=f"{name} standalone demo")
    ap.add_argument("--frames", required=True,
                    help="a directory of PNG (or JPEG) frames, or a video "
                         "file (needs cv2)")
    ap.add_argument("--query-points", required=True,
                    help="SAM-PT's query-points file")
    ap.add_argument("--checkpoint", default=None,
                    help="the tracker's public .npy; random weights if "
                         "omitted")
    ap.add_argument("--frame-stride", type=int, default=4)
    ap.add_argument("--max-frames", type=int, default=16)
    ap.add_argument("--longest-side", type=int, default=512)
    ap.add_argument("--out", default=f"outputs/demo_{name}_tracker")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ...demo import load_frames, load_query_points

    frames, scale = load_frames(args.frames, args.frame_stride,
                                args.max_frames, args.longest_side)
    query_points, _ = load_query_points(args.query_points, scale,
                                        args.frame_stride)
    qp = query_points.reshape(1, -1, 3)  # every mask's points, one call
    t = frames.shape[0]
    print(f"{name}: {t} frames {frames.shape[1]}x{frames.shape[2]}, "
          f"{qp.shape[1]} query points, checkpoint={args.checkpoint}, "
          f"device={args.device}")
    tracker = build_tracker(name, args.checkpoint, args.device)

    def forward():
        # a new upload each call, so the tracker's per-video cache misses
        video = torch.from_numpy(frames[None]).to(args.device)
        return tracker.forward(video, qp)

    t0 = time.perf_counter()
    forward()
    print(f"first forward: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    traj, vis = forward()
    dt = time.perf_counter() - t0
    print(f"steady-state forward: {dt:.3f}s = {t / dt:.2f} frames/s")
    traj, vis = traj[0], vis[0]  # [T, N, 2], [T, N]

    os.makedirs(args.out, exist_ok=True)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 5))
        ax.imshow(frames[0])
        cmap = plt.get_cmap("hsv")
        n = traj.shape[1]
        for i in range(n):
            colour = cmap(i / max(n, 1))
            ax.plot(traj[:, i, 0], traj[:, i, 1], "-", lw=1, color=colour)
            seen = vis[:, i] > 0
            ax.scatter(traj[seen, i, 0], traj[seen, i, 1], s=6,
                       color=colour)
        ax.set_title(f"{name} trajectories (first frame)")
        ax.set_axis_off()
        path = os.path.join(args.out, "trajectories.png")
        fig.savefig(path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        print(f"saved {path}")
    except Exception as e:  # the plot is optional
        print(f"plot skipped: {e}")
    return {"trajectories": traj, "visibilities": vis, "fps": t / dt}
