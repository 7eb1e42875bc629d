"""VIS evaluation entry point (counterpart of `sam_pt_tpu/vis_eval/eval.py`).

Per video: the VIS-to-VOS adapter (SAM's automatic proposals on frame 0,
tracked by SamPt), its predictions as COCO-video records with an RLE a
frame (the reference's `instances_to_coco_json_video`), then, on rank 0,
`results.json` and AP / AR@100 by the native YTVIS evaluator. Frames/s is
the frames over the wall time of the loop, reading included, as in the
JAX package.

Run:  python -m sam_pt_torch.vis_eval.eval dataset=uvo_v1_val_tiny
      [data_root=...] [device=cpu]

Over several processes (one rank a card over NCCL, or ranks sharing one
card with `+dist_backend=gloo`), each rank evaluates its strided slice of
the videos and rank 0 gathers, writes and scores:
      torchrun --nproc-per-node 2 -m sam_pt_torch.vis_eval.eval ...
"""
from __future__ import annotations

import json
import os
import sys
import time
from os import path
from typing import Dict, List

import numpy as np

from ..config import compose, instantiate, resolve_interpolations
from ..parallel.eval_sharding import (
    gather_host_results,
    rank,
    shard_videos_across_hosts,
)
from ..parallel.mesh import join_launched_world
from ..utils.util import seed_all
from .datasets import VISDataset, resolve_dataset
from .rle import encode_mask
from .ytvos_eval import YTVOSEvaluator

CONFIG_DIR = path.join(path.dirname(__file__), "..", "configs")


def predictions_to_records(output: Dict, video_id: int) -> List[Dict]:
    """Adapter output -> COCO-video detection records with RLE tracks."""
    records = []
    for score, label, masks in zip(
        output["pred_scores"], output["pred_labels"], output["pred_masks"]
    ):
        segs = [
            encode_mask(m.astype(bool)) if m.any() else None for m in masks
        ]
        records.append(
            {
                "video_id": video_id,
                "category_id": int(label) + 1,  # dummy SAM label 0 -> cat 1
                "score": float(score) if np.isfinite(score) else 0.0,
                "segmentations": segs,
            }
        )
    return records


def evaluate(cfg) -> Dict:
    seed_all(cfg.get("seed", 72))

    json_file, image_root, class_agnostic = resolve_dataset(
        cfg["dataset"], cfg.get("data_root", "data")
    )
    dataset = VISDataset(json_file, image_root, class_agnostic)

    adapter = instantiate(cfg["model"])
    device = getattr(getattr(adapter, "model", None), "device", None)
    if device is not None:
        print(f"Model on {device}")

    # Cap before sharding, so that max_videos counts videos over all
    # processes.
    max_videos = cfg.get("max_videos")
    videos = dataset.videos
    if max_videos is not None:
        videos = videos[:max_videos]
    my_videos = shard_videos_across_hosts(videos)

    all_records: List[Dict] = []
    t0 = time.perf_counter()
    total_frames = 0
    for video_meta in my_videos:
        video = dataset.load_video(video_meta)
        out = adapter([video])
        all_records.extend(predictions_to_records(out, video["video_id"]))
        total_frames += video["image"].shape[0]

    elapsed = time.perf_counter() - t0
    all_records = gather_host_results(all_records)

    results = {
        "fps": total_frames / elapsed if elapsed > 0 else 0.0,
        "n_records": len(all_records),
    }
    print(f"FPS: {results['fps']:.3f} ({total_frames} frames)")
    # Only rank 0 writes and scores.
    if rank() == 0:
        out_dir = cfg.get("output", "outputs/vis")
        os.makedirs(out_dir, exist_ok=True)
        with open(path.join(out_dir, "results.json"), "w") as f:
            json.dump(all_records, f)

        if cfg.get("score", True):
            ev = YTVOSEvaluator(dataset.gt, max_dets=cfg.get("max_dets", 100))
            metrics = ev.evaluate(all_records, class_agnostic=class_agnostic)
            results.update(metrics)
            print({k: round(v, 4) for k, v in metrics.items()})
    return results


def main():
    overrides = [a for a in sys.argv[1:] if "=" in a]
    cfg = compose(CONFIG_DIR, "vis_eval_root", overrides)
    cfg = resolve_interpolations(cfg)
    join_launched_world(cfg.get("dist_backend", "nccl"),
                        cfg.get("device", "cuda"))
    return evaluate(cfg)


if __name__ == "__main__":
    main()
