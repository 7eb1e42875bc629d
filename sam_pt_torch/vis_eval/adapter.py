"""VIS-to-VOS adapter (counterpart of `sam_pt_tpu/vis_eval/adapter.py`):
SAM's automatic mask generator proposes masks on frame 0, `SamPt` tracks
the first `max_num_masks` of them through the video in batches of
`masks_batch_size`, and the result is a detectron2-style record for the
YTVIS evaluator. Labels are a dummy 0 (SAM does not classify).

`SamPt.forward` returns device tensors: the masks are thresholded there
and downloaded as bool; the float16 logits stay on the device
(`pred_logits`), and only a visualisation downloads them.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from ..models.sam.auto_mask_generator import SamAutomaticMaskGenerator
from ..models.sam_pt import SamPt


class SamBasedVisToVosAdapter:
    def __init__(
        self,
        model: SamPt,
        sam_generator: SamAutomaticMaskGenerator,
        max_num_masks: int = 100,
        masks_batch_size: int = 100,
        visualize_results: bool = False,
        max_videos_to_visualize: int = 0,
        visualization_dir: str = "outputs/vis_visualizations",
    ):
        self.model = model
        self.sam_generator = sam_generator
        self.max_num_masks = max_num_masks
        self.masks_batch_size = masks_batch_size
        self.visualize_results = visualize_results
        self.max_videos_to_visualize = max_videos_to_visualize
        self.visualization_dir = visualization_dir
        self._n_visualized = 0

    def forward(self, batched_inputs: List[Dict]) -> Dict:
        assert len(batched_inputs) == 1, "Only single video inputs are supported"
        inp = batched_inputs[0]
        images = np.asarray(inp["image"])  # [T, H, W, 3] uint8
        if images.shape[1] == 3 and images.shape[-1] != 3:
            images = images.transpose(0, 2, 3, 1)
        assert images.dtype == np.uint8
        vid_id = inp.get("video_id", 0)
        target_hw = (inp["height"], inp["width"])

        records = self.sam_generator.generate(images[0])
        print(
            f"Generated {len(records)} masks for video {vid_id}, keeping the "
            f"first {min(self.max_num_masks, len(records))}"
        )
        if not records:
            t = images.shape[0]
            return {
                "image_size": target_hw,
                "pred_scores": [],
                "pred_labels": [],
                "pred_masks": [],
                "pred_logits": [],
                "trajectories": np.zeros((t, 0, 1, 2), np.float32),
                "visibilities": np.zeros((t, 0, 1), np.float32),
            }

        query_masks = np.stack(
            [r["segmentation"] for r in records[: self.max_num_masks]]
        ).astype(np.float32)
        n_masks = query_masks.shape[0]
        query_ts = np.zeros((n_masks,), np.float32)
        query_labels = np.zeros((n_masks,), np.int64)

        logits, traj, vis, scores = [], [], [], []
        for i in range(0, n_masks, self.masks_batch_size):
            out = self.model.forward({
                "image": images,
                "target_hw": target_hw,
                "query_masks": query_masks[i:i + self.masks_batch_size],
                "query_point_timestep": query_ts[i:i + self.masks_batch_size],
            })
            logits.append(out["logits"])
            traj.append(out["trajectories"])
            vis.append(out["visibilities"])
            scores.append(out["scores"])
        logits = torch.cat(logits)  # [M, T, h, w] float16, on the device
        pred_masks = (logits > 0).cpu().numpy()
        trajectories = torch.cat(traj, dim=1).cpu().numpy()
        visibilities = torch.cat(vis, dim=1).cpu().numpy()
        scores = torch.cat(scores).cpu().numpy()

        if (
            self.visualize_results
            and self._n_visualized < self.max_videos_to_visualize
        ):
            from ..utils.viz import render_predictions, save_video

            frames = render_predictions(
                images, [m.float().cpu().numpy() for m in logits],
                trajectories, visibilities,
            )
            save_video(
                frames,
                os.path.join(self.visualization_dir, f"video_{vid_id}.mp4"),
            )
            self._n_visualized += 1

        return {
            "image_size": target_hw,
            "pred_scores": list(scores),
            "pred_labels": query_labels.tolist(),
            "pred_masks": list(pred_masks),
            "pred_logits": list(logits),
            "trajectories": trajectories,
            "visibilities": visibilities,
        }

    __call__ = forward
