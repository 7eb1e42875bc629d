"""VIS dataset registry and loader for YTVIS-format JSON (counterpart of
`sam_pt_tpu/vis_eval/datasets.py`).

The same registry as the JAX package's (YTVIS 2019/2021, UVO v1/v0.5,
their tiny debug splits): a name -> (json, image root, class_agnostic)
table and a loader that yields per-video dicts ready for the adapter.
Frames are read by `vos_eval/data/image_io.py::read_rgb`: PNG by the
port's codec, JPEG through Pillow where it is installed.
"""
from __future__ import annotations

import json
from os import path
from typing import Dict, Iterator, Tuple

import numpy as np

from ..vos_eval.data.image_io import read_rgb

# name -> (annotations json, image root, class_agnostic)
_PREDEFINED = {
    "ytvis_2019_val": ("ytvis_2019/valid.json", "ytvis_2019/valid/JPEGImages", False),
    "ytvis_2019_train": ("ytvis_2019/train.json", "ytvis_2019/train/JPEGImages", False),
    "ytvis_2021_val": ("ytvis_2021/valid/instances.json", "ytvis_2021/valid/JPEGImages", False),
    "ytvis_2021_val_tiny": ("ytvis_2021/valid/instances_tiny.json", "ytvis_2021/valid/JPEGImages", False),
    "ytvis_2021_val_mini": ("ytvis_2021/valid/instances_mini.json", "ytvis_2021/valid/JPEGImages", False),
    "uvo_v1_val": ("UVOv1.0/VideoDenseSet/UVO_video_val_dense.json", "UVOv1.0/uvo_videos_dense_frames", True),
    "uvo_v1_val_tiny": ("UVOv1.0/VideoDenseSet/UVO_video_val_dense_tiny.json", "UVOv1.0/uvo_videos_dense_frames", True),
    "uvo_v05_val": ("UVOv0.5/VideoDenseSet/UVO_video_val_dense.json", "UVOv0.5/uvo_videos_dense_frames", True),
}

_CUSTOM: Dict[str, Tuple[str, str, bool]] = {}


def register_dataset(name: str, json_file: str, image_root: str,
                     class_agnostic: bool = False) -> None:
    _CUSTOM[name] = (json_file, image_root, class_agnostic)


def resolve_dataset(name: str, data_root: str) -> Tuple[str, str, bool]:
    """(json, image root, class_agnostic) of a registered or predefined
    dataset; relative paths resolve under `data_root`, absolute ones pass
    through."""
    if name in _CUSTOM:
        j, r, ca = _CUSTOM[name]
        return (
            j if path.isabs(j) else path.join(data_root, j),
            r if path.isabs(r) else path.join(data_root, r),
            ca,
        )
    if name not in _PREDEFINED:
        raise KeyError(f"Unknown VIS dataset: {name}")
    j, r, ca = _PREDEFINED[name]
    return path.join(data_root, j), path.join(data_root, r), ca


class VISDataset:
    """YTVIS-format dataset: iterates videos as adapter-ready dicts."""

    def __init__(self, json_file: str, image_root: str,
                 class_agnostic: bool = False):
        with open(json_file) as f:
            self.gt = json.load(f)
        self.image_root = image_root
        self.class_agnostic = class_agnostic
        self.videos = self.gt["videos"]

    def __len__(self) -> int:
        return len(self.videos)

    def load_video(self, video: Dict) -> Dict:
        images = np.stack([read_rgb(path.join(self.image_root, name))
                           for name in video["file_names"]])
        return {
            "video_id": video["id"],
            "image": images,
            "height": video["height"],
            "width": video["width"],
            "file_names": video["file_names"],
            "length": video.get("length", len(images)),
        }

    def __iter__(self) -> Iterator[Dict]:
        for v in self.videos:
            yield self.load_video(v)
