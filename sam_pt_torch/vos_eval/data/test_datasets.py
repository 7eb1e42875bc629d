"""VOS test datasets: one generic frame-dir loader, declaratively specialized
(a copy of `sam_pt_tpu/vos_eval/data/test_datasets.py`).

Covers the reference's dataset-selection surface (sam_pt/vos_eval/data/
test_datasets.py: the Long / DAVIS / YouTube-VOS / MOSE / BDD100K wrappers),
rebuilt as a single `VOSDataset` over (image_dir, mask_dir, video list,
per-video VideoReader options). Each public dataset name is a small factory
that resolves its directory layout, video list, and save-frame policy — the
reference's class-per-dataset shape collapses into data:

  dataset      videos from       save frames        reader options
  ---------    ---------------   ----------------   -------------------------
  Long (LV/G)  listdir           annotated frames   shortest/longest size
  DAVIS        ImageSets/<imset> all (default)      size_dir=480p, resolution
                                                    fallback chain, all-GT opt
  YouTube-VOS  listdir           meta.json objects  use_all_mask
  MOSE         listdir           all                use_all_mask
  BDD100K      listdir           all                use_all_mask, P-mode
                                                    int16 masks (>255 ids)
"""
from __future__ import annotations

import json
import os
from os import path
from typing import Dict, Iterator, List, Optional

import numpy as np

from .video_reader import VideoReader


class VOSDataset:
    """Videos are subdirectories of `image_dir`, mirrored under `mask_dir`.

    Save-frame policy (which output PNGs the eval loop must write), exactly
    one of:
      - default: every frame (`to_save=None` readers);
      - `to_save_from_masks`: only frames that have an annotation file
        (the long-video datasets annotate sparsely);
      - `per_video_to_save`: an explicit video -> frame-names map
        (YouTube-VOS meta.json required frames).

    `size_dir`: parallel directory whose frames define the OUTPUT resolution
    (DAVIS full-res inputs report 480p-sized results). Remaining keyword
    arguments go to every `VideoReader` verbatim.
    """

    def __init__(
        self,
        image_dir: str,
        mask_dir: str,
        vid_list: Optional[List[str]] = None,
        *,
        size_dir: Optional[str] = None,
        to_save_from_masks: bool = False,
        per_video_to_save: Optional[Dict[str, List[str]]] = None,
        **reader_kw,
    ):
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.vid_list = sorted(
            os.listdir(image_dir) if vid_list is None else vid_list
        )
        self.size_dir = size_dir
        self.to_save_from_masks = to_save_from_masks
        self.per_video_to_save = per_video_to_save
        self.reader_kw = reader_kw

    def __len__(self) -> int:
        return len(self.vid_list)

    def get_datasets(self) -> Iterator[VideoReader]:
        for video in self.vid_list:
            mask_dir = path.join(self.mask_dir, video)
            if self.to_save_from_masks:
                to_save = [name[:-4] for name in os.listdir(mask_dir)]
            elif self.per_video_to_save is not None:
                to_save = self.per_video_to_save.get(video)
            else:
                to_save = None
            kw = dict(self.reader_kw)
            if self.size_dir is not None:
                kw["size_dir"] = path.join(self.size_dir, video)
            yield VideoReader(
                video,
                path.join(self.image_dir, video),
                mask_dir,
                to_save=to_save,
                **kw,
            )


def LongTestDataset(data_root, size=-1, longest_size=None) -> VOSDataset:
    """Generic frame-dir dataset (LV1/LV3/G modes): sparse annotations name
    the frames to save."""
    return VOSDataset(
        path.join(data_root, "JPEGImages"),
        path.join(data_root, "Annotations"),
        to_save_from_masks=True,
        shortest_size=size,
        longest_size=longest_size,
    )


def DAVISTestDataset(
    data_root,
    imset="2017/val.txt",
    size=-1,
    longest_size=None,
    return_all_gt_masks=False,
) -> VOSDataset:
    """DAVIS 2016/2017: video list from ImageSets/<imset>; at size != 480 the
    full-resolution frames are preferred with a fallback chain (the reference
    asserts where we fall back: the common DAVIS download ships only 480p, so
    size=-1 + longest_size — the default config — still runs, with a
    warning); output sizes always come from the 480p directory."""
    if size != 480:
        resolutions = ("Full-Resolution", "1080p", "480p")
        for res in resolutions:
            image_dir = path.join(data_root, "JPEGImages", res)
            if path.exists(image_dir):
                break
            print(f"{image_dir} not found. Looking at other options.")
        assert path.exists(image_dir), f"Path does not exist: {image_dir}"
    else:
        res = "480p"
        image_dir = path.join(data_root, "JPEGImages", res)

    with open(path.join(data_root, "ImageSets", imset)) as f:
        vid_list = [line.strip() for line in f if line.strip()]

    return VOSDataset(
        image_dir,
        path.join(data_root, "Annotations", res),
        vid_list,
        size_dir=path.join(data_root, "JPEGImages", "480p"),
        shortest_size=size,
        longest_size=longest_size,
        use_all_mask=return_all_gt_masks,
    )


def YouTubeVOSTestDataset(data_root, split, size=480,
                          longest_size=None) -> VOSDataset:
    """YouTube-VOS 2018/2019: all_frames inputs; meta.json lists, per video,
    the frames each object is evaluated on — those must be saved."""
    with open(path.join(data_root, split, "meta.json")) as f:
        meta = json.load(f)["videos"]
    req_frames = {
        vid: sorted({f for obj in vmeta["objects"].values()
                     for f in obj["frames"]})
        for vid, vmeta in meta.items()
    }
    return VOSDataset(
        path.join(data_root, "all_frames", split + "_all_frames",
                  "JPEGImages"),
        path.join(data_root, split, "Annotations"),
        per_video_to_save=req_frames,
        shortest_size=size,
        longest_size=longest_size,
        use_all_mask=True,
    )


def MOSETestDataset(data_root, split="val", shortest_size=-1,
                    longest_size=None) -> VOSDataset:
    return VOSDataset(
        path.join(data_root, split, "JPEGImages"),
        path.join(data_root, split, "Annotations"),
        shortest_size=shortest_size,
        longest_size=longest_size,
        use_all_mask=True,
    )


def BDD100KTestDataset(data_root, split="val", shortest_size=-1,
                       longest_size=None) -> VOSDataset:
    """BDD100K-converted VOS: palette PNGs carry >255 instance ids, so masks
    load in 'P' mode as int16."""
    return VOSDataset(
        path.join(data_root, split, "JPEGImages"),
        path.join(data_root, split, "Annotations"),
        shortest_size=shortest_size,
        longest_size=longest_size,
        use_all_mask=True,
        mask_mode="P",
        mask_dtype=np.int16,
    )
