"""Tiny stand-ins of the benchmark's cells for tests on the CPU: each
configuration's own file with SAM's encoder cut to 2 blocks of 32 wide on
a 128-pixel input (the trackers keep their widths), and a cycle of two
short videos of 48 x 64 frames, the first of two objects (a run of a
moment does that one alone). CoTracker's output head is scaled down
as well: its steps, sized for 384 x 512, would carry every point out of
a 32 x 48 frame, and no prompt would be left to decode."""
from __future__ import annotations

import copy

from benchmark.harness import registry

TRAFFIC = {"frame_hw": [48, 64], "cycle": [[10, 2, "a"], [9, 1, "b"]],
           "boxes": [[12, 20], [10, 14]], "warm_frames": 4}


def config(cell_name: str) -> dict:
    cfg = copy.deepcopy(registry.Cell(cell_name).config)
    cfg["sam"].update(image_size=128, embed_dim=32, depth=2, num_heads=2,
                      global_attn_indexes=[1], window_size=4)
    if cfg["tracker"]["name"] == "cotracker":
        cfg["tracker"]["interp_shape"] = [32, 48]
        cfg["weights"]["scale_columns"]["tracker"].append(
            ["updateformer.flow_head.weight", 0, 384, 0.2])
    cfg["sam_pt"]["sam_decode_chunk"] = 8
    return cfg


def cell(cell_name: str) -> registry.Cell:
    return registry.Cell(cell_name, config=config(cell_name),
                         traffic=copy.deepcopy(TRAFFIC))
