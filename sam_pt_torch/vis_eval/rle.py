"""COCO RLE mask codec (pycocotools-compatible, pure numpy): a copy of
`sam_pt_tpu/vis_eval/rle.py`, held to it by `tests/test_torch_vis_rle.py`.

Replaces the pycocotools dependency of the reference's vendored YTVOS API
(sam_pt/vis_eval/mask2former_video/data_video/datasets/ytvis_api/ytvos.py):
column-major run-length encoding with the compressed ASCII 'counts' string
(LEB128-style 6-bit chunks with sign folding).
"""
from __future__ import annotations

from typing import Dict, List, Union

import numpy as np


def mask_to_rle_counts(mask: np.ndarray) -> List[int]:
    """Binary [H, W] -> uncompressed counts (column-major, starts with 0s)."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    n = flat.size
    if n == 0:
        return [0]
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [n]])).tolist()
    if flat[0] == 1:  # counts must start with the zero-run
        runs = [0] + runs
    return [int(r) for r in runs]


def rle_counts_to_mask(counts: List[int], hw) -> np.ndarray:
    h, w = hw
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F").astype(bool)


def compress_counts(counts: List[int]) -> str:
    """pycocotools LEB128-style string encoding with delta for odd indices."""
    out = []
    for i, cnt in enumerate(counts):
        x = int(cnt)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def decompress_counts(s: str) -> List[int]:
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(int(x))
    return counts


def encode_mask(mask: np.ndarray) -> Dict:
    """Binary [H, W] -> {'size': [H, W], 'counts': str} (compressed RLE)."""
    h, w = mask.shape
    return {"size": [h, w], "counts": compress_counts(mask_to_rle_counts(mask))}


def decode_mask(rle: Dict) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = decompress_counts(counts)
    elif isinstance(counts, bytes):
        counts = decompress_counts(counts.decode())
    return rle_counts_to_mask(counts, rle["size"])


def rle_area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = decompress_counts(
            counts.decode() if isinstance(counts, bytes) else counts
        )
    return int(sum(counts[1::2]))


def polygon_to_mask(polygons: List[List[float]], hw) -> np.ndarray:
    """COCO polygon(s) -> binary mask, filled by cv2, imported here: where
    it is missing, reading a polygon segmentation raises an ImportError
    that names it (RLE segmentations need no cv2)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"reading the polygon segmentation {polygons!r:.80} needs cv2, "
            f"which is not installed (RLE segmentations do not)") from e

    h, w = hw
    mask = np.zeros((h, w), np.uint8)
    pts = [
        np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
        for p in polygons
        if len(p) >= 6
    ]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask.astype(bool)


def segmentation_to_mask(seg: Union[Dict, List, None], hw) -> np.ndarray:
    if seg is None:
        return np.zeros(hw, bool)
    if isinstance(seg, dict):
        return decode_mask(seg)
    return polygon_to_mask(seg, hw)
