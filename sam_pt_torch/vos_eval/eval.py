"""Device-side fusion of per-object logits into uint8 index masks
(counterpart of `_fuse_chunk_jit`, `PendingIndexMasks` and
`device_fuse_index_masks` in `sam_pt_tpu/vos_eval/eval.py`).

Masks are suppressed before their query frame, overwritten with the ground
truth at it, and fused by argmax against a zero background channel (argmax
of the softmax == argmax of the logits). With <= 15 objects the index mask
is nibble-packed along W on the device, two pixels per byte.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

_BIG = 60000.0  # float16-representable stand-in for +-inf


def fuse_chunk(chunk_logits: torch.Tensor, frame_ids: torch.Tensor,
               gt: torch.Tensor, ts: torch.Tensor,
               pack: bool) -> torch.Tensor:
    """chunk_logits [M, F, h, w] float16, frame_ids [F], gt [M, h, w] bool,
    ts [M] -> index masks [F, h, w] uint8 (or [F, h, ceil(w/2)] packed)."""
    big = torch.tensor(_BIG, dtype=torch.float16, device=chunk_logits.device)
    x = chunk_logits.to(torch.float16)
    before = frame_ids[None, :] < ts[:, None]  # [M, F]
    x = torch.where(before[..., None, None], -big, x)
    at_query = frame_ids[None, :] == ts[:, None]
    gt_val = torch.where(gt[:, None], big, -big)  # [M, 1, h, w]
    x = torch.where(at_query[..., None, None], gt_val, x)
    stacked = torch.cat([torch.zeros_like(x[:1]), x], dim=0)
    idx = torch.argmax(stacked, dim=0).to(torch.uint8)  # [F, h, w]
    if pack:
        if idx.shape[-1] % 2:
            idx = torch.nn.functional.pad(idx, (0, 1))
        return idx[..., 0::2] | (idx[..., 1::2] << 4)
    return idx


class PendingIndexMasks:
    """Fused index masks on the device whose download is deferred.

    `get()` starts every chunk's copy into pinned host memory without
    blocking, waits once, and assembles the [T, h, w] uint8 array."""

    def __init__(self, chunks: List[Tuple[torch.Tensor, int, int]], t: int,
                 h: int, w: int, packed: bool = False):
        self._chunks = chunks
        self._t, self._h, self._w = t, h, w
        self._packed = packed

    def get(self) -> np.ndarray:
        hosts = []
        for masks, i, end in self._chunks:
            host = torch.empty(masks.shape, dtype=masks.dtype,
                               pin_memory=masks.is_cuda)
            host.copy_(masks, non_blocking=True)
            hosts.append((host, i, end))
        if any(m.is_cuda for m, _, _ in self._chunks):
            torch.cuda.current_stream(self._chunks[0][0].device).synchronize()
        out = np.zeros((self._t, self._h, self._w), np.uint8)
        for host, i, end in hosts:
            got = host.numpy()[: end - i]
            if self._packed:
                unpacked = np.empty(
                    (got.shape[0], got.shape[1], 2 * got.shape[2]), np.uint8)
                unpacked[..., 0::2] = got & 0x0F
                unpacked[..., 1::2] = got >> 4
                got = unpacked[..., : self._w]
            out[i:end] = got
        self._chunks = []
        return out


def device_fuse_index_masks(logits_dev: torch.Tensor, gt_masks: np.ndarray,
                            gt_ts, frame_chunk: int = 16,
                            defer: bool = False):
    """logits_dev [M, T, h, w] (device), gt_masks [M, h, w], gt_ts [M] ->
    [T, h, w] uint8 index masks (or a `PendingIndexMasks` with defer)."""
    m, t, h, w = logits_dev.shape
    device = logits_dev.device
    gt = torch.as_tensor(np.asarray(gt_masks) > 0.5, device=device)
    ts = torch.as_tensor(np.asarray(gt_ts, np.int64), device=device)
    pack = m <= 15
    chunks = []
    for i in range(0, t, frame_chunk):
        end = min(i + frame_chunk, t)
        ids = np.concatenate([np.arange(i, end),
                              np.full(frame_chunk - (end - i), i)])
        ids = torch.as_tensor(ids, device=device)
        chunks.append((fuse_chunk(logits_dev[:, ids], ids, gt, ts, pack),
                       i, end))
    pending = PendingIndexMasks(chunks, t, h, w, packed=pack)
    return pending if defer else pending.get()
