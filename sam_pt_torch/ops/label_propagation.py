"""DINO-style label propagation, semi-supervised VOS by feature affinity
(counterpart of `sam_pt_tpu/ops/label_propagation.py`): the frame
preparation for a DINO ViT (on the host, cv2's resize), the local window
of query-key pairs, top-k affinity propagation of context-frame labels,
and per-channel mask normalisation, on the tensors' device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.228, 0.224, 0.225], np.float32)


def prep_frame_for_dino(
    img: np.ndarray, scale_size: Sequence[int] = (192,)
) -> Tuple[np.ndarray, int, int]:
    """RGB uint8 [H, W, 3] -> (normalised CHW float32, ori_h, ori_w): the
    short side resized to scale_size[0] with the long side snapped down to
    a multiple of 64 (or to an explicit (th, tw)), scaled to [0, 1],
    flipped to BGR, ImageNet-normalised."""
    import cv2

    ori_h, ori_w, _ = img.shape
    if len(scale_size) == 1:
        if ori_h > ori_w:
            tw = scale_size[0]
            th = int(((tw * ori_h) / ori_w) // 64 * 64)
        else:
            th = scale_size[0]
            tw = int(((th * ori_w) / ori_h) // 64 * 64)
    else:
        th, tw = scale_size
    out = cv2.resize(img, (tw, th)).astype(np.float32) / 255.0
    out = out[:, :, ::-1]  # the frames are fed BGR-flipped
    out = (out - IMAGENET_MEAN) / IMAGENET_STD
    return np.transpose(out, (2, 0, 1)).copy(), ori_h, ori_w


def restrict_neighborhood(h: int, w: int, size: int = 12,
                          device: Union[str, torch.device] = "cuda"
                          ) -> torch.Tensor:
    """[h*w, h*w] float32 0/1 mask of the query-key pairs within a
    (2*size+1)^2 window."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    mask = (((ys[:, None] - ys[None, :]).abs() <= size)
            & ((xs[:, None] - xs[None, :]).abs() <= size))
    return mask.float()


def label_propagation(
    h: int,
    w: int,
    feat_tar: torch.Tensor,
    list_frame_feats: List[torch.Tensor],
    list_segs: List[torch.Tensor],
    mask_neighborhood: Optional[torch.Tensor] = None,
    topk: int = 5,
    temperature: float = 0.1,
    neighborhood_size: int = 12,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Propagate the context frames' labels to the target frame.

    feat_tar [h*w, dim] target features; list_frame_feats: n context frames
    of [dim, h*w]; list_segs: n label maps of [1, C, h, w]. Returns
    ([1, C, h, w] propagated labels, the neighbourhood mask for reuse).
    A source node is kept for a target where its affinity is at least the
    target's k-th largest; the kept affinities are renormalised.
    """
    n = len(list_frame_feats)
    feat_sources = torch.stack(list_frame_feats)  # [n, dim, hw]

    def l2norm(x, dim):
        return x / x.norm(dim=dim, keepdim=True).clamp(min=1e-12)

    ft = l2norm(feat_tar, 1)
    fs = l2norm(feat_sources, 1)
    aff = torch.exp(torch.einsum("qd,ndk->nqk", ft, fs) / temperature)

    if neighborhood_size > 0:
        if mask_neighborhood is None:
            mask_neighborhood = restrict_neighborhood(
                h, w, neighborhood_size, device=aff.device)
        aff = aff * mask_neighborhood[None]

    # [n*hw_src, hw_tar]: the top-k source nodes per target, renormalised
    aff = aff.transpose(1, 2).reshape(-1, h * w)
    kth = aff.topk(topk, dim=0).values[-1:]  # k-th largest per column
    aff = torch.where(aff < kth, torch.zeros_like(aff), aff)
    aff = aff / aff.sum(dim=0, keepdim=True)

    segs = torch.cat(list_segs)  # [n, C, h, w]
    c = segs.shape[1]
    segs = segs.reshape(n, c, h * w).transpose(1, 2).reshape(-1, c).T
    return (segs @ aff).reshape(1, c, h, w), mask_neighborhood


def norm_mask(mask: torch.Tensor) -> torch.Tensor:
    """Min-max normalise each channel of [C, ...] whose maximum is
    positive; the others are left as they are."""
    c = mask.shape[0]
    flat = mask.reshape(c, -1)
    mx = flat.amax(dim=1, keepdim=True)
    mn = flat.amin(dim=1, keepdim=True)
    normed = (flat - mn) / (mx - mn).clamp(min=1e-12)
    return torch.where(mx > 0, normed, flat).reshape(mask.shape)
