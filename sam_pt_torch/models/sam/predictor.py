"""Batched SAM predictor (counterpart of `sam_pt_tpu/models/sam/predictor.py`).

`encode_frames` embeds a batch of frames (the antialiased longest-side
resize runs on the device); `decode` decodes a batch of (embedding,
prompt-set) pairs with label -1 padding, in model-input coordinates;
`predict` does the same from original image pixels and picks SAM's single
or multimask output tokens. `scale_coords` maps original pixels to
model-input coordinates. With an HQ-SAM model the embeddings are
{'emb', 'interm'} dicts (`Sam.encode_images`), passed on as they are;
`hq_features` gives the decoder's image-level features of such a dict,
which `decode` takes as {'emb', 'hq'}.

With a `mesh` (`parallel.mesh.Mesh`, every rank running the same calls),
`encode_frames` and `decode` take this rank's slice of the batch along
the mesh's `data` axis and gather the results, so that every rank holds
the whole batch, as the JAX predictor's output shardings imply; a batch
that does not split evenly is padded with copies of its last item. With
a model whose `tp_axis` is set, the encoder is sharded over that axis
(`parallel/tensor_parallel.py`) and the batch split over the model's
`dp_axis`, if any.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...ops.resize import (
    get_longest_side_target_hw,
    resize_bilinear,
    resize_planes,
)
from ...parallel.mesh import batch_sharding, check_mesh
from ...parallel.tensor_parallel import shard_params_tp
from ...utils import tracing
from .sam_model import Sam


def _pad_batch(x, n: int):
    """x's leading axis padded to `n` with copies of its last item (a
    tensor, a dict of them, or None)."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _pad_batch(v, n) for k, v in x.items()}
    pad = n - x.shape[0]
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x


def _crop_tree(x, crop):
    if isinstance(x, dict):
        return {k: crop(v) for k, v in x.items()}
    return crop(x)


class SamPredictor:
    def __init__(self, model: Sam, *, antialias: bool = True, mesh=None):
        self.model = model
        self.antialias = antialias
        self.mesh = mesh
        self._batch = None  # the batch's sharding over the mesh
        check_mesh(mesh)
        if mesh is None:
            return
        tp_axis = getattr(model, "tp_axis", None)
        if tp_axis is not None:
            if tp_axis not in mesh.axis_names:
                raise ValueError(f"model.tp_axis={tp_axis!r} not in mesh "
                                 f"axes {mesh.axis_names}")
            shard_params_tp(model, mesh, tp_axis)
            batch_axis = model.dp_axis
        else:
            batch_axis = "data"
        if batch_axis is not None:
            self._batch = batch_sharding(mesh, batch_axis)

    def _sharded(self, fn, *batch):
        """`fn` over this rank's slice of the batch arguments (padded to a
        multiple of the data axis first), the results gathered and the
        padding cropped; `fn(*batch)` without a data axis."""
        if self._batch is None:
            return fn(*batch)
        first = batch[0]["emb"] if isinstance(batch[0], dict) else batch[0]
        b = first.shape[0]
        n = -(-b // self._batch.size) * self._batch.size
        local = [None if x is None else self._batch.shard(_pad_batch(x, n))
                 for x in batch]
        out = fn(*local)
        crop = (lambda a: a[:b]) if n != b else (lambda a: a)
        if isinstance(out, tuple):
            return tuple(_crop_tree(self._batch.gather(o), crop) for o in out)
        return _crop_tree(self._batch.gather(out), crop)

    @torch.no_grad()
    def encode_frames(self, images: torch.Tensor,
                      original_hw: Tuple[int, int]):
        """images [B, H, W, 3] uint8/float RGB at original resolution, on
        the model's device -> embeddings [B, g, g, 256] (with HQ-SAM, the
        dict of `Sam.encode_images`)."""
        target_hw = get_longest_side_target_hw(
            original_hw[0], original_hw[1], self.model.image_size)
        def encode(frames):
            return self.model.encode_images(resize_bilinear(
                frames.float(), target_hw, antialias=self.antialias))

        return self._sharded(encode, images)

    @torch.no_grad()
    def hq_features(self, embeddings: dict) -> torch.Tensor:
        """HQ-SAM's {'emb', 'interm'} embeddings [B, ...] -> the decoder's
        image-level features [B, 4g, 4g, 32]
        (`MaskDecoderHQ.image_features`), which `decode` reads from
        {'emb', 'hq': these} without recomputing them."""
        model = self.model

        def features(emb):
            return model.mask_decoder.image_features(
                emb["emb"].to(model.dtype), emb["interm"])

        return self._sharded(features, embeddings)

    def scale_coords(self, coords: torch.Tensor,
                     original_hw: Tuple[int, int]) -> torch.Tensor:
        """Original-pixel (x, y) -> model-input coordinates."""
        th, tw = get_longest_side_target_hw(
            original_hw[0], original_hw[1], self.model.image_size)
        scale = torch.tensor([tw / original_hw[1], th / original_hw[0]],
                             dtype=torch.float32, device=coords.device)
        return coords * scale

    @torch.no_grad()
    def decode(self, embeddings, points: torch.Tensor,
               labels: torch.Tensor, mask_input: Optional[torch.Tensor] = None,
               mask_valid: Optional[torch.Tensor] = None,
               only_token0: bool = False):
        """Model-space prompts -> (logits [B, T, 4g, 4g], iou [B, 4]); an
        HQ-SAM model decodes every token (its token 0 reads the HQ one).
        Each call counts one of the open span's decoder `passes`."""
        tracing.count("passes")

        def decode(emb, pts, lbl, mask, valid):
            return self.model.decode_masks(
                emb, pts, lbl, mask, valid,
                only_token0=only_token0 and not self.model.use_hq)

        return self._sharded(decode, embeddings, points, labels, mask_input,
                             mask_valid)

    @torch.no_grad()
    def predict(self, embeddings, points, labels,
                original_hw: Tuple[int, int],
                mask_input: Optional[torch.Tensor] = None,
                mask_valid: Optional[torch.Tensor] = None,
                multimask_output: bool = False):
        """Batched predict from original-pixel prompts: embeddings
        [B, g, g, 256], points [B, N, 2] (x, y), labels [B, N] (-1 = pad).
        Returns (low-res logits [B, K, 4g, 4g], iou [B, K], the token
        slice) with K = 3 (tokens 1-3) if `multimask_output`, else 1
        (token 0)."""
        device = self.model.device
        pts = self.scale_coords(
            torch.as_tensor(points, dtype=torch.float32, device=device),
            original_hw)
        lbl = torch.as_tensor(labels, device=device).long()
        masks, iou = self.decode(embeddings, pts, lbl, mask_input, mask_valid)
        tokens = slice(1, 4) if multimask_output else slice(0, 1)
        return masks[:, tokens], iou[:, tokens], tokens

    def upscale_logits(self, low_res_logits: torch.Tensor,
                       original_hw: Tuple[int, int]) -> torch.Tensor:
        """[..., 4g, 4g] -> [..., H, W]: bilinear to the model size, crop
        the padding, bilinear to the original size."""
        th, tw = get_longest_side_target_hw(
            original_hw[0], original_hw[1], self.model.image_size)
        size = self.model.image_size
        x = resize_planes(low_res_logits, (size, size), crop_hw=(th, tw))
        return resize_planes(x, original_hw)

