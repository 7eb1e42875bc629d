"""Batched SAM predictor (counterpart of `sam_pt_tpu/models/sam/predictor.py`).

`encode_frames` embeds a batch of frames (the antialiased longest-side
resize runs on the device); `decode` decodes a batch of (embedding,
prompt-set) pairs with label -1 padding, in model-input coordinates;
`predict` does the same from original image pixels and picks SAM's single
or multimask output tokens. `scale_coords` maps original pixels to
model-input coordinates. `decode` and `predict` take decode-ready
embeddings: a plain SAM model's tensor as `encode_frames` gives it, or
with HQ-SAM {'emb', 'hq'}, made once a frame from the encoder's
{'emb', 'interm'} (`Sam.encode_images`) by `decode_ready`; its
`hq_features` is the one place the decoder's image-level features are
computed.

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
from ...utils.tree import leading_size, pad_last, tree_map
from .sam_model import Sam


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
        b = leading_size(batch[0])
        n = -(-b // self._batch.size) * self._batch.size
        local = [None if x is None else self._batch.shard(pad_last(x, n))
                 for x in batch]
        out = fn(*local)

        def whole(o):
            return tree_map(lambda a: a[:b], self._batch.gather(o))

        return tuple(map(whole, out)) if isinstance(out, tuple) else whole(out)

    @torch.no_grad()
    def encode_frames(self, images: torch.Tensor,
                      original_hw: Tuple[int, int], graphs=None):
        """images [B, H, W, 3] uint8/float RGB at original resolution, on
        the model's device -> embeddings [B, g, g, 256] (with HQ-SAM, the
        dict of `Sam.encode_images`).

        `graphs` (an `EncodeGraphs`, for a caller that encodes batches of
        one shape again and again): on CUDA and off a mesh the batch is the
        replay of a graph captured at its first call, and the results are
        the graph's static outputs, good until its next replay. A predictor
        on a mesh (and so a tensor-parallel encoder) encodes eagerly."""
        model = self.model
        target_hw = get_longest_side_target_hw(
            original_hw[0], original_hw[1], model.image_size)
        def encode(frames):
            return model.encode_images(resize_bilinear(
                frames.float(), target_hw, antialias=self.antialias))

        if graphs is not None and self.mesh is None:
            return graphs(encode, images, (
                model, model.dtype, model.crop_pad_tokens, model.use_hq,
                target_hw, self.antialias))
        return self._sharded(encode, images)

    @torch.no_grad()
    def hq_features(self, embeddings: dict) -> torch.Tensor:
        """HQ-SAM's {'emb', 'interm'} embeddings [B, ...] -> the decoder's
        image-level features [B, 4g, 4g, 32]
        (`MaskDecoderHQ.image_features`), which `decode` reads from
        {'emb', 'hq': these}: the only place they are made."""
        model = self.model

        def features(emb):
            return model.mask_decoder.image_features(
                emb["emb"].to(model.dtype), emb["interm"])

        return self._sharded(features, embeddings)

    def decode_ready(self, embeddings):
        """`encode_frames`'s embeddings as `decode` takes them: a plain
        SAM's as they are, HQ-SAM's {'emb', 'interm'} as {'emb', 'hq'}
        (`hq_features`). Take it once a frame, not once a decode."""
        if not self.model.use_hq:
            return embeddings
        return {"emb": embeddings["emb"], "hq": self.hq_features(embeddings)}

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
        """Decode-ready embeddings (`decode_ready`) and model-space prompts
        -> (logits [B, T, 4g, 4g], iou [B, 4]), as `Sam.decode_masks`.
        Each call counts one of the open span's decoder `passes`."""
        tracing.count("passes")

        def decode(emb, pts, lbl, mask, valid):
            return self.model.decode_masks(emb, pts, lbl, mask, valid,
                                           only_token0=only_token0)

        return self._sharded(decode, embeddings, points, labels, mask_input,
                             mask_valid)

    @torch.no_grad()
    def predict(self, embeddings, points, labels,
                original_hw: Tuple[int, int],
                mask_input: Optional[torch.Tensor] = None,
                mask_valid: Optional[torch.Tensor] = None,
                multimask_output: bool = False):
        """Batched predict from original-pixel prompts: decode-ready
        embeddings [B, ...] (`decode_ready`), points [B, N, 2] (x, y),
        labels [B, N] (-1 = pad).
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

