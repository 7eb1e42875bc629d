"""A SAM predictor from a model configuration's keys
(counterpart of `sam_pt_tpu/models/sam/factory.py`; the keys of
`configs/model/sam/*.yaml`: SAM ViT-B/L/H, HQ-SAM, MobileSAM and Light
HQ-SAM), plus the device it runs on."""
from __future__ import annotations

from typing import Optional, Union

import torch

from ...utils.checkpoint import load_or_randomize_
from ..batch_norm import reset_batch_norm_stats_
from .image_encoder import VIT_VARIANTS
from .predictor import SamPredictor
from .sam_model import Sam

DTYPES = {"float32": torch.float32, "f32": torch.float32,
          "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def build_predictor(variant: str = "vit_b", checkpoint: Optional[str] = None,
                    dtype: str = "bfloat16", image_size: int = 1024,
                    allow_random_init: bool = False, hq: bool = False,
                    hq_token_only: bool = False, seed: int = 0,
                    crop_pad_tokens: bool = False, mesh=None,
                    tp_axis: Optional[str] = None,
                    dp_axis: Optional[str] = None,
                    device: Union[str, torch.device] = "cuda"
                    ) -> SamPredictor:
    """A SamPredictor for a ViT variant (`vit_b`, `vit_l`, `vit_h`) or
    MobileSAM's TinyViT (`vit_t`), with HQ-SAM's decoder if `hq`, in
    `dtype` on `device`: the public checkpoint loaded as it is (`segment_anything`, `segment_anything_hq`,
    MobileSAM, or a HuggingFace `transformers` SAM file, converted), or,
    where the file is missing and `allow_random_init` is set, N(0, 0.02^2)
    weights from a generator on `device` seeded with `seed` (BatchNorm
    statistics at mean 0, variance 1). A missing file raises
    FileNotFoundError otherwise. `crop_pad_tokens` runs a ViT encoder on
    the tokens that cover the frame only (opt-in; it deviates from the
    reference). With a `mesh` (`parallel.mesh.Mesh`), the predictor splits
    its batches over the mesh's `data` axis or, with `tp_axis`, shards
    the encoder over that axis and splits frames over `dp_axis`, if given
    (`SamPredictor`); every rank builds the same weights."""
    if variant != "vit_t" and variant not in VIT_VARIANTS:
        raise ValueError(f"unknown SAM variant {variant!r}")
    model = Sam(variant, image_size=image_size,
                crop_pad_tokens=crop_pad_tokens, use_hq=hq,
                hq_token_only=hq_token_only, tp_axis=tp_axis,
                dp_axis=dp_axis)
    if not load_or_randomize_(model, checkpoint,
                              allow_random_init=allow_random_init, seed=seed,
                              device=device):
        reset_batch_norm_stats_(model)
    return SamPredictor(model.to(DTYPES[dtype]).eval().requires_grad_(False),
                        mesh=mesh)
