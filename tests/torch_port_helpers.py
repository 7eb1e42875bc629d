"""Shared fixtures for the port's parity tests (`test_torch_*.py`).

Weights start as random state dicts in the public checkpoint namespaces
(`segment_anything` SAM, CoTracker v1), made with numpy from a seed. The
JAX side gets them through the JAX package's own converters; the port loads
them as they are or through `sam_pt_torch.utils.checkpoint`.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

TINY_COTRACKER = dict(s=4, stride=4, latent_dim=16, input_dim=456,
                      hidden_size=32, num_heads=2, space_depth=1,
                      time_depth=2)


def random_sam_state_dict(seed: int = 0, embed_dim: int = 32, depth: int = 2,
                          heads: int = 2, grid: int = 4, window: int = 2,
                          global_idx: Sequence[int] = (1,), pdim: int = 256,
                          std: float = 0.5) -> Dict[str, np.ndarray]:
    """A SAM state dict (numpy float32) with `segment_anything` keys."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    hd = embed_dim // heads

    def add(key, *shape, scale=std):
        sd[key] = (rng.standard_normal(shape) * scale).astype(np.float32)

    def add_ln(key, dim):
        sd[f"{key}.weight"] = (1.0 + 0.1 * rng.standard_normal(dim)).astype(
            np.float32)
        sd[f"{key}.bias"] = (0.1 * rng.standard_normal(dim)).astype(np.float32)

    def add_lin(key, out_dim, in_dim):
        add(f"{key}.weight", out_dim, in_dim, scale=in_dim ** -0.5)
        add(f"{key}.bias", out_dim, scale=0.1)

    enc = "image_encoder"
    add(f"{enc}.patch_embed.proj.weight", embed_dim, 3, 16, 16, scale=0.02)
    add(f"{enc}.patch_embed.proj.bias", embed_dim, scale=0.1)
    add(f"{enc}.pos_embed", 1, grid, grid, embed_dim, scale=0.1)
    for i in range(depth):
        b = f"{enc}.blocks.{i}"
        size = grid if i in global_idx else window
        add_ln(f"{b}.norm1", embed_dim)
        add_lin(f"{b}.attn.qkv", 3 * embed_dim, embed_dim)
        add_lin(f"{b}.attn.proj", embed_dim, embed_dim)
        add(f"{b}.attn.rel_pos_h", 2 * size - 1, hd, scale=0.1)
        add(f"{b}.attn.rel_pos_w", 2 * size - 1, hd, scale=0.1)
        add_ln(f"{b}.norm2", embed_dim)
        add_lin(f"{b}.mlp.lin1", 4 * embed_dim, embed_dim)
        add_lin(f"{b}.mlp.lin2", embed_dim, 4 * embed_dim)
    add(f"{enc}.neck.0.weight", pdim, embed_dim, 1, 1, scale=embed_dim ** -0.5)
    add_ln(f"{enc}.neck.1", pdim)
    add(f"{enc}.neck.2.weight", pdim, pdim, 3, 3, scale=(9 * pdim) ** -0.5)
    add_ln(f"{enc}.neck.3", pdim)

    pe = "prompt_encoder"
    add(f"{pe}.pe_layer.positional_encoding_gaussian_matrix", 2, pdim // 2,
        scale=1.0)
    for i in range(4):
        add(f"{pe}.point_embeddings.{i}.weight", 1, pdim)
    add(f"{pe}.not_a_point_embed.weight", 1, pdim)
    add(f"{pe}.no_mask_embed.weight", 1, pdim)
    md = f"{pe}.mask_downscaling"
    add(f"{md}.0.weight", 4, 1, 2, 2, scale=0.5)
    add(f"{md}.0.bias", 4, scale=0.1)
    add_ln(f"{md}.1", 4)
    add(f"{md}.3.weight", 16, 4, 2, 2, scale=0.25)
    add(f"{md}.3.bias", 16, scale=0.1)
    add_ln(f"{md}.4", 16)
    add(f"{md}.6.weight", pdim, 16, 1, 1, scale=0.25)
    add(f"{md}.6.bias", pdim, scale=0.1)

    tr = "mask_decoder.transformer"
    for i in range(2):
        layer = f"{tr}.layers.{i}"
        for name, dim in (("self_attn", pdim),
                          ("cross_attn_token_to_image", pdim // 2),
                          ("cross_attn_image_to_token", pdim // 2)):
            for proj in ("q_proj", "k_proj", "v_proj"):
                add_lin(f"{layer}.{name}.{proj}", dim, pdim)
            add_lin(f"{layer}.{name}.out_proj", pdim, dim)
        for j in range(1, 5):
            add_ln(f"{layer}.norm{j}", pdim)
        add_lin(f"{layer}.mlp.lin1", 2048, pdim)
        add_lin(f"{layer}.mlp.lin2", pdim, 2048)
    for proj in ("q_proj", "k_proj", "v_proj"):
        add_lin(f"{tr}.final_attn_token_to_image.{proj}", pdim // 2, pdim)
    add_lin(f"{tr}.final_attn_token_to_image.out_proj", pdim, pdim // 2)
    add_ln(f"{tr}.norm_final_attn", pdim)

    add("mask_decoder.iou_token.weight", 1, pdim)
    add("mask_decoder.mask_tokens.weight", 4, pdim)
    up = "mask_decoder.output_upscaling"
    add(f"{up}.0.weight", pdim, pdim // 4, 2, 2, scale=pdim ** -0.5)
    add(f"{up}.0.bias", pdim // 4, scale=0.1)
    add_ln(f"{up}.1", pdim // 4)
    add(f"{up}.3.weight", pdim // 4, pdim // 8, 2, 2, scale=(pdim // 4) ** -0.5)
    add(f"{up}.3.bias", pdim // 8, scale=0.1)
    for i in range(4):
        h = f"mask_decoder.output_hypernetworks_mlps.{i}"
        add_lin(f"{h}.layers.0", pdim, pdim)
        add_lin(f"{h}.layers.1", pdim, pdim)
        add_lin(f"{h}.layers.2", pdim // 8, pdim)
    for j, (o, i_) in enumerate(((256, pdim), (256, 256), (4, 256))):
        add_lin(f"mask_decoder.iou_prediction_head.layers.{j}", o, i_)
    return sd


def random_cotracker_state_dict(seed: int = 0, flow_head_scale: float = 1.0,
                                **cfg) -> Dict[str, np.ndarray]:
    """A CoTracker v1 state dict (numpy float32) for the given config,
    laid out by the port's own module. `flow_head_scale` shrinks the
    coordinate rows of the update head, so that random weights move points
    by small steps."""
    from sam_pt_torch.models.tracker.cotracker.model import CoTracker

    rng = np.random.default_rng(seed)
    model = CoTracker(**cfg)
    sd = {}
    for key, value in model.state_dict().items():
        if key.endswith("bias"):
            arr = rng.standard_normal(value.shape) * 0.1
        elif value.ndim == 1:  # LayerNorm scale
            arr = 1.0 + 0.1 * rng.standard_normal(value.shape)
        else:
            fan_in = int(np.prod(value.shape[1:]))
            arr = rng.standard_normal(value.shape) * fan_in ** -0.5
        if key.startswith("updateformer.flow_head."):
            arr[:2] = arr[:2] * flow_head_scale
        sd[key] = arr.astype(np.float32)
    return sd


def torch_sd(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
