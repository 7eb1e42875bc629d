"""Tensor (model) parallelism for the SAM ViT image encoder (counterpart of
`sam_pt_tpu/parallel/tensor_parallel.py`).

Data parallelism covers VOS/VIS throughput, but not the latency of one
frame, and the interactive path encodes one frame on the user's critical
path. Sharding the encoder over a `model` mesh axis of m ranks cuts each
block's work to 1/m per rank. Per ViT block (Megatron's layout):

  - `attn.qkv` keeps this rank's head block: the rows (3, H, D) ->
    (3, H/m, D) of its weight, so the local projection is exactly that
    slice of the full one; the attention then runs kernel K1 (windows,
    below 1024 tokens) or K2 (global) at H/m local heads;
  - `attn.proj` keeps its head-major column block: a row-parallel output
    projection, a partial product in float32 closed by one float32
    `psum` over the model group, then the bias, rounded once to the
    working dtype (the JAX sublayer's `preferred_element_type=float32`
    partial and its float32 `psum`);
  - `mlp.lin1` keeps its row block (column parallel: the GELU runs on the
    local hidden units) and `mlp.lin2` its column block (row parallel):
    the partial product rounded to the working dtype, one `psum` in that
    dtype, then the bias added in it. These are the rounding points of
    the JAX program, whose `mlp_lin2` is a bf16 `Dense` that GSPMD
    closes with a bf16 all-reduce; at bf16 the `psum` moves half the
    bytes of the attention's.

Two `psum`s a block; LayerNorms, rel-pos tables (shared by the heads),
the patch embedding, the neck and the prompt encoder and mask decoder are
replicated. Unlike the JAX package, which falls back to an XLA path where
the local head count misaligns with the TPU kernels' lane tiling, K1 and
K2 take any head count at head dims 16-128, so every block takes this
route. Numerics against the unsharded encoder: the same products, the
output projections' sums in another order, and at bf16 the MLP's
partials rounded before they are summed.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .comm import group_size, psum
from .mesh import Mesh, create_mesh


def create_tp_mesh(n_model: int, n_data: Optional[int] = None,
                   axis_names=("data", "model")) -> Mesh:
    """A 2-D (data x model) mesh of the world's ranks, the model axis the
    faster-varying one (neighbouring ranks share a model group). `n_data`
    defaults to the world over `n_model`; every rank must be in the mesh."""
    world = group_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_data * n_model > world:
        raise ValueError(
            f"mesh {n_data or '?'}x{n_model} (data x model) needs "
            f"{max(n_model, (n_data or 0) * n_model)} devices, but only "
            f"{world} are available")
    return create_mesh(axis_names, (n_data, n_model))


def tp_shardmap_attention(x: torch.Tensor, attn: nn.Module, hw,
                          cropped: bool = False) -> torch.Tensor:
    """The head-sharded attention sublayer of one rank: x [B, N, C] ->
    the local qkv projection [B, N, 3 * H/m * D], the attention at H/m
    local heads (`attn.attend`: K2 from 1024 tokens, K1 for windows), the
    row-parallel output projection: the local heads' outputs times the
    local weight block in float32 (the products of the working dtype's
    values, summed in float32), one float32 `psum`, then the bias,
    rounded once to the working dtype."""
    out = attn.attend(attn.qkv(x), hw, cropped)
    part = F.linear(out.float(), attn.proj.weight.float())
    return (psum(part, attn.tp_group) + attn.proj.bias.float()).to(out.dtype)


def tp_mlp(x: torch.Tensor, mlp: nn.Module) -> torch.Tensor:
    """The MLP of one rank: column-parallel `lin1` and the GELU on the
    local hidden units, then row-parallel `lin2`: the local product in
    the working dtype, one `psum` in that dtype, then the bias added in
    it (three roundings at bf16, as the JAX program has them)."""
    part = F.linear(mlp.activation(mlp.lin1(x)), mlp.lin2.weight)
    return psum(part, mlp.tp_group) + mlp.lin2.bias


def _keep_rows(linear: nn.Linear, rows: torch.Tensor) -> None:
    """Keep the output rows `rows` (an index tensor) of `linear`."""
    linear.weight = nn.Parameter(linear.weight.detach()[rows].clone(),
                                 requires_grad=False)
    linear.bias = nn.Parameter(linear.bias.detach()[rows].clone(),
                               requires_grad=False)
    linear.out_features = linear.weight.shape[0]


def _keep_columns(linear: nn.Linear, start: int, stop: int) -> None:
    """Keep the input columns [start, stop) of `linear` (the bias is
    added once, after the `psum`)."""
    linear.weight = nn.Parameter(
        linear.weight.detach()[:, start:stop].clone(), requires_grad=False)
    linear.in_features = stop - start


def shard_params_tp(model: nn.Module, mesh: Mesh,
                    axis: str = "model") -> nn.Module:
    """Shard a Sam's (or a bare `ImageEncoderViT`'s) encoder blocks over
    mesh axis `axis`, in place: each rank keeps its head block of every
    `attn.qkv` and `attn.proj` and its hidden block of every `mlp`, and
    the blocks take the tensor-parallel route. Everything else stays
    replicated. Returns the model."""
    encoder = getattr(model, "image_encoder", model)
    if not hasattr(encoder, "blocks") or not hasattr(encoder, "neck"):
        raise ValueError(f"tensor parallelism takes a ViT encoder, not "
                         f"{type(encoder).__name__}")
    m, i = mesh.axis_size(axis), mesh.axis_index(axis)
    group = mesh.group(axis)
    if getattr(encoder, "tp_size", 1) != 1:
        raise ValueError("the encoder is sharded already")
    for block in encoder.blocks:
        attn, mlp = block.attn, block.mlp
        heads, d = attn.num_heads, attn.head_dim
        hidden = mlp.lin1.out_features
        if heads % m or hidden % m:
            raise ValueError(f"{heads} heads and {hidden} hidden units do "
                             f"not split over {m} ranks")
        hl = heads // m
        device = attn.qkv.weight.device
        rows = torch.arange(3 * heads * d, device=device).reshape(
            3, heads, d)[:, i * hl:(i + 1) * hl].reshape(-1)
        _keep_rows(attn.qkv, rows)
        _keep_columns(attn.proj, i * hl * d, (i + 1) * hl * d)
        attn.num_heads = hl
        hl_mlp = hidden // m
        _keep_rows(mlp.lin1, torch.arange(i * hl_mlp, (i + 1) * hl_mlp,
                                          device=device))
        _keep_columns(mlp.lin2, i * hl_mlp, (i + 1) * hl_mlp)
        for module in (attn, mlp):
            module.tp_size, module.tp_group = m, group
    encoder.tp_size = m
    return model
