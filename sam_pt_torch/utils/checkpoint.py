"""Carry weights from the JAX package's parameter trees to the port.

The port's modules use the public checkpoint names (`segment_anything` for
SAM, CoTracker v1 for the tracker), so a real checkpoint loads into them
with `load_state_dict` as it is. The SAM and CoTracker functions are the
inverses of
`convert_sam_state_dict` and `convert_cotracker_state_dict` in
`sam_pt_tpu/utils/checkpoint.py`: they take a JAX parameter tree (nested
dicts of arrays, with or without the top-level "params") and return the
port's float32 state dict.

Layouts: Dense kernel [in, out] -> Linear weight [out, in]; Conv kernel
[kh, kw, in, out] -> Conv2d weight [out, in, kh, kw]; the JAX package's
ConvTranspose kernel is stored spatially flipped, [kh, kw, in, out] ->
ConvTranspose2d weight [in, out, kh, kw] un-flipped.
"""
from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(_np(x)))


def _root(params: Dict[str, Any]) -> Dict[str, Any]:
    return params["params"] if "params" in params else params


def _strip_head_pad(qkv_w, qkv_b, proj_w, rel_h, rel_w, head_dim: int):
    """Undo the JAX converter's head-dim padding (80 -> 128 at ViT-H) of a
    global block. Raises if a pad lane holds anything but zeros."""
    c = qkv_w.shape[0]
    hdp = rel_h.shape[-1]
    heads = qkv_w.shape[1] // (3 * hdp)
    w = qkv_w.reshape(c, 3, heads, hdp)
    b = qkv_b.reshape(3, heads, hdp)
    pw = proj_w.reshape(heads, hdp, -1)
    pads = (w[..., head_dim:], b[..., head_dim:], pw[:, head_dim:],
            rel_h[:, head_dim:], rel_w[:, head_dim:])
    if any(np.any(p != 0) for p in pads):
        raise ValueError(
            "head-dim pad lanes are not zero: this tree was not produced "
            "by convert_sam_state_dict and cannot be converted")
    return (w[..., :head_dim].reshape(c, 3 * heads * head_dim),
            b[..., :head_dim].reshape(-1),
            pw[:, :head_dim].reshape(heads * head_dim, -1),
            rel_h[:, :head_dim], rel_w[:, :head_dim])


def attention_state_dict_from_jax(attn: Dict[str, Any], head_dim: int,
                                  prefix: str = ""
                                  ) -> Dict[str, torch.Tensor]:
    """One JAX `Attention`'s params (`qkv`, `proj`, `rel_pos_h`,
    `rel_pos_w`; with or without the top-level "params") -> the port
    `Attention`'s state dict, the head-dim pad stripped where the rel-pos
    width is not `head_dim`."""
    attn = _root(attn)
    qkv_w, qkv_b = _np(attn["qkv"]["kernel"]), _np(attn["qkv"]["bias"])
    proj_w = _np(attn["proj"]["kernel"])
    rel_h, rel_w = _np(attn["rel_pos_h"]), _np(attn["rel_pos_w"])
    if rel_h.shape[-1] != head_dim:
        qkv_w, qkv_b, proj_w, rel_h, rel_w = _strip_head_pad(
            qkv_w, qkv_b, proj_w, rel_h, rel_w, head_dim)
    return {
        f"{prefix}qkv.weight": _t(qkv_w.T),
        f"{prefix}qkv.bias": _t(qkv_b),
        f"{prefix}proj.weight": _t(proj_w.T),
        f"{prefix}proj.bias": _t(attn["proj"]["bias"]),
        f"{prefix}rel_pos_h": _t(rel_h),
        f"{prefix}rel_pos_w": _t(rel_w),
    }


def vit_encoder_state_dict_from_jax(enc: Dict[str, Any],
                                    prefix: str = "image_encoder."
                                    ) -> Dict[str, torch.Tensor]:
    """JAX ImageEncoderViT tree -> `image_encoder.*` state dict. The head
    dim is the smallest rel-pos width over the blocks (window blocks are
    never padded)."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(dst, node, bias=True):
        sd[f"{prefix}{dst}.weight"] = _t(_np(node["kernel"]).transpose(3, 2, 0, 1))
        if bias:
            sd[f"{prefix}{dst}.bias"] = _t(node["bias"])

    conv("patch_embed.proj", enc["patch_embed"])
    if "pos_embed" in enc:
        sd[f"{prefix}pos_embed"] = _t(enc["pos_embed"])
    depth = 1 + max(int(m.group(1)) for k in enc
                    if (m := re.match(r"blocks_(\d+)$", k)))
    head_dim = min(_np(enc[f"blocks_{i}"]["attn"]["rel_pos_h"]).shape[-1]
                   for i in range(depth))
    for i in range(depth):
        blk = enc[f"blocks_{i}"]
        dst = f"{prefix}blocks.{i}"
        sd[f"{dst}.norm1.weight"] = _t(blk["norm1"]["scale"])
        sd[f"{dst}.norm1.bias"] = _t(blk["norm1"]["bias"])
        sd.update(attention_state_dict_from_jax(blk["attn"], head_dim,
                                                prefix=f"{dst}.attn."))
        sd[f"{dst}.norm2.weight"] = _t(blk["norm2"]["scale"])
        sd[f"{dst}.norm2.bias"] = _t(blk["norm2"]["bias"])
        for name in ("lin1", "lin2"):
            sd[f"{dst}.mlp.{name}.weight"] = _t(_np(blk[f"mlp_{name}"]["kernel"]).T)
            sd[f"{dst}.mlp.{name}.bias"] = _t(blk[f"mlp_{name}"]["bias"])
    conv("neck.0", enc["neck_conv1"], bias=False)
    conv("neck.2", enc["neck_conv2"], bias=False)
    for j, name in ((1, "neck_ln1"), (3, "neck_ln2")):
        sd[f"{prefix}neck.{j}.weight"] = _t(enc[name]["weight"])
        sd[f"{prefix}neck.{j}.bias"] = _t(enc[name]["bias"])
    return sd


def sam_state_dict_from_jax(params: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """JAX `Sam` parameter tree -> the port's (= segment_anything's) SAM
    state dict, without the head-dim pad of the global blocks."""
    p = _root(params)
    sd = vit_encoder_state_dict_from_jax(p["image_encoder"])

    def lin(dst, node):
        sd[f"{dst}.weight"] = _t(_np(node["kernel"]).T)
        sd[f"{dst}.bias"] = _t(node["bias"])

    def conv(dst, node):
        sd[f"{dst}.weight"] = _t(_np(node["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{dst}.bias"] = _t(node["bias"])

    def convt(dst, node):
        k = _np(node["kernel"])[::-1, ::-1]
        sd[f"{dst}.weight"] = _t(k.transpose(2, 3, 0, 1))
        sd[f"{dst}.bias"] = _t(node["bias"])

    def norm(dst, node, scale="scale"):
        sd[f"{dst}.weight"] = _t(node[scale])
        sd[f"{dst}.bias"] = _t(node["bias"])

    pe = p["prompt_encoder"]
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = _t(
        pe["pe_layer"]["gaussian_matrix"])
    for i in range(4):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = _t(
            pe[f"point_embed_{i}"])[None]
    sd["prompt_encoder.not_a_point_embed.weight"] = _t(
        pe["not_a_point_embed"])[None]
    sd["prompt_encoder.no_mask_embed.weight"] = _t(pe["no_mask_embed"])[None]
    md = "prompt_encoder.mask_downscaling"
    conv(f"{md}.0", pe["mask_conv1"])
    norm(f"{md}.1", pe["mask_ln1"], "weight")
    conv(f"{md}.3", pe["mask_conv2"])
    norm(f"{md}.4", pe["mask_ln2"], "weight")
    conv(f"{md}.6", pe["mask_conv3"])

    dec = p["mask_decoder"]
    tr = dec["transformer"]
    attns = ("q_proj", "k_proj", "v_proj", "out_proj")
    for i in range(2):
        src = tr[f"layers_{i}"]
        dst = f"mask_decoder.transformer.layers.{i}"
        for a in ("self_attn", "cross_attn_token_to_image",
                  "cross_attn_image_to_token"):
            for name in attns:
                lin(f"{dst}.{a}.{name}", src[a][name])
        for j in range(1, 5):
            norm(f"{dst}.norm{j}", src[f"norm{j}"])
        lin(f"{dst}.mlp.lin1", src["mlp"]["lin1"])
        lin(f"{dst}.mlp.lin2", src["mlp"]["lin2"])
    for name in attns:
        lin(f"mask_decoder.transformer.final_attn_token_to_image.{name}",
            tr["final_attn_token_to_image"][name])
    norm("mask_decoder.transformer.norm_final_attn", tr["norm_final_attn"])
    sd["mask_decoder.iou_token.weight"] = _t(dec["iou_token"])
    sd["mask_decoder.mask_tokens.weight"] = _t(dec["mask_tokens"])
    convt("mask_decoder.output_upscaling.0", dec["upscale_conv1"])
    norm("mask_decoder.output_upscaling.1", dec["upscale_ln"], "weight")
    convt("mask_decoder.output_upscaling.3", dec["upscale_conv2"])
    n_hyper = 1 + max(int(m.group(1)) for k in dec
                      if (m := re.match(r"output_hypernetworks_mlps_(\d+)$", k)))
    for i in range(n_hyper):
        for j in range(3):
            lin(f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}",
                dec[f"output_hypernetworks_mlps_{i}"][f"layers_{j}"])
    for j in range(3):
        lin(f"mask_decoder.iou_prediction_head.layers.{j}",
            dec["iou_prediction_head"][f"layers_{j}"])
    return sd


def cotracker_state_dict_from_jax(params: Dict[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """JAX `CoTracker` parameter tree -> the port's (= CoTracker v1's)
    state dict, without the checkpoint's "model." prefix."""
    p = _root(params)
    sd: Dict[str, torch.Tensor] = {}

    def lin(dst, node):
        sd[f"{dst}.weight"] = _t(_np(node["kernel"]).T)
        sd[f"{dst}.bias"] = _t(node["bias"])

    def conv(dst, node):
        sd[f"{dst}.weight"] = _t(_np(node["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{dst}.bias"] = _t(node["bias"])

    fnet = p["fnet"]
    conv("fnet.conv1", fnet["conv1"])
    for li in (1, 2, 3, 4):
        for bi in range(2):
            blk = fnet[f"layer{li}_{bi}"]
            conv(f"fnet.layer{li}.{bi}.conv1", blk["conv1"])
            conv(f"fnet.layer{li}.{bi}.conv2", blk["conv2"])
            if "downsample" in blk:
                conv(f"fnet.layer{li}.{bi}.downsample.0", blk["downsample"])
    conv("fnet.conv2", fnet["conv2"])
    conv("fnet.conv3", fnet["conv3"])

    uf = p["updateformer"]
    lin("updateformer.input_transform", uf["input_transform"])
    lin("updateformer.flow_head", uf["flow_head"])
    for kind in ("time_blocks", "space_blocks"):
        i = 0
        while f"{kind}_{i}" in uf:
            src = uf[f"{kind}_{i}"]
            dst = f"updateformer.{kind}.{i}"
            lin(f"{dst}.attn.qkv", src["attn"]["qkv"])
            lin(f"{dst}.attn.proj", src["attn"]["proj"])
            lin(f"{dst}.mlp.fc1", src["mlp_fc1"])
            lin(f"{dst}.mlp.fc2", src["mlp_fc2"])
            i += 1
    sd["norm.weight"] = _t(p["ffeat_norm"]["scale"])
    sd["norm.bias"] = _t(p["ffeat_norm"]["bias"])
    lin("ffeat_updater.0", p["ffeat_updater"])
    lin("vis_predictor.0", p["vis_predictor"])
    return sd
