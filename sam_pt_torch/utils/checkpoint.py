"""Weights for the port: public checkpoints, random weights, and the JAX
package's parameter trees.

The port's modules use the public checkpoint names (`segment_anything` for
SAM, `segment_anything_hq` for HQ-SAM, MobileSAM's for TinyViT, CoTracker
v1, PIPS, PIPS++ and RAFT for the trackers), so a public checkpoint loads
into them as it is (`load_or_randomize_`; a HuggingFace `transformers` SAM
file through `hf_sam_to_sam_state_dict`). The
`*_state_dict_from_jax` functions are the inverses of the JAX package's
converters (`convert_sam_state_dict`, `convert_cotracker_state_dict`,
`convert_pips_state_dict`, `convert_pips2_state_dict`,
`convert_raft_state_dict` in `sam_pt_tpu/utils/checkpoint.py`): they take a
JAX parameter tree (nested dicts of arrays, with or without the top-level
"params") and return the port's float32 state dict. TAPIR and TapNet
publish numpy-pickled haiku files: `load_tapir_checkpoint` and
`load_tapnet_checkpoint` read them through copies of the JAX package's
haiku key maps into its flax layout, which the port's module names follow
(`tapir_state_dict_from_jax`, `tapnet_state_dict_from_jax`). magicleap's
SuperPoint and SuperGlue files load as they are
(`load_superglue_checkpoint`); `superglue_state_dict_from_jax` permutes
the JAX package's attention heads into magicleap's layout (F9).

Layouts: Dense kernel [in, out] -> Linear weight [out, in] (and Conv1d
weight [out, in, 1]); Conv kernel [kh, kw, in, out] -> Conv2d weight
[out, in, kh, kw]; 1-D Conv kernel [k, in, out] -> Conv1d weight
[out, in, k]; the JAX package's ConvTranspose kernel is stored spatially
flipped, [kh, kw, in, out] -> ConvTranspose2d weight [in, out, kh, kw]
un-flipped.
"""
from __future__ import annotations

import os
import re
import warnings
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(_np(x)))


def _root(params: Dict[str, Any]) -> Dict[str, Any]:
    return params["params"] if "params" in params else params


@torch.no_grad()
def randomize_(module: nn.Module, generator: torch.Generator,
               std: float = 0.02) -> nn.Module:
    """Fill every parameter and persistent buffer with N(0, std^2) draws."""
    for tensor in list(module.parameters()) + [
            b for name, b in module.named_buffers()
            if name in module.state_dict()]:
        values = torch.randn(tensor.shape, generator=generator,
                             device=generator.device, dtype=torch.float32)
        tensor.copy_(values * std)
    return module


def resolve_pips_checkpoint_file(path: str) -> str:
    """A PIPS-style checkpoint directory holds `model-<step>.pth` files:
    the highest step wins. A file is returned as it is."""
    if os.path.isfile(path):
        return path
    files = [f for f in os.listdir(path) if f.endswith(".pth")]
    if not files:
        raise FileNotFoundError(f"no .pth file under {path}")

    def step(name):
        found = re.search(r"(\d+)", name)
        return int(found.group(1)) if found else -1

    return os.path.join(path, sorted(files, key=step)[-1])


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A public .pth as its state dict: tensors only (`weights_only`), the
    PIPS saver's `model_state_dict` or a `model` entry unwrapped, and the
    DataParallel `module.` prefixes removed."""
    sd = torch.load(resolve_pips_checkpoint_file(path), map_location="cpu",
                    weights_only=True)
    for key in ("model_state_dict", "model"):
        if isinstance(sd.get(key), dict):
            sd = sd[key]
    return {k.removeprefix("module."): v for k, v in sd.items()}


# HuggingFace `transformers` SamModel prefixes -> `segment_anything`'s, in
# the order they are tried (the JAX package's `hf_sam_to_sam_state_dict`).
_HF_SAM_RENAMES = (
    ("vision_encoder.patch_embed.projection.",
     "image_encoder.patch_embed.proj."),
    ("vision_encoder.neck.conv1.", "image_encoder.neck.0."),
    ("vision_encoder.neck.layer_norm1.", "image_encoder.neck.1."),
    ("vision_encoder.neck.conv2.", "image_encoder.neck.2."),
    ("vision_encoder.neck.layer_norm2.", "image_encoder.neck.3."),
    ("vision_encoder.", "image_encoder."),
    ("prompt_encoder.shared_embedding.positional_embedding",
     "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
    ("prompt_encoder.point_embed.", "prompt_encoder.point_embeddings."),
    ("prompt_encoder.mask_embed.conv1.", "prompt_encoder.mask_downscaling.0."),
    ("prompt_encoder.mask_embed.layer_norm1.",
     "prompt_encoder.mask_downscaling.1."),
    ("prompt_encoder.mask_embed.conv2.", "prompt_encoder.mask_downscaling.3."),
    ("prompt_encoder.mask_embed.layer_norm2.",
     "prompt_encoder.mask_downscaling.4."),
    ("prompt_encoder.mask_embed.conv3.", "prompt_encoder.mask_downscaling.6."),
    ("mask_decoder.upscale_conv1.", "mask_decoder.output_upscaling.0."),
    ("mask_decoder.upscale_layer_norm.", "mask_decoder.output_upscaling.1."),
    ("mask_decoder.upscale_conv2.", "mask_decoder.output_upscaling.3."),
    ("mask_decoder.transformer.layer_norm_final_attn.",
     "mask_decoder.transformer.norm_final_attn."),
)


def hf_sam_to_sam_state_dict(hf_sd: Dict[str, Any]) -> Dict[str, Any]:
    """A HuggingFace `transformers` SamModel state dict (`vision_encoder.*`
    keys, the facebook/sam-vit-* files) -> the `segment_anything` layout
    the port's modules use (a copy of the JAX package's key map)."""
    out: Dict[str, Any] = {}
    for key, value in hf_sd.items():
        if key.startswith("shared_image_embedding."):
            continue  # a copy of prompt_encoder.shared_embedding
        k = re.sub(r"^vision_encoder\.layers\.(\d+)\.",
                   r"vision_encoder.blocks.\1.", key)
        k = re.sub(r"(\.(?:blocks|layers)\.\d+)\.layer_norm(\d)\.",
                   r"\1.norm\2.", k)
        # SamFeedForward (proj_in, layers.k, proj_out) -> MLP layers.0..2
        m = re.match(r"^(mask_decoder\.(?:output_hypernetworks_mlps\.\d+|"
                     r"iou_prediction_head))\.(proj_in|proj_out|layers\.(\d+))"
                     r"\.(.*)$", k)
        if m:
            j = {"proj_in": 0, "proj_out": 2}.get(m.group(2))
            if j is None:
                j = 1 + int(m.group(3))
            k = f"{m.group(1)}.layers.{j}.{m.group(4)}"
        for src, dst in _HF_SAM_RENAMES:
            if k.startswith(src):
                k = dst + k[len(src):]
                break
        out[k] = value
    return out


def load_or_randomize_(model: nn.Module, checkpoint_path: Optional[str], *,
                       allow_random_init: bool, seed: int,
                       device: Union[str, torch.device]) -> bool:
    """Move `model` to `device` and give it weights: the public checkpoint
    at `checkpoint_path` (a file, or a PIPS step directory) loaded as it
    is (a HuggingFace SAM file, with `vision_encoder.` keys, converted to
    the `segment_anything` layout first), or, where there is none and
    `allow_random_init` is set,
    N(0, 0.02^2) draws from a generator on `device` seeded with `seed`.
    Every parameter and buffer must be in the checkpoint; keys the model
    does not have (BatchNorm's step counters) are ignored. Returns whether
    a checkpoint was loaded."""
    device = torch.device(device)
    model.to(device)
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        sd = load_torch_state_dict(checkpoint_path)
        if any(k.startswith("vision_encoder.") for k in sd):
            sd = hf_sam_to_sam_state_dict(sd)
        keys = set(model.state_dict())
        if keys - set(sd):
            raise KeyError(f"{checkpoint_path} lacks "
                           f"{sorted(keys - set(sd))[:8]}")
        model.load_state_dict({k: v for k, v in sd.items() if k in keys})
        return True
    if not allow_random_init:
        raise FileNotFoundError(
            f"checkpoint not found: {checkpoint_path} (set "
            f"allow_random_init=True to run on random weights)")
    if checkpoint_path is not None:
        warnings.warn(f"checkpoint {checkpoint_path!r} not found: random "
                      f"weights")
    randomize_(model, torch.Generator(device=device).manual_seed(seed))
    return False


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


def _lin(sd, dst, node):
    sd[f"{dst}.weight"] = _t(_np(node["kernel"]).T)
    sd[f"{dst}.bias"] = _t(node["bias"])


def _conv(sd, dst, node):
    """A 2-D (kernel [kh, kw, in, out]) or 1-D ([k, in, out]) conv."""
    k = _np(node["kernel"])
    sd[f"{dst}.weight"] = _t(k.transpose(3, 2, 0, 1) if k.ndim == 4
                             else k.transpose(2, 1, 0))
    if "bias" in node:
        sd[f"{dst}.bias"] = _t(node["bias"])


def _norm(sd, dst, node, scale="scale"):
    sd[f"{dst}.weight"] = _t(node[scale])
    sd[f"{dst}.bias"] = _t(node["bias"])


def vit_encoder_state_dict_from_jax(enc: Dict[str, Any],
                                    prefix: str = "image_encoder."
                                    ) -> Dict[str, torch.Tensor]:
    """JAX ImageEncoderViT tree -> `image_encoder.*` state dict. The head
    dim is the smallest rel-pos width over the blocks (window blocks are
    never padded)."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, f"{prefix}patch_embed.proj", enc["patch_embed"])
    if "pos_embed" in enc:
        sd[f"{prefix}pos_embed"] = _t(enc["pos_embed"])
    depth = 1 + max(int(m.group(1)) for k in enc
                    if (m := re.match(r"blocks_(\d+)$", k)))
    head_dim = min(_np(enc[f"blocks_{i}"]["attn"]["rel_pos_h"]).shape[-1]
                   for i in range(depth))
    for i in range(depth):
        blk = enc[f"blocks_{i}"]
        dst = f"{prefix}blocks.{i}"
        _norm(sd, f"{dst}.norm1", blk["norm1"])
        sd.update(attention_state_dict_from_jax(blk["attn"], head_dim,
                                                prefix=f"{dst}.attn."))
        _norm(sd, f"{dst}.norm2", blk["norm2"])
        for name in ("lin1", "lin2"):
            _lin(sd, f"{dst}.mlp.{name}", blk[f"mlp_{name}"])
    _conv(sd, f"{prefix}neck.0", enc["neck_conv1"])
    _conv(sd, f"{prefix}neck.2", enc["neck_conv2"])
    for j, name in ((1, "neck_ln1"), (3, "neck_ln2")):
        _norm(sd, f"{prefix}neck.{j}", enc[name], "weight")
    return sd


def tinyvit_encoder_state_dict_from_jax(enc: Dict[str, Any],
                                        prefix: str = "image_encoder."
                                        ) -> Dict[str, torch.Tensor]:
    """JAX TinyViT tree -> MobileSAM's `image_encoder.*` state dict (the
    inverse of the JAX package's `_convert_tinyvit_encoder`): its stage-s
    merge is MobileSAM's `layers.{s-1}.downsample`."""
    sd: Dict[str, torch.Tensor] = {}

    def convbn(dst, node):
        _conv(sd, f"{dst}.c", node["conv"])
        sd[f"{dst}.bn.weight"] = _t(node["bn_scale"])
        sd[f"{dst}.bn.bias"] = _t(node["bn_bias"])
        sd[f"{dst}.bn.running_mean"] = _t(node["bn_mean"])
        sd[f"{dst}.bn.running_var"] = _t(node["bn_var"])

    convbn(f"{prefix}patch_embed.seq.0", enc["patch_embed_conv1"])
    convbn(f"{prefix}patch_embed.seq.2", enc["patch_embed_conv2"])
    for i in range(_count(enc, "stage0_block")):
        for name in ("conv1", "conv2", "conv3"):
            convbn(f"{prefix}layers.0.blocks.{i}.{name}",
                   enc[f"stage0_block{i}"][name])
    for s in range(1, 4):
        for name in ("conv1", "conv2", "conv3"):
            convbn(f"{prefix}layers.{s - 1}.downsample.{name}",
                   enc[f"merge{s}"][name])
        for i in range(_count(enc, f"stage{s}_block")):
            blk, dst = enc[f"stage{s}_block{i}"], f"{prefix}layers.{s}.blocks.{i}"
            _norm(sd, f"{dst}.attn.norm", blk["attn"]["norm"])
            _lin(sd, f"{dst}.attn.qkv", blk["attn"]["qkv"])
            _lin(sd, f"{dst}.attn.proj", blk["attn"]["proj"])
            sd[f"{dst}.attn.attention_biases"] = _t(
                blk["attn"]["attention_biases"])
            convbn(f"{dst}.local_conv", blk["local_conv"])
            _norm(sd, f"{dst}.mlp.norm", blk["mlp_norm"])
            _lin(sd, f"{dst}.mlp.fc1", blk["mlp_fc1"])
            _lin(sd, f"{dst}.mlp.fc2", blk["mlp_fc2"])
    _conv(sd, f"{prefix}neck.0", enc["neck_conv1"])
    _conv(sd, f"{prefix}neck.2", enc["neck_conv2"])
    for j, name in ((1, "neck_ln1"), (3, "neck_ln2")):
        _norm(sd, f"{prefix}neck.{j}", enc[name], "weight")
    return sd


def sam_state_dict_from_jax(params: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """JAX `Sam` parameter tree -> the port's SAM state dict, in the public
    layout of its family (`segment_anything` without the head-dim pad of
    the global blocks, MobileSAM's TinyViT, `segment_anything_hq`'s HQ
    decoder)."""
    p = _root(params)
    if "patch_embed_conv1" in p["image_encoder"]:
        sd = tinyvit_encoder_state_dict_from_jax(p["image_encoder"])
    else:
        sd = vit_encoder_state_dict_from_jax(p["image_encoder"])

    def convt(dst, node):
        k = _np(node["kernel"])[::-1, ::-1]
        sd[f"{dst}.weight"] = _t(k.transpose(2, 3, 0, 1))
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
    _conv(sd, f"{md}.0", pe["mask_conv1"])
    _norm(sd, f"{md}.1", pe["mask_ln1"], "weight")
    _conv(sd, f"{md}.3", pe["mask_conv2"])
    _norm(sd, f"{md}.4", pe["mask_ln2"], "weight")
    _conv(sd, f"{md}.6", pe["mask_conv3"])

    dec = p["mask_decoder"]
    tr = dec["transformer"]
    attns = ("q_proj", "k_proj", "v_proj", "out_proj")
    for i in range(2):
        src = tr[f"layers_{i}"]
        dst = f"mask_decoder.transformer.layers.{i}"
        for a in ("self_attn", "cross_attn_token_to_image",
                  "cross_attn_image_to_token"):
            for name in attns:
                _lin(sd, f"{dst}.{a}.{name}", src[a][name])
        for j in range(1, 5):
            _norm(sd, f"{dst}.norm{j}", src[f"norm{j}"])
        _lin(sd, f"{dst}.mlp.lin1", src["mlp"]["lin1"])
        _lin(sd, f"{dst}.mlp.lin2", src["mlp"]["lin2"])
    for name in attns:
        _lin(sd, f"mask_decoder.transformer.final_attn_token_to_image."
             f"{name}", tr["final_attn_token_to_image"][name])
    _norm(sd, "mask_decoder.transformer.norm_final_attn",
          tr["norm_final_attn"])
    sd["mask_decoder.iou_token.weight"] = _t(dec["iou_token"])
    sd["mask_decoder.mask_tokens.weight"] = _t(dec["mask_tokens"])
    convt("mask_decoder.output_upscaling.0", dec["upscale_conv1"])
    _norm(sd, "mask_decoder.output_upscaling.1", dec["upscale_ln"], "weight")
    convt("mask_decoder.output_upscaling.3", dec["upscale_conv2"])
    n_hyper = 1 + max(int(m.group(1)) for k in dec
                      if (m := re.match(r"output_hypernetworks_mlps_(\d+)$", k)))
    for i in range(n_hyper):
        for j in range(3):
            _lin(sd, f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}",
                 dec[f"output_hypernetworks_mlps_{i}"][f"layers_{j}"])
    for j in range(3):
        _lin(sd, f"mask_decoder.iou_prediction_head.layers.{j}",
             dec["iou_prediction_head"][f"layers_{j}"])
    if "hf_token" in dec:  # HQ-SAM
        sd["mask_decoder.hf_token.weight"] = _t(dec["hf_token"])
        for j in range(3):
            _lin(sd, f"mask_decoder.hf_mlp.layers.{j}",
                 dec["hf_mlp"][f"layers_{j}"])
        for dst, name, transposed in (
                ("embedding_encoder", "embedding_encoder", True),
                ("compress_vit_feat", "compress_vit", True),
                ("embedding_maskfeature", "maskfeature", False)):
            first, second = (f"mask_decoder.{dst}.0", f"mask_decoder.{dst}.3")
            if transposed:
                convt(first, dec[f"{name}_conv1"])
                convt(second, dec[f"{name}_conv2"])
            else:
                _conv(sd, first, dec[f"{name}_conv1"])
                _conv(sd, second, dec[f"{name}_conv2"])
            _norm(sd, f"mask_decoder.{dst}.1", dec[f"{name}_ln"], "weight")
    return sd


def _basic_encoder_from_jax(fnet: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """The PIPS-family BasicEncoder (`fnet.*`) of CoTracker, PIPS and
    PIPS++."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "fnet.conv1", fnet["conv1"])
    for li in (1, 2, 3, 4):
        for bi in range(2):
            blk = fnet[f"layer{li}_{bi}"]
            _conv(sd, f"fnet.layer{li}.{bi}.conv1", blk["conv1"])
            _conv(sd, f"fnet.layer{li}.{bi}.conv2", blk["conv2"])
            if "downsample" in blk:
                _conv(sd, f"fnet.layer{li}.{bi}.downsample.0",
                      blk["downsample"])
    _conv(sd, "fnet.conv2", fnet["conv2"])
    _conv(sd, "fnet.conv3", fnet["conv3"])
    return sd


def _count(tree: Dict[str, Any], prefix: str) -> int:
    return sum(1 for k in tree if re.fullmatch(rf"{prefix}\d+", k))


def pips_state_dict_from_jax(params: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """JAX `Pips` parameter tree -> the port's (= the public PIPS
    reference_model's) state dict."""
    p = _root(params)
    sd = _basic_encoder_from_jax(p["fnet"])
    db = p["delta_block"]
    depth = _count(db, "mixer_")
    td = "delta_block.to_delta"
    _lin(sd, f"{td}.0", db["input_proj"])
    for i in range(depth):
        m, dst = db[f"mixer_{i}"], f"{td}.{1 + i}"
        _norm(sd, f"{dst}.0.norm", m["token_norm"])
        for j, name in ((0, "token_fc1"), (3, "token_fc2")):
            _lin(sd, f"{dst}.0.fn.{j}", m[name])
            sd[f"{dst}.0.fn.{j}.weight"] = sd[f"{dst}.0.fn.{j}.weight"][
                ..., None]  # a kernel-1 Conv1d
        _norm(sd, f"{dst}.1.norm", m["chan_norm"])
        _lin(sd, f"{dst}.1.fn.0", m["chan_fc1"])
        _lin(sd, f"{dst}.1.fn.3", m["chan_fc2"])
    _norm(sd, f"{td}.{depth + 1}", db["out_norm"])
    _lin(sd, f"{td}.{depth + 3}", db["out_proj"])
    _norm(sd, "norm", p["ffeat_norm"])
    _lin(sd, "ffeat_updater.0", p["ffeat_updater"])
    _lin(sd, "vis_predictor.0", p["vis_predictor"])
    return sd


def pips2_state_dict_from_jax(params: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """JAX `PipsPlusPlus` parameter tree -> the port's (= the public PIPS++
    reference_model's) state dict."""
    p = _root(params)
    sd = _basic_encoder_from_jax(p["fnet"])
    db = p["delta_block"]
    _conv(sd, "delta_block.first_block_conv.conv", db["first_block_conv"])
    for i in range(_count(db, "block_")):
        for name in ("conv1", "conv2"):
            _conv(sd, f"delta_block.basicblock_list.{i}.{name}.conv",
                  db[f"block_{i}"][name])
    _lin(sd, "delta_block.dense", db["dense"])
    return sd


def raft_state_dict_from_jax(params: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """JAX `Raft` parameter tree -> the port's (= raft-things.pth's) state
    dict. A strided block's BatchNorm is both `norm3` and `downsample.1`,
    as in the original module."""
    p = _root(params)
    sd: Dict[str, torch.Tensor] = {}

    def bn(dst, node):
        _norm(sd, dst, node)
        sd[f"{dst}.running_mean"] = _t(node["mean"])
        sd[f"{dst}.running_var"] = _t(node["var"])

    for net in ("fnet", "cnet"):
        enc = p[net]
        _conv(sd, f"{net}.conv1", enc["conv1"])
        if "norm1" in enc:
            bn(f"{net}.norm1", enc["norm1"])
        for li in (1, 2, 3):
            for bi in range(2):
                blk, dst = enc[f"layer{li}_{bi}"], f"{net}.layer{li}.{bi}"
                _conv(sd, f"{dst}.conv1", blk["conv1"])
                _conv(sd, f"{dst}.conv2", blk["conv2"])
                for name in ("norm1", "norm2", "norm3"):
                    if name in blk:
                        bn(f"{dst}.{name}", blk[name])
                if "downsample" in blk:
                    _conv(sd, f"{dst}.downsample.0", blk["downsample"])
                    if "norm3" in blk:
                        bn(f"{dst}.downsample.1", blk["norm3"])
        _conv(sd, f"{net}.conv2", enc["conv2"])
    ub = p["update_block"]
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        _conv(sd, f"update_block.encoder.{name}", ub["encoder"][name])
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        _conv(sd, f"update_block.gru.{name}", ub["gru"][name])
    _conv(sd, "update_block.flow_head.conv1", ub["flow_head_conv1"])
    _conv(sd, "update_block.flow_head.conv2", ub["flow_head_conv2"])
    _conv(sd, "update_block.mask.0", ub["mask_conv1"])
    _conv(sd, "update_block.mask.2", ub["mask_conv2"])
    return sd


def cotracker_state_dict_from_jax(params: Dict[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """JAX `CoTracker` parameter tree -> the port's (= CoTracker v1's)
    state dict, without the checkpoint's "model." prefix."""
    p = _root(params)
    sd = _basic_encoder_from_jax(p["fnet"])
    uf = p["updateformer"]
    _lin(sd, "updateformer.input_transform", uf["input_transform"])
    _lin(sd, "updateformer.flow_head", uf["flow_head"])
    for kind in ("time_blocks", "space_blocks"):
        i = 0
        while f"{kind}_{i}" in uf:
            src = uf[f"{kind}_{i}"]
            dst = f"updateformer.{kind}.{i}"
            _lin(sd, f"{dst}.attn.qkv", src["attn"]["qkv"])
            _lin(sd, f"{dst}.attn.proj", src["attn"]["proj"])
            _lin(sd, f"{dst}.mlp.fc1", src["mlp_fc1"])
            _lin(sd, f"{dst}.mlp.fc2", src["mlp_fc2"])
            i += 1
    _norm(sd, "norm", p["ffeat_norm"])
    _lin(sd, "ffeat_updater.0", p["ffeat_updater"])
    _lin(sd, "vis_predictor.0", p["vis_predictor"])
    return sd


# ---------------------------------------------------------------------------
# TAPIR / TapNet: numpy-pickled haiku checkpoints. The key maps are copies
# of the JAX package's (`sam_pt_tpu/utils/checkpoint.py`): haiku -> the JAX
# package's flax tree (numpy), then the generic tree walk to the port's
# state dict, whose module names are the flax ones.
# ---------------------------------------------------------------------------

def _make_put(p: Dict[str, Any]):
    """Nested-dict writer: put('a/b/c', v) sets p['a']['b']['c'] =
    asarray(v)."""

    def put(path: str, value):
        node = p
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(value)

    return put


def load_haiku_npy(path: str) -> Dict[str, Any]:
    """A numpy-pickled haiku params dict (`{'params': ..., 'state': ...}`
    files unwrapped to their params)."""
    raw = np.load(path, allow_pickle=True).item()
    if "params" in raw:
        raw = raw["params"]
    return raw


def convert_tapir_haiku_params(hk_params: Dict[str, Any]) -> Dict[str, Any]:
    """Haiku TAPIR params -> the JAX package's flax tree: module paths
    ('tapir/~/resnet/~/block_group_i/~/block_j/~/conv_0',
    'tapir/~/pips_mlp_mixer/block_k/...') renamed; conv kernels are
    already [kh, kw, in, out] and linear kernels [in, out]."""
    p: Dict[str, Any] = {}
    put = _make_put(p)
    for key, leaf in hk_params.items():
        parts = key.replace("~/", "").replace("tapir/", "").split("/")
        mapped = _map_tapir_module(parts)
        if mapped is None:
            continue
        for wname, w in leaf.items():
            out_name = {"w": "kernel", "b": "bias",
                        "scale": "scale", "offset": "offset"}.get(wname, wname)
            put(f"{mapped}/{out_name}", np.asarray(w))
    return {"params": p}


def _map_tapir_module(parts):
    joined = "/".join(parts)
    if parts[0] == "resnet":
        if parts[-1] == "initial_conv":
            return "resnet/initial_conv"
        m = re.search(r"block_group_(\d)(?:/block_(\d))?/?(.*)", joined)
        if not m:
            return None
        gi, bi, rest = m.group(1), m.group(2) or "0", m.group(3)
        base = f"resnet/group{gi}_block{bi}"
        rest = rest.strip("/")
        if rest.startswith("conv_"):
            return f"{base}/{rest}"
        if rest == "shortcut_conv":
            return f"{base}/shortcut_conv"
        if rest.startswith("instancenorm_"):
            return f"{base}/norm_{rest.split('_')[-1]}"
        return None
    if parts[0] == "pips_mlp_mixer":
        return _map_tapir_mixer(parts[1:])
    heads = ("cost_volume_regression_1", "cost_volume_regression_2",
             "cost_volume_occlusion_1", "cost_volume_occlusion_2",
             "occlusion_out")
    return parts[-1] if parts[-1] in heads else None


def _map_tapir_mixer(parts):
    """Haiku's auto-numbered mixer names: 'linear' the input projection,
    'linear_1' the output head, the top-level 'layer_norm' the final norm;
    in each block ('block', 'block_1', ...) 'layer_norm' / 'layer_norm_1'
    the pre-norms, 'mlp1_up' / 'mlp1_up_1' the two depthwise convs,
    'mlp2_up' / 'mlp2_down' the channel MLP."""
    if not parts:
        return None
    head = parts[0]
    base = "pips_mixer"
    if head == "linear":
        return f"{base}/input_proj"
    if head == "linear_1":
        return f"{base}/out_proj"
    if head == "layer_norm":
        return f"{base}/out_norm"
    if head.startswith("block"):
        idx = 0 if head == "block" else int(head.split("_")[-1])
        sub = parts[1] if len(parts) > 1 else ""
        mapping = {"layer_norm": "norm1", "layer_norm_1": "norm2",
                   "mlp1_up": "dw1", "mlp1_up_1": "dw2",
                   "mlp2_up": "mlp2_up", "mlp2_down": "mlp2_down"}
        if sub in mapping:
            return f"{base}/block_{idx}/{mapping[sub]}"
    return None


def convert_tapnet_haiku_params(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Haiku TapNet params and state -> the JAX package's flax tree: the
    Conv3D heads' kernels [1, kh, kw, in, out] lose their leading 1, the
    BatchNorm affine [1, 1, 1, C] is flattened, and each BatchNorm's
    moving averages (the `state`'s '.../batch_norm/~/mean_ema' and
    'var_ema', their debiased 'average') become its mean and variance."""
    hk_params = raw.get("params", raw)
    hk_state = raw.get("state", {})
    p: Dict[str, Any] = {}
    put = _make_put(p)

    def map_resnet(sub):
        if "tsm_resnet_stem" in sub:
            return "tsm_resnet/initial_conv"
        m = re.search(r"tsm_resnet_unit_(\d+)/block_(\d+)/(.*)", sub)
        if not m:
            return None
        ui, bi, rest = m.group(1), m.group(2), m.group(3).strip("/")
        rest_map = {"conv_0": "conv_0", "conv_2": "conv_2",
                    "shortcut_conv": "shortcut_conv",
                    "batch_norm": "bn_pre", "batch_norm_1": "bn_1"}
        return (f"tsm_resnet/unit{ui}_block{bi}/{rest_map[rest]}"
                if rest in rest_map else None)

    conv3d_heads = {"cost_volume_regression_1", "cost_volume_regression_2",
                    "cost_volume_occlusion_1"}
    heads = conv3d_heads | {"cost_volume_occlusion_2", "occlusion_out"}

    for key, leaf in hk_params.items():
        sub = key.replace("~/", "").replace("tap_net/", "")
        sub = sub.replace("tsm_resnet_video/", "")
        tail = sub.split("/")[-1]
        mapped = (map_resnet(sub) if "tsm_resnet" in sub
                  else (tail if tail in heads else None))
        if mapped is None:
            continue
        for wname, w in leaf.items():
            w = np.asarray(w)
            if wname == "w" and tail in conv3d_heads:
                w = w[0]
            if wname in ("scale", "offset"):
                w = w.reshape(-1)
            out_name = {"w": "kernel", "b": "bias", "scale": "scale",
                        "offset": "bias"}.get(wname, wname)
            put(f"{mapped}/{out_name}", w)

    for key, leaf in hk_state.items():
        sub = key.replace("~/", "").replace("tap_net/", "")
        sub = sub.replace("tsm_resnet_video/", "")
        stat = "mean" if "mean_ema" in sub else (
            "var" if "var_ema" in sub else None)
        if stat is None:
            continue
        mapped = map_resnet(sub.replace("/mean_ema", "").replace("/var_ema",
                                                                 ""))
        if mapped is None:
            continue
        avg = leaf.get("average", leaf) if isinstance(leaf, dict) else leaf
        put(f"{mapped}/{stat}", np.asarray(avg).reshape(-1))
    return {"params": p}


# flax leaf name -> torch parameter or buffer name
_FLAX_LEAF_NAMES = {"kernel": "weight", "bias": "bias", "scale": "weight",
                    "offset": "bias", "mean": "running_mean",
                    "var": "running_var"}


def _flax_modules_state_dict(tree: Dict[str, Any], prefix: str = ""
                             ) -> Dict[str, torch.Tensor]:
    """A flax tree whose module paths are the port's module names -> its
    state dict: kernels transposed by rank (Dense [in, out] -> [out, in],
    1-D conv [k, in, out] -> [out, in, k], 2-D conv [kh, kw, in, out] ->
    [out, in, kh, kw]); an `InstanceNormAffine` (`norm_<i>`) keeps its
    `scale` and `offset`."""
    sd: Dict[str, torch.Tensor] = {}
    module = prefix.rstrip(".").rsplit(".", 1)[-1]
    for name, node in tree.items():
        if isinstance(node, dict):
            sd.update(_flax_modules_state_dict(node, f"{prefix}{name}."))
            continue
        w = _np(node)
        if name == "kernel":
            w = w.transpose({2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}[w.ndim])
        if not module.startswith("norm_"):
            name = _FLAX_LEAF_NAMES[name]
        sd[f"{prefix}{name}"] = _t(w)
    return sd


def tapir_state_dict_from_jax(params: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The JAX package's TAPIR parameter tree -> the port's `TAPIR` state
    dict."""
    return _flax_modules_state_dict(_root(params))


def tapnet_state_dict_from_jax(params: Dict[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's TAPNet parameter tree -> the port's `TAPNet`
    state dict (the BatchNorms' mean and var as running statistics)."""
    return _flax_modules_state_dict(_root(params))


def load_state_dict_strict_(model: nn.Module,
                            sd: Dict[str, torch.Tensor], source: str
                            ) -> nn.Module:
    """Load `sd` into `model` whole: a key missing on either side, or a
    shape that differs, raises and names the keys."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    bad = [f"{k}: {tuple(sd[k].shape)} in the file, {tuple(v.shape)} in "
           f"the model" for k, v in own.items()
           if k in sd and tuple(sd[k].shape) != tuple(v.shape)]
    if missing or extra or bad:
        raise ValueError(f"{source} does not fit {type(model).__name__}: "
                         f"missing {missing[:8]}, unexpected {extra[:8]}, "
                         f"shapes {bad[:8]}")
    model.load_state_dict(sd)
    return model


def load_tapir_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """A public TAPIR .npy (haiku) into the port's `TAPIR`, whole. A file
    of another configuration (the pyramid level sets the mixer's input
    width) raises, naming the keys."""
    sd = tapir_state_dict_from_jax(
        convert_tapir_haiku_params(load_haiku_npy(path)))
    return load_state_dict_strict_(model, sd, path)


def load_tapnet_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """A public TapNet .npy (haiku params and state) into the port's
    `TAPNet`, whole."""
    raw = np.load(path, allow_pickle=True).item()
    sd = tapnet_state_dict_from_jax(convert_tapnet_haiku_params(raw))
    return load_state_dict_strict_(model, sd, path)


def superpoint_state_dict_from_jax(params: Dict[str, Any]
                                   ) -> Dict[str, torch.Tensor]:
    """The JAX package's SuperPoint parameter tree -> the port's (=
    magicleap's `superpoint_v1.pth`) state dict."""
    return _flax_modules_state_dict(_root(params))


def head_permutation(dim: int = 256, heads: int = 4) -> np.ndarray:
    """perm[c]: the JAX package's channel (`h * head_dim + d`, heads split
    contiguously) of the port's and magicleap's channel c (`d * heads +
    h`, heads interleaved)."""
    c = np.arange(dim)
    return (c % heads) * (dim // heads) + c // heads


def superglue_state_dict_from_jax(params: Dict[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX package's SuperGlue parameter tree -> the port's (=
    magicleap's) state dict, with the F9 permutation: the JAX package's
    attention channel `h * 64 + d` becomes the port's `d * 4 + h` in the
    q/k/v projections' output rows and biases and in the merge's input
    columns, so that both compute the same function."""
    p = _root(params)
    sd: Dict[str, torch.Tensor] = {}

    def c1d(dst, node, rows=None, cols=None):
        w = _np(node["kernel"]).T
        b = _np(node["bias"])
        if rows is not None:
            w, b = w[rows], b[rows]
        if cols is not None:
            w = w[:, cols]
        sd[f"{dst}.weight"] = _t(w[:, :, None])
        sd[f"{dst}.bias"] = _t(b)

    def bn(dst, node):
        _norm(sd, dst, node)
        sd[f"{dst}.running_mean"] = _t(node["mean"])
        sd[f"{dst}.running_var"] = _t(node["var"])

    kenc = p["kenc"]
    n_hidden = sum(k.startswith("layer_") for k in kenc)
    for i in range(n_hidden):
        c1d(f"kenc.encoder.{3 * i}", kenc[f"layer_{i}"]["lin"])
        bn(f"kenc.encoder.{3 * i + 1}", kenc[f"layer_{i}"]["bn"])
    c1d(f"kenc.encoder.{3 * n_hidden}", kenc["out"])
    for i in range(2 * sum(k.startswith("self_") for k in p)):
        src = p[f"{('self', 'cross')[i % 2]}_{i // 2}"]
        dst = f"gnn.layers.{i}"
        attn = src["attn"]
        perm = head_permutation(_np(attn["merge"]["kernel"]).shape[0])
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            c1d(f"{dst}.attn.proj.{j}", attn[name], rows=perm)
        c1d(f"{dst}.attn.merge", attn["merge"], cols=perm)
        c1d(f"{dst}.mlp.0", src["mlp_0"]["lin"])
        bn(f"{dst}.mlp.1", src["mlp_0"]["bn"])
        c1d(f"{dst}.mlp.3", src["mlp_out"])
    c1d("final_proj", p["final_proj"])
    sd["bin_score"] = _t(np.asarray(p["bin_score"]).reshape(()))
    return sd


def load_superglue_checkpoint(superpoint_path: str, superglue_path: str,
                              superpoint: nn.Module,
                              superglue: nn.Module) -> None:
    """magicleap's `superpoint_v1.pth` and `superglue_{indoor,outdoor}.pth`
    into the port's SuperPoint and SuperGlue as they are, strictly (a key
    missing on either side, or a shape that differs, raises); only
    BatchNorm's step counters (`num_batches_tracked`), which inference
    does not read, are left out."""
    for path, model in ((superpoint_path, superpoint),
                        (superglue_path, superglue)):
        sd = {k: v for k, v in load_torch_state_dict(path).items()
              if not k.endswith("num_batches_tracked")}
        device = next(model.parameters()).device
        load_state_dict_strict_(model, {k: v.to(device) for k, v in
                                        sd.items()}, path)
