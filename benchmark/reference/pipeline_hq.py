"""The reference's entry points for an HQ-SAM configuration (SysCV/sam-hq,
`segment_anything/build_sam_hq.py` and `modeling/mask_decoder_hq.py`):
`pipeline.py`'s, with what HQ-SAM changes replaced.

  - `param_shapes`: SAM's checkpoint plus `segment_anything_hq`'s decoder
    keys (`mask_decoder.hf_token`, `hf_mlp.layers.j`,
    `compress_vit_feat`, `embedding_encoder` and `embedding_maskfeature`
    at `.0`, `.1`, `.3`). `vit_dim`, the width of the early features, is
    the encoder's `embed_dim`, as `build_sam_hq.py` passes it.
  - `embeddings`, `video_embeddings`: {'emb', 'interm'}, where `interm` is
    the output of the encoder's first global block (block 7 of ViT-H),
    taken in this file's own encoder loop.
  - `decode`: SAM-PT's decode chain through the HQ decoder: five output
    tokens [iou, sam0, multi1..3, hq], the HQ mask on
    `embedding_maskfeature(upscaled SAM features) + hq_features`, and the
    single mask SAM token 0's plus the HQ mask (`hq_token_only` false,
    sam-hq's predictor default), with token 0's IoU.
    `hq_features = embedding_encoder(emb) + compress_vit_feat(interm)`
    depends on the image alone: the published decoder computes it once
    an image and repeats it over the image's prompts; this reference
    decodes one prompt set at a time and computes it once a chain, the
    same arithmetic.
  - `launch_schedule`: `pipeline.py`'s. The HQ token is one more query of
    the same five K3 launches a pass.
  - `video_flops`: `pipeline.py`'s parts plus `hq`: the image-level
    features once a frame; per pair and pass the HQ token in the
    two-way transformer, `embedding_maskfeature`, `hf_mlp`, tokens 1-3's
    hypernetworks, and the four mask products beyond token 0's (the HQ
    decoder computes every token's mask).

Departures from sam-hq, beyond `sam.py`'s: none in the HQ layers. The
decoder's transformer is `sam.py`'s, repeated here with the HQ token,
since `sam.decode` returns token 0 alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..harness import flops
from . import pipeline, sam
from .ops import (F32, Precision, conv2d, conv_transpose2d, gelu, layer_norm,
                  layer_norm_2d, linear, longest_side_hw)
from .pipeline import (fuse, prompt, query_point_faults, threshold,  # noqa: F401
                       tracks, visibility)

MD = "mask_decoder."
D = sam.PROMPT_DIM
# The HQ feature path's widths (sam-hq's MaskDecoderHQ, transformer_dim 256).
HQ_CHANNELS = D // 8
HQ_MID = D // 4


def vit_dim(sam_cfg: dict) -> int:
    """The width of the early features: the ViT's own."""
    return sam_cfg["embed_dim"]


def param_shapes(config: dict) -> dict:
    """{"sam": {name: shape}, "tracker": {name: shape}}: `pipeline.py`'s
    with the HQ decoder's keys after SAM's."""
    shapes = pipeline.param_shapes(config)
    s = shapes["sam"]
    s[MD + "hf_token.weight"] = (1, D)
    for j, (o, i) in enumerate(((D, D), (D, D), (HQ_CHANNELS, D))):
        s[f"{MD}hf_mlp.layers.{j}.weight"] = (o, i)
        s[f"{MD}hf_mlp.layers.{j}.bias"] = (o,)
    # ConvTranspose2d weights are [in, out, k, k], Conv2d's [out, in, k, k]
    blocks = {"compress_vit_feat": ((vit_dim(config["sam"]), D, 2, 2),
                                    (D, HQ_CHANNELS, 2, 2)),
              "embedding_encoder": ((D, HQ_MID, 2, 2),
                                    (HQ_MID, HQ_CHANNELS, 2, 2)),
              "embedding_maskfeature": ((HQ_MID, HQ_CHANNELS, 3, 3),
                                        (HQ_CHANNELS, HQ_MID, 3, 3))}
    for name, (first, second) in blocks.items():
        transposed = name != "embedding_maskfeature"
        mid = first[1] if transposed else first[0]
        out = second[1] if transposed else second[0]
        s[f"{MD}{name}.0.weight"] = first
        s[f"{MD}{name}.0.bias"] = (mid,)
        s[f"{MD}{name}.1.weight"] = (mid,)
        s[f"{MD}{name}.1.bias"] = (mid,)
        s[f"{MD}{name}.3.weight"] = second
        s[f"{MD}{name}.3.bias"] = (out,)
    return shapes


# ----------------------------------------------------------------------------
# Encoder: SAM's, with the first global block's output kept
# ----------------------------------------------------------------------------

def encode(frames: torch.Tensor, sd: dict, sam_cfg: dict,
           p: Precision = F32) -> dict:
    """[B, H, W, 3] uint8 frames -> {'emb': [B, g, g, 256], 'interm':
    [B, g, g, embed_dim]} float32, one frame at a time."""
    outs = [_encode_one(f[None], sd, sam_cfg, p) for f in frames]
    return {k: torch.cat([o[k] for o in outs]) for k in ("emb", "interm")}


def _encode_one(frame, sd, s, p):
    """`sam._encode_one`, keeping what sam-hq's encoder appends after a
    block whose window size is 0: the first such block's output."""
    pre = "image_encoder."
    x = conv2d(sam.preprocess(frame, s["image_size"]), sd,
               pre + "patch_embed.proj", p,
               stride=s["patch_size"]).permute(0, 2, 3, 1)
    x = x + sd[pre + "pos_embed"].float()
    heads, win = s["num_heads"], s["window_size"]
    interm = None
    for i in range(s["depth"]):
        bp = f"{pre}blocks.{i}."
        y = layer_norm(x, sd, bp + "norm1", sam.VIT_EPS)
        if i in s["global_attn_indexes"]:
            y = sam._vit_attention(y, sd, bp + "attn", heads, p)
        else:
            yw, padded = sam._windows(y, win)
            yw = sam._vit_attention(yw, sd, bp + "attn", heads, p)
            y = sam._unwindows(yw, win, padded, x.shape[1:3], x.shape[0])
        x = x + y
        y = layer_norm(x, sd, bp + "norm2", sam.VIT_EPS)
        y = linear(gelu(linear(y, sd, bp + "mlp.lin1", p)), sd,
                   bp + "mlp.lin2", p)
        x = x + y
        if interm is None and i in s["global_attn_indexes"]:
            interm = x
    x = x.permute(0, 3, 1, 2)
    x = conv2d(x, sd, pre + "neck.0", p, bias=False)
    x = layer_norm_2d(x, sd, pre + "neck.1")
    x = conv2d(x, sd, pre + "neck.2", p, bias=False, padding=1)
    x = layer_norm_2d(x, sd, pre + "neck.3")
    return {"emb": x.permute(0, 2, 3, 1), "interm": interm}


def embeddings(frames: torch.Tensor, sd: dict, config: dict,
               p: Precision = F32) -> dict:
    return encode(frames, sd, config["sam"], p)


def video_embeddings(video: torch.Tensor, frames: list, sd: dict,
                     config: dict, p: Precision = F32) -> dict:
    """{'emb', 'interm'} of every frame of `video` [T, H, W, 3]: the
    reference's on `frames`, zero on the others (the control's; the
    comparison reads only the drawn frames)."""
    s = config["sam"]
    grid = s["image_size"] // s["patch_size"]
    t = video.shape[0]
    out = {"emb": torch.zeros((t, grid, grid, s["out_chans"]),
                              device=video.device),
           "interm": torch.zeros((t, grid, grid, vit_dim(s)),
                                 device=video.device)}
    got = embeddings(video[frames], sd, config, p)
    for key in out:
        out[key][frames] = got[key]
    return out


# ----------------------------------------------------------------------------
# The HQ decoder, one prompt set at a time
# ----------------------------------------------------------------------------

def _hq_block(x, sd, name, p, transposed: bool):
    """conv, LayerNorm2d, GELU, conv on an NCHW map: two 2x2 stride-2
    transposed convolutions, or two 3x3 convolutions."""
    if transposed:
        x = conv_transpose2d(x, sd, name + ".0", p, stride=2)
        x = gelu(layer_norm_2d(x, sd, name + ".1"))
        return conv_transpose2d(x, sd, name + ".3", p, stride=2)
    x = conv2d(x, sd, name + ".0", p, padding=1)
    x = gelu(layer_norm_2d(x, sd, name + ".1"))
    return conv2d(x, sd, name + ".3", p, padding=1)


def hq_features(emb: dict, sd: dict, p: Precision = F32) -> torch.Tensor:
    """One frame's {'emb' [g, g, 256], 'interm' [g, g, vit_dim]} ->
    `embedding_encoder(emb) + compress_vit_feat(interm)` [32, 4g, 4g]."""
    e = emb["emb"].float().permute(2, 0, 1)[None]
    v = emb["interm"].float().permute(2, 0, 1)[None]
    return (_hq_block(e, sd, MD + "embedding_encoder", p, True)
            + _hq_block(v, sd, MD + "compress_vit_feat", p, True))[0]


def _hyper(h, sd, name, p):
    for j in range(3):
        h = linear(h, sd, f"{name}.layers.{j}", p)
        if j < 2:
            h = F.relu(h)
    return h


def decode_hq(emb, features, sparse, dense, sd, p: Precision = F32):
    """One prompt set: embedding [g, g, 256], the frame's `hq_features`
    [32, 4g, 4g], sparse [N, 256], dense [g, g, 256] -> (SAM token 0's
    low-res logits plus the HQ token's [4g, 4g], token 0's IoU)."""
    tf = MD + "transformer."
    tokens = torch.cat([sd[MD + "iou_token.weight"].float(),
                        sd[MD + "mask_tokens.weight"].float(),
                        sd[MD + "hf_token.weight"].float(), sparse])
    keys = (emb.float() + dense).reshape(-1, D)
    grid = emb.shape[0]
    key_pe = sam.dense_pe(sd, emb.device, grid).reshape(-1, D)
    queries = tokens
    for i in range(2):
        lp = f"{tf}layers.{i}."
        if i == 0:
            queries = sam._dec_attn(queries, queries, queries, sd,
                                    lp + "self_attn", p)
        else:
            q = queries + tokens
            queries = queries + sam._dec_attn(q, q, queries, sd,
                                              lp + "self_attn", p)
        queries = layer_norm(queries, sd, lp + "norm1", sam.DECODER_EPS)
        q, k = queries + tokens, keys + key_pe
        queries = layer_norm(queries + sam._dec_attn(
            q, k, keys, sd, lp + "cross_attn_token_to_image", p), sd,
            lp + "norm2", sam.DECODER_EPS)
        mlp = linear(F.relu(linear(queries, sd, lp + "mlp.lin1", p)), sd,
                     lp + "mlp.lin2", p)
        queries = layer_norm(queries + mlp, sd, lp + "norm3", sam.DECODER_EPS)
        q, k = queries + tokens, keys + key_pe
        keys = layer_norm(keys + sam._dec_attn(
            k, q, queries, sd, lp + "cross_attn_image_to_token", p), sd,
            lp + "norm4", sam.DECODER_EPS)
    q, k = queries + tokens, keys + key_pe
    queries = layer_norm(queries + sam._dec_attn(
        q, k, keys, sd, tf + "final_attn_token_to_image", p), sd,
        tf + "norm_final_attn", sam.DECODER_EPS)
    up = MD + "output_upscaling."
    x = keys.reshape(1, grid, grid, D).permute(0, 3, 1, 2)
    x = gelu(layer_norm_2d(conv_transpose2d(x, sd, up + "0", p, stride=2), sd,
                           up + "1"))
    upscaled = gelu(conv_transpose2d(x, sd, up + "3", p, stride=2))
    upscaled_hq = (_hq_block(upscaled, sd, MD + "embedding_maskfeature", p,
                             False)[0] + features)
    h_sam = _hyper(queries[1], sd, f"{MD}output_hypernetworks_mlps.0", p)
    h_hq = _hyper(queries[1 + sam.MASK_TOKENS], sd, MD + "hf_mlp", p)
    low = (torch.einsum("c,chw->hw", p(h_sam), p(upscaled[0]))
           + torch.einsum("c,chw->hw", p(h_hq), p(upscaled_hq)))
    iou = queries[0]
    for j in range(3):
        iou = linear(iou, sd, f"{MD}iou_prediction_head.layers.{j}", p)
        if j < 2:
            iou = F.relu(iou)
    return low, iou[0]


def decode_chain(emb: dict, points, labels, hw, sd, size: int,
                 refinements: int, has_negatives: bool, p: Precision = F32):
    """`sam.decode_chain` through the HQ decoder: one frame's {'emb',
    'interm'}, its `hq_features` computed once for the chain's passes.
    Returns (logits [H, W], IoU)."""
    features = hq_features(emb, sd, p)
    emb = emb["emb"]

    def dec(sparse, dense):
        return decode_hq(emb, features, sparse, dense, sd, p)

    th, tw = longest_side_hw(hw[0], hw[1], size)
    grid = emb.shape[0]
    pts = points.float() * torch.tensor([tw / hw[1], th / hw[0]],
                                        device=points.device)
    valid = labels != -1
    no_mask = sd["prompt_encoder.no_mask_embed.weight"].float().reshape(
        1, 1, -1).expand(grid, grid, -1)
    if has_negatives:
        pos = labels == 1
        low, _ = dec(sam.sparse_prompt(pts[pos], labels[pos], sd, size),
                     no_mask)
        low, iou = dec(sam.sparse_prompt(pts[valid], labels[valid], sd, size),
                       sam.mask_prompt(low, sd, p))
    else:
        low, iou = dec(sam.sparse_prompt(pts[valid], labels[valid], sd, size),
                       no_mask)
    for _ in range(refinements):
        mask = sam.upscale(low, hw, size) > 0
        if int(mask.sum()) < 2:
            continue
        ys = torch.nonzero(mask.any(1))[:, 0].float()
        xs = torch.nonzero(mask.any(0))[:, 0].float()
        box = torch.stack([xs.min(), ys.min(), xs.max(), ys.max()])
        low, iou = dec(sam.sparse_prompt(pts[valid], labels[valid], sd, size,
                                         box), sam.mask_prompt(low, sd, p))
    return sam.upscale(low, hw, size), iou


def decode(emb: dict, points, labels, hw, sd, config: dict,
           p: Precision = F32):
    """-> (logits [H, W], IoU, whether any prompt point was visible)."""
    settings = config["sam_pt"]
    logits, iou = decode_chain(
        emb, points, labels, hw, sd, config["sam"]["image_size"],
        settings["iterative_refinement_iterations"],
        settings["negative_points_per_mask"] > 0, p)
    return logits, iou, bool((labels != -1).any())


# ----------------------------------------------------------------------------
# The yardstick's counts
# ----------------------------------------------------------------------------

def launch_schedule(config: dict, frames: int, objects: int) -> dict:
    """The kernel launches of one video of `frames` x `objects`."""
    return pipeline.launch_schedule(config, frames, objects)


def image_flops(sam_cfg: dict) -> float:
    """`hq_features` of one frame: four 2x2 stride-2 transposed
    convolutions, two from the grid and two from twice its side."""
    g = sam_cfg["image_size"] // sam_cfg["patch_size"]
    return float(8 * g * g * (vit_dim(sam_cfg) * D + D * HQ_MID)
                 + 8 * (2 * g) ** 2 * (D * HQ_CHANNELS
                                       + HQ_MID * HQ_CHANNELS))


def pass_flops(sam_cfg: dict, prompt_tokens: int) -> float:
    """What the HQ decoder adds to SAM's token-0 pass
    (`flops.decoder_pass_flops`) at `prompt_tokens`: the HQ token in the
    transformer, `embedding_maskfeature` (two 3x3 convolutions at 4g),
    `hf_mlp` and tokens 1-3's hypernetworks, and four more mask products."""
    g = sam_cfg["image_size"] // sam_cfg["patch_size"]
    m = (4 * g) ** 2
    token = (flops.decoder_pass_flops(prompt_tokens + 1, False, grid=g)
             - flops.decoder_pass_flops(prompt_tokens, False, grid=g))
    maskfeature = 2 * 2 * m * HQ_CHANNELS * HQ_MID * 9
    hypers = 4 * 2 * (2 * D * D + D * HQ_CHANNELS)
    return float(token + maskfeature + hypers + 4 * 2 * m * HQ_CHANNELS)


def pass_tokens(settings: dict, objects: int) -> list:
    """The prompt tokens of each decoder pass of a pair, as
    `flops.video_flops` counts them (the not-a-point pad or the box's two
    corners included)."""
    n_pos = settings["positive_points_per_mask"]
    tokens = n_pos + settings["negative_points_per_mask"] + (
        n_pos * (objects - 1)
        if settings["add_other_objects_positive_points_as_negative_points"]
        else 0)
    first = ([n_pos + 1, tokens + 1]
             if settings["negative_points_per_mask"] > 0 else [tokens + 1])
    return first + [tokens + 2] * settings["iterative_refinement_iterations"]


def video_flops(config: dict, frames: int, objects: int, hw) -> dict:
    """Model FLOPs of one video by part: `pipeline.py`'s, and `hq`: the
    image-level features once a frame, and each pair's passes'
    `pass_flops`."""
    out = pipeline.video_flops(config, frames, objects, hw)
    per_pair = sum(pass_flops(config["sam"], n)
                   for n in pass_tokens(config["sam_pt"], objects))
    out["hq"] = frames * image_flops(config["sam"]) + (
        frames * objects * per_pair)
    return out
