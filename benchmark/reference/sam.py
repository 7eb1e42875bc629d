"""Plain PyTorch SAM (segment-anything's `build_sam.py`, image encoder,
prompt encoder, mask decoder) and SAM-PT's decode chain, in float32 unless
a `Precision` says otherwise.

Weights are state dicts in the public `segment_anything` names
(`image_encoder.blocks.0.attn.qkv.weight`, ...). `param_shapes` lists
them for a configuration, so that a benchmark can draw them.

Departures from segment-anything, each as the port's semantics state
them (and the JAX package before it):
  - frames are resized on the device in float32 (bilinear, antialiased),
    not by PIL in uint8;
  - the decode chain's box refinement passes the box corners in
    original-image pixels, as SAM-PT's reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .ops import (F32, Precision, attention, conv2d, conv_transpose2d, gelu,
                  layer_norm, layer_norm_2d, linear, longest_side_hw, resize)

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
PROMPT_DIM = 256
MASK_TOKENS = 4
VIT_EPS = 1e-6
# segment-anything's TwoWayTransformer norms are nn.LayerNorm(256): 1e-5.
DECODER_EPS = 1e-5


def param_shapes(sam: dict) -> dict:
    """{name: shape} of the checkpoint of a SAM whose encoder is `sam`
    ({image_size, embed_dim, depth, num_heads, global_attn_indexes,
    window_size, mlp_ratio, patch_size, out_chans})."""
    c, ps = sam["embed_dim"], sam["patch_size"]
    grid = sam["image_size"] // ps
    hd = c // sam["num_heads"]
    hidden = int(c * sam["mlp_ratio"])
    out = sam["out_chans"]
    s = {"image_encoder.patch_embed.proj.weight": (c, 3, ps, ps),
         "image_encoder.patch_embed.proj.bias": (c,),
         "image_encoder.pos_embed": (1, grid, grid, c)}
    for i in range(sam["depth"]):
        p = f"image_encoder.blocks.{i}."
        size = grid if i in sam["global_attn_indexes"] else sam["window_size"]
        s.update({p + "norm1.weight": (c,), p + "norm1.bias": (c,),
                  p + "attn.qkv.weight": (3 * c, c), p + "attn.qkv.bias": (3 * c,),
                  p + "attn.proj.weight": (c, c), p + "attn.proj.bias": (c,),
                  p + "attn.rel_pos_h": (2 * size - 1, hd),
                  p + "attn.rel_pos_w": (2 * size - 1, hd),
                  p + "norm2.weight": (c,), p + "norm2.bias": (c,),
                  p + "mlp.lin1.weight": (hidden, c), p + "mlp.lin1.bias": (hidden,),
                  p + "mlp.lin2.weight": (c, hidden), p + "mlp.lin2.bias": (c,)})
    s.update({"image_encoder.neck.0.weight": (out, c, 1, 1),
              "image_encoder.neck.1.weight": (out,),
              "image_encoder.neck.1.bias": (out,),
              "image_encoder.neck.2.weight": (out, out, 3, 3),
              "image_encoder.neck.3.weight": (out,),
              "image_encoder.neck.3.bias": (out,)})
    d = PROMPT_DIM
    pe = "prompt_encoder."
    s[pe + "pe_layer.positional_encoding_gaussian_matrix"] = (2, d // 2)
    for i in range(4):
        s[pe + f"point_embeddings.{i}.weight"] = (1, d)
    s[pe + "not_a_point_embed.weight"] = (1, d)
    s[pe + "no_mask_embed.weight"] = (1, d)
    for name, shape in (("0", (4, 1, 2, 2)), ("1", (4,)), ("3", (16, 4, 2, 2)),
                        ("4", (16,)), ("6", (d, 16, 1, 1))):
        s[pe + f"mask_downscaling.{name}.weight"] = shape
        s[pe + f"mask_downscaling.{name}.bias"] = (shape[0],)
    md = "mask_decoder."

    def attn(prefix, internal):
        for proj, (o, i) in (("q_proj", (internal, d)), ("k_proj", (internal, d)),
                             ("v_proj", (internal, d)), ("out_proj", (d, internal))):
            s[f"{prefix}.{proj}.weight"] = (o, i)
            s[f"{prefix}.{proj}.bias"] = (o,)

    def norm(prefix):
        s[prefix + ".weight"] = (d,)
        s[prefix + ".bias"] = (d,)

    for i in range(2):
        p = f"{md}transformer.layers.{i}."
        attn(p + "self_attn", d)
        attn(p + "cross_attn_token_to_image", d // 2)
        attn(p + "cross_attn_image_to_token", d // 2)
        for n in ("norm1", "norm2", "norm3", "norm4"):
            norm(p + n)
        s.update({p + "mlp.lin1.weight": (2048, d), p + "mlp.lin1.bias": (2048,),
                  p + "mlp.lin2.weight": (d, 2048), p + "mlp.lin2.bias": (d,)})
    attn(md + "transformer.final_attn_token_to_image", d // 2)
    norm(md + "transformer.norm_final_attn")
    s[md + "iou_token.weight"] = (1, d)
    s[md + "mask_tokens.weight"] = (MASK_TOKENS, d)
    s.update({md + "output_upscaling.0.weight": (d, d // 4, 2, 2),
              md + "output_upscaling.0.bias": (d // 4,),
              md + "output_upscaling.1.weight": (d // 4,),
              md + "output_upscaling.1.bias": (d // 4,),
              md + "output_upscaling.3.weight": (d // 4, d // 8, 2, 2),
              md + "output_upscaling.3.bias": (d // 8,)})
    for t in range(MASK_TOKENS):
        for j, (o, i) in enumerate(((d, d), (d, d), (d // 8, d))):
            s[f"{md}output_hypernetworks_mlps.{t}.layers.{j}.weight"] = (o, i)
            s[f"{md}output_hypernetworks_mlps.{t}.layers.{j}.bias"] = (o,)
    for j, (o, i) in enumerate(((256, d), (256, 256), (MASK_TOKENS, 256))):
        s[f"{md}iou_prediction_head.layers.{j}.weight"] = (o, i)
        s[f"{md}iou_prediction_head.layers.{j}.bias"] = (o,)
    return s


# ----------------------------------------------------------------------------
# Image encoder
# ----------------------------------------------------------------------------

def preprocess(frames: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> normalised, zero-padded [B, 3, size, size]."""
    h, w = frames.shape[1:3]
    x = resize(frames.float().permute(0, 3, 1, 2), longest_side_hw(
        h, w, size), antialias=True)
    mean = torch.tensor(PIXEL_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(PIXEL_STD, device=x.device)[:, None, None]
    x = (x - mean) / std
    return F.pad(x, (0, size - x.shape[-1], 0, size - x.shape[-2]))


def _rel_table(rel_pos, q: int, k: int):
    """segment-anything's get_rel_pos for q == k at the table's own size."""
    idx = (torch.arange(q)[:, None] - torch.arange(k)[None, :] + (k - 1))
    return rel_pos.float()[idx.to(rel_pos.device)]


def _vit_attention(x, sd, p_name, heads, p: Precision):
    """x [B, h, w, C] -> [B, h, w, C], decomposed rel-pos attention."""
    b, h, w, c = x.shape
    hd = c // heads
    qkv = linear(x.reshape(b, h * w, c), sd, p_name + ".qkv", p)
    qkv = qkv.reshape(b, h * w, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # [B, heads, N, hd]
    rh = _rel_table(sd[p_name + ".rel_pos_h"], h, h)
    rw = _rel_table(sd[p_name + ".rel_pos_w"], w, w)
    rq = q.reshape(b, heads, h, w, hd)
    bias_h = torch.einsum("bnhwc,hkc->bnhwk", p(rq), p(rh))
    bias_w = torch.einsum("bnhwc,wkc->bnhwk", p(rq), p(rw))
    bias = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(
        b, heads, h * w, h * w)
    out = attention(q, k, v, p, hd ** -0.5, bias=bias)
    out = out.permute(0, 2, 1, 3).reshape(b, h * w, c)
    return linear(out, sd, p_name + ".proj", p).reshape(b, h, w, c)


def _windows(x, win):
    b, h, w, c = x.shape
    ph, pw = (win - h % win) % win, (win - w % win) % win
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win, win, c), (hp, wp)


def _unwindows(x, win, padded, hw, b):
    hp, wp = padded
    x = x.reshape(b, hp // win, wp // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :hw[0], :hw[1]]


def encode(frames: torch.Tensor, sd: dict, sam: dict, p: Precision = F32):
    """[B, H, W, 3] uint8 frames -> embeddings [B, g, g, 256] float32,
    one frame at a time (the global blocks' [heads, g^2, g^2] logits)."""
    return torch.cat([_encode_one(f[None], sd, sam, p) for f in frames])


def _encode_one(frame, sd, sam, p):
    pre = "image_encoder."
    x = conv2d(preprocess(frame, sam["image_size"]), sd,
               pre + "patch_embed.proj", p,
               stride=sam["patch_size"]).permute(0, 2, 3, 1)
    x = x + sd[pre + "pos_embed"].float()
    heads, win = sam["num_heads"], sam["window_size"]
    for i in range(sam["depth"]):
        bp = f"{pre}blocks.{i}."
        y = layer_norm(x, sd, bp + "norm1", VIT_EPS)
        if i in sam["global_attn_indexes"]:
            y = _vit_attention(y, sd, bp + "attn", heads, p)
        else:
            yw, padded = _windows(y, win)
            yw = _vit_attention(yw, sd, bp + "attn", heads, p)
            y = _unwindows(yw, win, padded, x.shape[1:3], x.shape[0])
        x = x + y
        y = layer_norm(x, sd, bp + "norm2", VIT_EPS)
        y = linear(gelu(linear(y, sd, bp + "mlp.lin1", p)), sd,
                   bp + "mlp.lin2", p)
        x = x + y
    x = x.permute(0, 3, 1, 2)
    x = conv2d(x, sd, pre + "neck.0", p, bias=False)
    x = layer_norm_2d(x, sd, pre + "neck.1")
    x = conv2d(x, sd, pre + "neck.2", p, bias=False, padding=1)
    x = layer_norm_2d(x, sd, pre + "neck.3")
    return x.permute(0, 2, 3, 1)


# ----------------------------------------------------------------------------
# Prompt encoder and mask decoder, one prompt set at a time
# ----------------------------------------------------------------------------

def _pe(coords01, sd):
    g = sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
    c = (2 * math.pi) * ((2 * coords01 - 1) @ g.float())
    return torch.cat([torch.sin(c), torch.cos(c)], -1)


def dense_pe(sd, device, grid: int):
    xs = (torch.arange(grid, dtype=torch.float32, device=device) + 0.5) / grid
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    return _pe(torch.stack([gx, gy], -1), sd)  # [grid, grid, C]


def sparse_prompt(points, labels, sd, size: int, box=None):
    """Valid points [N, 2] with labels [N] in {0, 1} (model coordinates),
    an optional box (x0, y0, x1, y1) -> [N', 256]: segment-anything's
    `_embed_points` (with the not-a-point pad when there is no box) and
    `_embed_boxes`."""
    pe = "prompt_encoder."
    pts = points.float() + 0.5
    emb = _pe(pts / size, sd)
    table = torch.cat([sd[pe + f"point_embeddings.{i}.weight"].float()
                       for i in range(4)])
    emb = emb + table[labels.long()]
    parts = [emb]
    if box is None:
        parts.append(sd[pe + "not_a_point_embed.weight"].float())
    else:
        corners = box.float().reshape(2, 2) + 0.5
        cemb = _pe(corners / size, sd) + table[2:4]
        parts.append(cemb)
    return torch.cat(parts)


def mask_prompt(mask_logits, sd, p: Precision):
    """Low-res logits [4g, 4g] -> dense embedding [g, g, 256]."""
    pe = "prompt_encoder.mask_downscaling."
    x = mask_logits.float()[None, None]
    x = gelu(layer_norm_2d(conv2d(x, sd, pe + "0", p, stride=2), sd, pe + "1"))
    x = gelu(layer_norm_2d(conv2d(x, sd, pe + "3", p, stride=2), sd, pe + "4"))
    return conv2d(x, sd, pe + "6", p)[0].permute(1, 2, 0)


def _dec_attn(q, k, v, sd, name, p, heads=8):
    qp = linear(q, sd, name + ".q_proj", p)
    kp = linear(k, sd, name + ".k_proj", p)
    vp = linear(v, sd, name + ".v_proj", p)
    hd = qp.shape[-1] // heads

    def split(x):
        return x.reshape(x.shape[0], heads, hd).transpose(0, 1)

    out = attention(split(qp), split(kp), split(vp), p, hd ** -0.5)
    return linear(out.transpose(0, 1).reshape(q.shape[0], -1), sd,
                  name + ".out_proj", p)


def decode(emb, sparse, dense, sd, p: Precision = F32):
    """One prompt set: embedding [g, g, 256], sparse [N, 256], dense
    [g, g, 256] -> (token 0's low-res logits [4g, 4g], its IoU)."""
    md = "mask_decoder."
    tf = md + "transformer."
    tokens = torch.cat([sd[md + "iou_token.weight"].float(),
                        sd[md + "mask_tokens.weight"].float(), sparse])
    keys = (emb.float() + dense).reshape(-1, PROMPT_DIM)
    grid = emb.shape[0]
    key_pe = dense_pe(sd, emb.device, grid).reshape(-1, PROMPT_DIM)
    queries = tokens
    for i in range(2):
        lp = f"{tf}layers.{i}."
        if i == 0:
            queries = _dec_attn(queries, queries, queries, sd,
                                lp + "self_attn", p)
        else:
            q = queries + tokens
            queries = queries + _dec_attn(q, q, queries, sd, lp + "self_attn",
                                          p)
        queries = layer_norm(queries, sd, lp + "norm1", DECODER_EPS)
        q, k = queries + tokens, keys + key_pe
        queries = layer_norm(queries + _dec_attn(
            q, k, keys, sd, lp + "cross_attn_token_to_image", p), sd,
            lp + "norm2", DECODER_EPS)
        mlp = linear(F.relu(linear(queries, sd, lp + "mlp.lin1", p)), sd,
                     lp + "mlp.lin2", p)
        queries = layer_norm(queries + mlp, sd, lp + "norm3", DECODER_EPS)
        q, k = queries + tokens, keys + key_pe
        keys = layer_norm(keys + _dec_attn(
            k, q, queries, sd, lp + "cross_attn_image_to_token", p), sd,
            lp + "norm4", DECODER_EPS)
    q, k = queries + tokens, keys + key_pe
    queries = layer_norm(queries + _dec_attn(
        q, k, keys, sd, tf + "final_attn_token_to_image", p), sd,
        tf + "norm_final_attn", DECODER_EPS)
    up = md + "output_upscaling."
    x = keys.reshape(1, grid, grid, PROMPT_DIM).permute(0, 3, 1, 2)
    x = gelu(layer_norm_2d(conv_transpose2d(x, sd, up + "0", p, stride=2), sd,
                           up + "1"))
    x = gelu(conv_transpose2d(x, sd, up + "3", p, stride=2))[0]  # [32, 4g, 4g]
    h = queries[1]
    for j in range(3):
        h = linear(h, sd, f"{md}output_hypernetworks_mlps.0.layers.{j}", p)
        if j < 2:
            h = F.relu(h)
    low = torch.einsum("c,chw->hw", p(h), p(x))
    iou = queries[0]
    for j in range(3):
        iou = linear(iou, sd, f"{md}iou_prediction_head.layers.{j}", p)
        if j < 2:
            iou = F.relu(iou)
    return low, iou[0]


def upscale(low, hw, size: int):
    """Low-res logits [..., 4g, 4g] -> [..., H, W]: to the model's input
    size, crop the padding, to the frame (segment-anything's
    postprocess_masks)."""
    th, tw = longest_side_hw(hw[0], hw[1], size)
    x = low.float().reshape(-1, 1, *low.shape[-2:])
    x = resize(x, (size, size))[..., :th, :tw]
    return resize(x, hw).reshape(*low.shape[:-2], *hw)


def decode_chain(emb, points, labels, hw, sd, size: int, refinements: int,
                 has_negatives: bool, p: Precision = F32):
    """SAM-PT's decode of one (frame, object) pair: points [N, 2] in frame
    pixels with labels [N] (1 positive, 0 negative, -1 absent). A pass with
    the positives alone, a pass with every point and the first pass's
    mask, then `refinements` passes that add the box around the current
    mask (corners in frame pixels) and its logits; a pass is skipped while
    the mask has fewer than 2 pixels. Returns (logits [H, W], IoU)."""
    th, tw = longest_side_hw(hw[0], hw[1], size)
    grid = emb.shape[0]
    pts = points.float() * torch.tensor([tw / hw[1], th / hw[0]],
                                        device=points.device)
    valid = labels != -1
    no_mask = sd["prompt_encoder.no_mask_embed.weight"].float().reshape(
        1, 1, -1).expand(grid, grid, -1)
    if has_negatives:
        pos = labels == 1
        low, _ = decode(emb, sparse_prompt(pts[pos], labels[pos], sd, size),
                        no_mask, sd, p)
        low, iou = decode(emb, sparse_prompt(pts[valid], labels[valid], sd, size),
                          mask_prompt(low, sd, p), sd, p)
    else:
        low, iou = decode(emb, sparse_prompt(pts[valid], labels[valid], sd, size),
                          no_mask, sd, p)
    for _ in range(refinements):
        mask = upscale(low, hw, size) > 0
        if int(mask.sum()) < 2:
            continue
        ys = torch.nonzero(mask.any(1))[:, 0].float()
        xs = torch.nonzero(mask.any(0))[:, 0].float()
        box = torch.stack([xs.min(), ys.min(), xs.max(), ys.max()])
        low, iou = decode(emb, sparse_prompt(pts[valid], labels[valid], sd,
                                             size, box), mask_prompt(low, sd, p),
                          sd, p)
    return upscale(low, hw, size), iou
