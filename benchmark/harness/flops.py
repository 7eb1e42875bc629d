"""The yardstick's arithmetic: the H100's published peaks, each kernel's
operations and bytes from its launch shapes, the launches a video should
make, and the model FLOPs of a video.

A multiply-add is 2 operations. A kernel's bytes count each input read
once and each output written once; its operations count what its inputs
need (the image->token direction of K3 over the valid keys only).
"""
from __future__ import annotations

import math

# One H100 SXM at 700 W (NVIDIA's data sheet): dense bf16 tensor cores and
# HBM3 bandwidth.
PEAK_BF16_FLOP_S = 989e12
PEAK_BYTES_S = 3.35e12
BF16 = 2


def attention_roofline(problems: int, nq: int, nk: int, d: int,
                       nbytes: int) -> dict:
    """The least time one H100 could take for `problems` attentions of nq
    queries against nk keys at head dim d (q.k^T and p.v) that move
    `nbytes`: the larger of the two times, and what bounds it."""
    flop = 4 * problems * nq * nk * d
    ops_s = flop / PEAK_BF16_FLOP_S
    bytes_s = nbytes / PEAK_BYTES_S
    return {"flop": flop, "bytes": nbytes, "bound_s": max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def window_launch(bw: int, n: int, heads: int, d: int) -> dict:
    """K1: qkv [BW, N, 3HD] and the bias [BW, N, H, 2 win] in, [BW, N, HD]
    out."""
    win = math.isqrt(n)
    nbytes = BF16 * (bw * n * 3 * heads * d + bw * n * heads * 2 * win
                     + bw * n * heads * d)
    return attention_roofline(bw * heads, n, n, d, nbytes)


def global_launch(b: int, kh: int, kw: int, heads: int, d: int) -> dict:
    """K2: qkv [B, N, 3HD] and the bias [B, N, H, kh + kw] in, [B, N, HD]
    out."""
    n = kh * kw
    nbytes = BF16 * (b * n * 3 * heads * d + b * n * heads * (kh + kw)
                     + b * n * heads * d)
    return attention_roofline(b * heads, n, n, d, nbytes)


def cross_launch(b: int, nq: int, nk: int, heads: int, d: int,
                 valid_keys: int = None) -> dict:
    """K3: q [B, nq, Hd], k and v [B, nk, Hd] (and a uint8 key mask [B, nk])
    in, [B, nq, Hd] out; with a mask, the operations count `valid_keys`
    keys summed over the batch."""
    ch = heads * d
    nbytes = BF16 * (2 * b * nq * ch + 2 * b * nk * ch)
    if valid_keys is None:
        return attention_roofline(b * heads, nq, nk, d, nbytes)
    return attention_roofline(heads, nq, valid_keys, d, nbytes + b * nk)


# ----------------------------------------------------------------------------
# Launch schedule: what a video's SamPt forward should launch
# ----------------------------------------------------------------------------

def launch_schedule(sam: dict, settings: dict, frames: int,
                    objects: int) -> dict:
    """Kernel launches of one video with query masks: per encode chunk one
    K1 a window block and one K2 a global block; per decode chunk 5 K3 a
    decoder pass (two two-way layers of two cross-attentions each and the
    final one), two passes plus the box refinements; no K4."""
    ec, dc = settings["sam_encode_chunk"], settings["sam_decode_chunk"]
    n_global = len(sam["global_attn_indexes"])
    n_window = sam["depth"] - n_global
    enc = -(-frames // ec)
    pairs = frames * objects
    dec = -(-pairs // min(dc, pairs))
    passes = (2 if settings["negative_points_per_mask"] > 0 else 1) + settings[
        "iterative_refinement_iterations"]
    return {"window": n_window * enc, "global": n_global * enc,
            "cross": 5 * passes * dec, "relpos": 0}


# ----------------------------------------------------------------------------
# Model FLOPs of a video
# ----------------------------------------------------------------------------

def vit_flops(sam: dict, image_size: int = 1024) -> float:
    """One frame through SAM's ViT as segment-anything computes it: the
    patch embedding, per block the qkv and output projections (over the
    window-padded tokens in windowed blocks), attention with its rel-pos
    bias, the MLP over the grid, and the neck."""
    c, ps = sam["embed_dim"], sam["patch_size"]
    g = image_size // ps
    n = g * g
    win = sam["window_size"]
    gp = -(-g // win) * win
    n_pad = gp * gp
    hidden = int(c * sam["mlp_ratio"])
    out = sam["out_chans"]
    f = 2 * n * 3 * ps * ps * c
    for i in range(sam["depth"]):
        if i in sam["global_attn_indexes"]:
            tokens, seq, side = n, n, g
        else:
            tokens, seq, side = n_pad, win * win, win
        f += 2 * tokens * c * 4 * c  # qkv and proj
        f += 4 * tokens * seq * c  # q.k and p.v
        f += 2 * tokens * 2 * side * c  # rel-pos bias, both axes
        f += 4 * n * c * hidden  # MLP
    f += 2 * n * c * out + 2 * n * out * out * 9
    return float(f)


def decoder_pass_flops(prompt_tokens: int, with_mask: bool, dim: int = 256,
                       grid: int = 64, mlp: int = 2048) -> float:
    """One pair through SAM's prompt-conditioned mask decoder, token 0's
    mask: two two-way layers and the final attention (projections,
    attention, the token MLP), the upscaling, the hypernetwork and the
    mask downscaling when a mask comes in."""
    t = 5 + prompt_tokens
    n = grid * grid
    half = dim // 2

    def attn(nq, nk, internal):
        return (2 * nq * dim * internal + 2 * 2 * nk * dim * internal
                + 4 * nq * nk * internal + 2 * nq * internal * dim)

    f = 0.0
    for layer in range(2):
        f += attn(t, t, dim)
        f += attn(t, n, half) + attn(n, t, half)
        f += 4 * t * dim * mlp
    f += attn(t, n, half)
    up1 = (2 * grid) ** 2
    f += 2 * up1 * dim * (dim // 4) + 2 * (2 * up1 * 2) * (dim // 4) * (dim // 8)
    f += 2 * (2 * dim * dim + dim * dim // 8) + 2 * (4 * grid) ** 2 * (dim // 8)
    f += 2 * (2 * dim * dim + 4 * dim)  # IoU head
    if with_mask:
        m = 4 * grid
        f += (2 * (m // 2) ** 2 * 4 * 4 + 2 * grid ** 2 * 16 * 4 * 4
              + 2 * grid ** 2 * 16 * dim)
    return f


def basic_encoder_flops(h: int, w: int, latent: int = 128) -> float:
    """PIPS's BasicEncoder on one h x w frame (convolutions)."""
    def conv(hw, cin, cout, k):
        return 2 * hw * cin * cout * k * k

    hw = (h // 2) * (w // 2)
    f = conv(hw, 3, 64, 7)
    stages = ((64, 64, 1), (64, 96, 2), (96, 128, 2), (128, 128, 2))
    for cin, cout, s in stages:
        hw //= s * s
        f += conv(hw, cin, cout, 3) + 3 * conv(hw, cout, cout, 3)
        if s != 1:
            f += conv(hw, cin, cout, 1)
    out_hw = (h // 4) * (w // 4)
    f += conv(out_hw, 416, 2 * latent, 3) + conv(out_hw, 2 * latent, latent, 1)
    return float(f)


def corr_flops(s: int, n: int, hw: int, c: int = 128, levels: int = 4) -> float:
    return 2.0 * s * n * c * sum(hw / 4 ** lv for lv in range(levels))


def cotracker_flops(tracker: dict, frames: int, points: int,
                    hidden: int = 384, depth: int = 6, dim: int = 456) -> float:
    """CoTracker v1 over one video: the encoder on every frame at the
    interpolation size, then per window (forward and backward) and
    iteration the correlations and the UpdateFormer over every track."""
    ih, iw = tracker["interp_shape"]
    s, st = tracker["s"], tracker["stride"]
    n = points + tracker["support_grid_size"] ** 2 * -(
        -frames // tracker["support_grid_every_n_frames"])
    t = max(frames, s)
    windows = len(range(0, t - s // 2, s // 2))
    tokens = n * s
    per_block = (2 * tokens * hidden * 4 * hidden + 4 * tokens * hidden * 4 * hidden)
    attn = 4 * n * s * s * hidden + 4 * s * n * n * hidden
    per_iter = (corr_flops(s, n, (ih // st) * (iw // st))
                + 2 * tokens * dim * hidden + 2 * depth * per_block
                + depth * attn + 2 * tokens * hidden * 130
                + 2 * tokens * 128 * 128)
    return (frames * basic_encoder_flops(ih, iw)
            + 2 * windows * tracker["iters"] * per_iter)


def pips_flops(tracker: dict, frames: int, points: int, hw,
               hidden: int = 512, depth: int = 12) -> float:
    """PIPS over one video: the encoder on every frame, then the windows
    that carry each point from frame 0 to the end, S - 1 frames a window
    (the chain of a point whose visibility stays above the threshold;
    the backward pass has no frames before frame 0 to cover)."""
    s, st = tracker["s"], tracker["stride"]
    h, w = hw
    windows = -(-(frames - 1) // (s - 1))
    mix = (2 * 2 * s * 4 * s * hidden + 2 * 2 * s * hidden * 4 * hidden)
    per_iter = (corr_flops(s, points, (h // st) * (w // st))
                + 2 * s * points * 519 * hidden + depth * points * mix
                + 2 * points * hidden * s * 130 + 2 * s * points * 128 * 128)
    return frames * basic_encoder_flops(h, w) + windows * tracker["iters"] * per_iter


def video_flops(config: dict, frames: int, objects: int, hw) -> dict:
    """Model FLOPs of one video by part: the encoder on every frame, the
    tracker, and every decoder pass of every (frame, object) pair at its
    prompt's size (all its points and, where configured, the other
    objects' positives; the box corners in the refinements)."""
    settings, tracker = config["sam_pt"], config["tracker"]
    p = settings["positive_points_per_mask"] + settings["negative_points_per_mask"]
    points = objects * p
    tokens = p + (settings["positive_points_per_mask"] * (objects - 1)
                  if settings["add_other_objects_positive_points_as_negative_points"]
                  else 0)
    pairs = frames * objects
    neg = settings["negative_points_per_mask"] > 0
    dec = 0.0
    if neg:
        dec += decoder_pass_flops(settings["positive_points_per_mask"] + 1, False)
        dec += decoder_pass_flops(tokens + 1, True)
    else:
        dec += decoder_pass_flops(tokens + 1, False)
    dec += settings["iterative_refinement_iterations"] * decoder_pass_flops(
        tokens + 2, True)
    if tracker["name"] == "cotracker":
        track = cotracker_flops(tracker, frames, points)
    elif tracker["name"] == "pips":
        track = pips_flops(tracker, frames, points, hw)
    else:
        raise ValueError(f"no FLOP count for the tracker {tracker['name']!r}")
    return {"encode": frames * vit_flops(config["sam"]), "track": track,
            "decode": pairs * dec}
