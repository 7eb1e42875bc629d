"""Plain PyTorch primitives of the reference: the precision that each product
is computed in, resizes, bilinear sampling and sinusoidal embeddings.

The reference computes in float32 with TF32 off (`Precision("float32")`).
A control computes the same mathematics with the operands of every product
(linear layers, convolutions, attention products) rounded to a lower
precision first: `bfloat16`, or `float8` (e4m3 with one scale per tensor,
as fp8 inference scales a tensor to the format's range).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


class Precision:
    """Rounds the operands of a product to `kind` (`float32`: unchanged)."""

    KINDS = ("float32", "bfloat16", "float8")

    def __init__(self, kind: str = "float32"):
        if kind not in self.KINDS:
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.kind == "bfloat16":
            return x.to(torch.bfloat16).float()
        if self.kind == "float8":
            scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
            return (x / scale).to(torch.float8_e4m3fn).float() * scale
        return x


F32 = Precision("float32")

# What a control computes in, one step below what a configuration states.
LOWER = {"float32": "bfloat16", "bfloat16": "float8"}


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32 (TF32 off) until the block ends."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def linear(x, sd, name, p: Precision, bias: bool = True):
    b = sd[name + ".bias"].float() if bias else None
    return F.linear(p(x), p(sd[name + ".weight"]), b)


def conv2d(x, sd, name, p: Precision, bias: bool = True, **kw):
    """NCHW convolution with the weights `name`.weight / .bias."""
    b = sd[name + ".bias"].float() if bias else None
    return F.conv2d(p(x), p(sd[name + ".weight"]), b, **kw)


def conv_transpose2d(x, sd, name, p: Precision, **kw):
    return F.conv_transpose2d(p(x), p(sd[name + ".weight"]),
                              sd[name + ".bias"].float(), **kw)


def matmul(a, b, p: Precision):
    return p(a) @ p(b)


def layer_norm(x, sd, name, eps: float):
    return F.layer_norm(x.float(), x.shape[-1:], sd[name + ".weight"].float(),
                        sd[name + ".bias"].float(), eps)


def layer_norm_2d(x, sd, name, eps: float = 1e-6):
    """LayerNorm over the channels of an NCHW map."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return (sd[name + ".weight"].float()[:, None, None] * x
            + sd[name + ".bias"].float()[:, None, None])


def resize(x, hw, *, align_corners: bool = False, antialias: bool = False):
    """Bilinear resize of an NCHW float tensor."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=align_corners, antialias=antialias)


def longest_side_hw(h: int, w: int, long_side: int):
    """SAM's ResizeLongestSide.get_preprocess_shape."""
    scale = long_side / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def bilinear_at(img, x, y):
    """img [C, H, W], pixel coordinates x, y [N] -> [N, C]; taps outside
    the map are clamped to its border."""
    c, h, w = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    out = 0
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            iy = (y0.long() + dy).clamp(0, h - 1)
            ix = (x0.long() + dx).clamp(0, w - 1)
            out = out + img[:, iy, ix].T * (wy * wx)[:, None]
    return out


def window_taps(corr, cx, cy, radius: int):
    """corr [S, N, H, W], centres cx, cy [S, N] -> [S, N, (2r+1)^2]: bilinear
    samples at (cy + dy, cx + dx) for dy, dx in -r..r, zero outside the
    map, flattened x-major (index dx * (2r+1) + dy)."""
    s, n, h, w = corr.shape
    d = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=corr.device)
    ys = cy[..., None, None] + d[None, None, :, None]  # [S, N, K, 1]
    xs = cx[..., None, None] + d[None, None, None, :]  # [S, N, 1, K]
    ys, xs = torch.broadcast_tensors(ys, xs)  # [S, N, Ky, Kx]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    out = torch.zeros_like(ys)
    flat = corr.reshape(s, n, h * w)
    for dy in (0, 1):
        for dx in (0, 1):
            iy, ix = y0 + dy, x0 + dx
            wgt = (1 - (ys - iy).abs()) * (1 - (xs - ix).abs())
            inside = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w - 1)
            idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long()
            vals = torch.gather(flat, 2, idx.reshape(s, n, -1)).reshape(
                ys.shape)
            out = out + torch.where(inside, vals * wgt, torch.zeros_like(wgt))
    return out.transpose(-1, -2).reshape(s, n, -1)


def sincos_interleaved(v, channels: int):
    """v [...] -> [..., channels]: slot 2k sin(v f_k), 2k+1 cos(v f_k),
    f_k = 2k * 1000 / channels (PIPS's and CoTracker v1's embedding)."""
    f = torch.arange(0, channels, 2, dtype=torch.float32,
                     device=v.device) * (1000.0 / channels)
    ang = v[..., None] * f
    return torch.stack([torch.sin(ang), torch.cos(ang)], -1).flatten(-2)


def sincos_1d(x, dim: int, temperature: float = 10000.0):
    half = dim // 2
    inv = 1.0 / (temperature ** (torch.arange(half, dtype=torch.float32,
                                              device=x.device) / half))
    ang = x[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def sincos_grid(dim: int, h: int, w: int, device):
    """MAE's 2-D table [H, W, dim]: x in the first half, y in the second."""
    q = dim // 4
    omega = 1.0 / (10000.0 ** (torch.arange(q, dtype=torch.float32,
                                            device=device) / q))
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None] * omega
    xs = torch.arange(w, dtype=torch.float32, device=device)[:, None] * omega
    ey = torch.cat([torch.sin(ys), torch.cos(ys)], -1)
    ex = torch.cat([torch.sin(xs), torch.cos(xs)], -1)
    return torch.cat([ex[None].expand(h, w, -1), ey[:, None].expand(h, w, -1)],
                     -1)


def gelu(x, tanh: bool = False):
    return F.gelu(x, approximate="tanh" if tanh else "none")


def attention(q, k, v, p: Precision, scale: float, bias=None, key_mask=None):
    """Softmax attention of q [..., Nq, D] against k, v [..., Nk, D]; keys
    where `key_mask` is False get a -1e30 logit (no weight, and a finite
    result where every key is masked)."""
    logits = matmul(q * scale, k.transpose(-1, -2), p)
    if bias is not None:
        logits = logits + bias
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask, -1e30)
    return matmul(torch.softmax(logits, -1), v, p)
