"""The four attention kernels of the port, with their plain versions.

Counterpart of `sam_pt_tpu/ops/flash_attention.py`. Each kernel is written
by hand in CUDA C++ for Hopper (`sam_pt_torch/csrc/*.cu`, built by
`ops/_cuda.py`) and has, beside it here, a plain PyTorch version with the
same rounding points:

  K1 `window_attention`  <- fused_qkv_window_attention (:542), ViT windows
  K2 `global_attention`  <- fused_qkv_relpos_attention (:219), ViT global
  K3 `cross_attention`   <- fused_cross_attention (:381), mask decoder
  K4 `relpos_attention`  <- fused_relpos_attention (:87), ViT `Attention`
                            on split q/k/v (its default route)

Dispatch rule of every wrapper: a tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or raises. The kernels take
bfloat16 (the main path's dtype) at the shapes SAM gives them: head dims a
multiple of 16 up to 128 for K1/K2/K4, 16 for K3. The wrappers count their
launches in `LAUNCHES` (only the CUDA path counts); K1's and K2's in a
CUDA graph when its replay announces them (`graph_launches.py`).

The decomposed rel-pos bias of K1/K2/K4 is computed before the kernel by two
einsums in the input dtype (float32 accumulation, one rounding at the
output), as the JAX package does.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils import tracing
from . import graph_launches

LAUNCHES = {"window": 0, "global": 0, "cross": 0, "relpos": 0}
# The most tokens the window body (K1, and K4 below 1024 tokens) takes.
WINDOW_MAX_TOKENS = 208


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _rounded(value: float, dtype: torch.dtype) -> float:
    """A Python scalar as the JAX package applies it to a `dtype` array (a
    weakly typed constant takes the array's dtype)."""
    return float(torch.tensor(value, dtype=dtype))


def _check_cuda(name: str, tensors) -> None:
    device = tensors[0].device
    for t in tensors:
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.dtype not in (torch.bfloat16, torch.uint8):
            raise TypeError(f"{name}: the kernel takes bfloat16, not "
                            f"{t.dtype}")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _softmax_rows(logits: torch.Tensor) -> torch.Tensor:
    """f32 softmax over the last axis written as the kernels compute it."""
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    return p / p.sum(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# K1: windowed rel-pos attention
# ---------------------------------------------------------------------------

def window_bias(qkv: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                heads: int) -> torch.Tensor:
    """Per-token decomposed bias [BW, N, H, 2*win] in qkv's dtype:
    [q . rel_h[y_q, :], q . rel_w[x_q, :]]."""
    bw, n, chans = qkv.shape
    d = chans // (3 * heads)
    win = rel_h.shape[0]
    ys = torch.arange(n, device=qkv.device) // win
    xs = torch.arange(n, device=qkv.device) % win
    q4 = qkv[..., :heads * d].reshape(bw, n, heads, d)
    bias_h = torch.einsum("bnhd,nkd->bnhk", q4, rel_h[ys].to(qkv.dtype))
    bias_w = torch.einsum("bnhd,nkd->bnhk", q4, rel_w[xs].to(qkv.dtype))
    return torch.cat([bias_h, bias_w], dim=-1).contiguous()


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor, *,
                           scale: float, heads: int) -> torch.Tensor:
    """Plain PyTorch K1: qkv [BW, N, 3*H*D], bias [BW, N, H, 2*win]."""
    bw, n, chans = qkv.shape
    d = chans // (3 * heads)
    win = bias.shape[-1] // 2
    dtype = qkv.dtype
    x = qkv.reshape(bw, n, 3, heads, d).permute(2, 0, 3, 1, 4)  # [3,BW,H,N,D]
    q = (x[0].float() * _rounded(scale, dtype)).to(dtype).float()
    logits = q @ x[1].float().transpose(-1, -2)  # [BW, H, N, N]
    b = bias.float().permute(0, 2, 1, 3)  # [BW, H, N, 2*win]
    ys = torch.arange(n, device=qkv.device) // win
    xs = torch.arange(n, device=qkv.device) % win
    logits = logits + (b[..., ys] + b[..., win + xs])
    p = _softmax_rows(logits).to(dtype).float()
    out = (p @ x[2].float()).to(dtype)  # [BW, H, N, D]
    return out.permute(0, 2, 1, 3).reshape(bw, n, heads * d)


def window_attention_cuda(qkv: torch.Tensor, bias: torch.Tensor, *,
                          scale: float, heads: int) -> torch.Tensor:
    """K1 kernel launch (sam_pt_torch/csrc/window_attention.cu); a graph
    replay's announcement (`graph_launches.py`) counts it and returns
    None."""
    if graph_launches.announced(__name__, "window_attention_cuda", qkv,
                                bias, scale=scale, heads=heads):
        LAUNCHES["window"] += 1
        return None
    from ._cuda import check, library

    _check_cuda("window_attention", (qkv, bias))
    bw, n, chans = qkv.shape
    d = chans // (3 * heads)
    win = bias.shape[-1] // 2
    if (chans != 3 * heads * d or win * win != n or n > WINDOW_MAX_TOKENS
            or d % 16 or d > 128 or bias.shape != (bw, n, heads, 2 * win)):
        raise ValueError(
            f"window_attention: unsupported shapes {tuple(qkv.shape)}, "
            f"{tuple(bias.shape)}")
    out = torch.empty((bw, n, heads * d), dtype=qkv.dtype, device=qkv.device)
    status = library().sam_window_attention(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), bw, n, win, heads,
        d, _rounded(scale, qkv.dtype), _stream())
    check(status, "sam_window_attention")
    LAUNCHES["window"] += 1
    return out


def window_attention(qkv: torch.Tensor, rel_h: torch.Tensor,
                     rel_w: torch.Tensor, *, scale: float,
                     heads: int) -> torch.Tensor:
    """Windowed ViT rel-pos attention from the fused qkv projection.

    qkv [BW, N, 3*H*D] (N = win*win), rel_h/rel_w [win, win, D] resolved
    tables in qkv's dtype. Returns [BW, N, H*D].
    """
    bias = window_bias(qkv, rel_h, rel_w, heads)
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, bias, scale=scale, heads=heads)
    return window_attention_cuda(qkv, bias, scale=scale, heads=heads)


# ---------------------------------------------------------------------------
# K2: global rel-pos attention
# ---------------------------------------------------------------------------

def global_bias(qkv: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                heads: int, kh: int, kw: int) -> torch.Tensor:
    """Per-token factored bias [B, N, H, kh + kw] in qkv's dtype."""
    b, n, chans = qkv.shape
    d = chans // (3 * heads)
    q4 = qkv[..., :heads * d].reshape(b, kh, kw, heads, d)
    bias_h = torch.einsum("byxhd,ykd->byxhk", q4, rel_h.to(qkv.dtype))
    bias_w = torch.einsum("byxhd,xkd->byxhk", q4, rel_w.to(qkv.dtype))
    bias = torch.cat([bias_h, bias_w], dim=-1)
    return bias.reshape(b, n, heads, kh + kw).contiguous()


def global_attention_plain(qkv: torch.Tensor, bias: torch.Tensor, *,
                           scale: float, heads: int, kh: int,
                           kw: int) -> torch.Tensor:
    """Plain PyTorch K2 (one frame at a time to bound the [H, N, N] logits)."""
    b, n, chans = qkv.shape
    d = chans // (3 * heads)
    dtype = qkv.dtype
    ys = torch.arange(n, device=qkv.device) // kw
    xs = torch.arange(n, device=qkv.device) % kw
    outs = []
    for i in range(b):
        x = qkv[i].reshape(n, 3, heads, d).permute(1, 2, 0, 3)  # [3,H,N,D]
        q = (x[0].float() * _rounded(scale, dtype)).to(dtype).float()
        logits = q @ x[1].float().transpose(-1, -2)  # [H, N, N]
        bb = bias[i].float().permute(1, 0, 2)  # [H, N, kh + kw]
        logits += bb[..., ys] + bb[..., kh + xs]
        p = _softmax_rows(logits).to(dtype).float()
        out = (p @ x[2].float()).to(dtype)  # [H, N, D]
        outs.append(out.permute(1, 0, 2).reshape(n, heads * d))
    return torch.stack(outs)


def global_attention_cuda(qkv: torch.Tensor, bias: torch.Tensor, *,
                          scale: float, heads: int, kh: int,
                          kw: int) -> torch.Tensor:
    """K2 kernel launch (sam_pt_torch/csrc/global_attention.cu); a graph
    replay's announcement (`graph_launches.py`) counts it and returns
    None."""
    if graph_launches.announced(__name__, "global_attention_cuda", qkv,
                                bias, scale=scale, heads=heads, kh=kh,
                                kw=kw):
        LAUNCHES["global"] += 1
        return None
    from ._cuda import check, library

    _check_cuda("global_attention", (qkv, bias))
    b, n, chans = qkv.shape
    d = chans // (3 * heads)
    if (chans != 3 * heads * d or kh * kw != n or kw < 2 or d % 16
            or d > 128 or bias.shape != (b, n, heads, kh + kw)):
        raise ValueError(
            f"global_attention: unsupported shapes {tuple(qkv.shape)}, "
            f"{tuple(bias.shape)}")
    out = torch.empty((b, n, heads * d), dtype=qkv.dtype, device=qkv.device)
    status = library().sam_global_attention(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, kh, kw, heads, d,
        _rounded(scale, qkv.dtype), _stream())
    check(status, "sam_global_attention")
    LAUNCHES["global"] += 1
    return out


def global_attention(qkv: torch.Tensor, rel_h: torch.Tensor,
                     rel_w: torch.Tensor, *, scale: float, kh: int, kw: int,
                     heads: int) -> torch.Tensor:
    """Global ViT rel-pos attention from the fused qkv projection.

    qkv [B, N, 3*H*D] (N = kh*kw, row-major grid, native head dim),
    rel_h [kh, kh, D] and rel_w [kw, kw, D] resolved tables in qkv's dtype.
    Returns [B, N, H*D].
    """
    bias = global_bias(qkv, rel_h, rel_w, heads, kh, kw)
    if qkv.device.type == "cpu":
        return global_attention_plain(qkv, bias, scale=scale, heads=heads,
                                      kh=kh, kw=kw)
    return global_attention_cuda(qkv, bias, scale=scale, heads=heads, kh=kh,
                                 kw=kw)


# ---------------------------------------------------------------------------
# K3: mask-decoder cross-attention
# ---------------------------------------------------------------------------

def cross_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, heads: int, divisor: float,
                          kv_valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch K3 with the TPU kernel's rounding sequence."""
    b, nq, ch = q.shape
    nk = k.shape[1]
    dh = ch // heads
    dtype = q.dtype

    def split(x, n):
        return x.reshape(b, n, heads, dh).permute(0, 2, 1, 3).float()

    logits = (split(q, nq) @ split(k, nk).transpose(-1, -2)).to(dtype)
    logits = logits / _rounded(divisor, dtype)
    if kv_valid is not None:
        logits = torch.where(kv_valid[:, None, None, :].bool(), logits,
                             torch.tensor(-1e9, dtype=dtype, device=q.device))
    p = _softmax_rows(logits.float()).to(dtype).float()
    out = (p @ split(v, nk)).to(dtype)  # [B, H, Nq, dh]
    return out.permute(0, 2, 1, 3).reshape(b, nq, ch)


def cross_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, heads: int, divisor: float,
                         kv_valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """K3 kernel launch (sam_pt_torch/csrc/cross_attention.cu): head dim
    16 (the decoder's cross-attentions) or 32 (its token self-attention,
    which reaches K3 from 1024 tokens)."""
    from ._cuda import check, library

    tensors = (q, k, v) if kv_valid is None else (q, k, v, kv_valid)
    _check_cuda("cross_attention", tensors)
    b, nq, ch = q.shape
    nk = k.shape[1]
    if (ch not in (heads * 16, heads * 32) or q.dtype != torch.bfloat16
            or k.shape != (b, nk, ch) or v.shape != k.shape
            or k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError(
            f"cross_attention: unsupported shapes {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}, heads={heads}")
    mask_ptr = None
    if kv_valid is not None:
        if kv_valid.shape != (b, nk) or kv_valid.dtype != torch.uint8:
            raise ValueError("cross_attention: kv_valid must be uint8 [B, Nk]")
        mask_ptr = kv_valid.data_ptr()
    out = torch.empty_like(q)
    status = library().sam_cross_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        b, nq, nk, heads, ch // heads, _rounded(divisor, q.dtype), _stream())
    check(status, "sam_cross_attention")
    LAUNCHES["cross"] += 1
    if tracing.enabled():
        tracing.count("k3.launches")
        tracing.count("k3.pairs", b)
        tracing.count("k3.keys", nk * b)
    return out


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    heads: int, divisor: float,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention on pre-projected q [B, Nq, H*dh] and k, v
    [B, Nk, H*dh] with merged heads; kv_valid [B, Nk] bool or None masks
    keys to -1e9. Returns [B, Nq, H*dh]."""
    if q.device.type == "cpu":
        return cross_attention_plain(q, k, v, heads=heads, divisor=divisor,
                                     kv_valid=kv_valid)
    if kv_valid is not None:
        kv_valid = kv_valid.to(torch.uint8).contiguous()
    return cross_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), heads=heads, divisor=divisor,
                                kv_valid=kv_valid)


# ---------------------------------------------------------------------------
# K4: rel-pos attention on split q/k/v
# ---------------------------------------------------------------------------

def relpos_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias_h: torch.Tensor, bias_w: torch.Tensor, *,
                           scale: float) -> torch.Tensor:
    """Plain PyTorch K4, in groups of problems that bound the [G, N, N] f32
    logits to 2^28 elements."""
    b, n, _ = q.shape
    kh, kw = bias_h.shape[-1], bias_w.shape[-1]
    dtype = q.dtype
    ys = torch.arange(n, device=q.device) // kw
    xs = torch.arange(n, device=q.device) % kw
    group = max(1, 2 ** 28 // (n * n))
    outs = []
    for i in range(0, b, group):
        sl = slice(i, i + group)
        qs = (q[sl].float() * _rounded(scale, dtype)).to(dtype).float()
        logits = qs @ k[sl].float().transpose(-1, -2)  # [G, N, N]
        logits += bias_h[sl].float()[..., ys] + bias_w[sl].float()[..., xs]
        p = _softmax_rows(logits).to(dtype).float()
        outs.append((p @ v[sl].float()).to(dtype))
    return torch.cat(outs)


def relpos_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias_h: torch.Tensor, bias_w: torch.Tensor, *,
                          scale: float) -> torch.Tensor:
    """K4 kernel launch (sam_pt_torch/csrc/relpos_attention.cu): the window
    body (the whole problem per block) up to 208 tokens with kh + kw < 32,
    the flash body otherwise."""
    from ._cuda import check, library

    _check_cuda("relpos_attention", (q, k, v, bias_h, bias_w))
    b, n, d = q.shape
    kh, kw = bias_h.shape[-1], bias_w.shape[-1]
    if (k.shape != q.shape or v.shape != q.shape or kh * kw != n or d % 16
            or d > 128 or bias_h.shape != (b, n, kh)
            or bias_w.shape != (b, n, kw)):
        raise ValueError(
            f"relpos_attention: unsupported shapes {tuple(q.shape)}, "
            f"{tuple(bias_h.shape)}, {tuple(bias_w.shape)}")
    out = torch.empty_like(q)
    status = library().sam_relpos_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(),
        bias_w.data_ptr(), out.data_ptr(), b, kh, kw, d,
        _rounded(scale, q.dtype), _stream())
    check(status, "sam_relpos_attention")
    LAUNCHES["relpos"] += 1
    return out


def relpos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias_h: torch.Tensor, bias_w: torch.Tensor, *,
                     scale: float) -> torch.Tensor:
    """Attention with the factored rel-pos bias on split heads.

    q, k, v [B, N, D] (B = batch * heads, N = kh * kw row-major tokens);
    bias_h [B, N, kh] and bias_w [B, N, kw] with bias(i, j) =
    bias_h[i, j // kw] + bias_w[i, j % kw]. Returns [B, N, D].
    """
    if q.device.type == "cpu":
        return relpos_attention_plain(q, k, v, bias_h, bias_w, scale=scale)
    return relpos_attention_cuda(q, k, v, bias_h, bias_w, scale=scale)
