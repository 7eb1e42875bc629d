"""K5: LayerNorm over the last axis of narrow rows, with the GELU after it
fused in (`sam_pt_torch/csrc/layer_norm.cu`, built by `ops/_cuda.py`), and
its plain version.

It replaces no TPU kernel: the JAX package's `ops/fast_ln.py` is a trick
for the TPU's matrix unit that the port does not carry over. It serves
every LayerNorm of the SAM modules whose rows are at most `MAX_WIDTH`
wide: the decode chain's channel norms (the upscaling's, HQ-SAM's
`embedding_maskfeature`, the prompt encoder's mask path, the two-way
transformer's), the neck's and HQ-SAM's image-level features. PyTorch's
own kernel gives each row a thread block, which idles most of its threads
on rows of 4 to 256 values.

Route of `layer_norm`: a CUDA tensor whose rows are at most `MAX_WIDTH`
wide launches the kernel, or raises; wider rows (the ViT blocks' 768 to
1280, which PyTorch's kernel runs near bandwidth) and tensors on any other
device take the plain version, so the CPU computes what it always did.
The kernel's launches are counted in `LAUNCHES` (only the CUDA path
counts) and, with the tracer on, as `ln.launches` and `ln.rows` in the
open span.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import tracing

LAUNCHES = {"layer_norm": 0}
# The widest rows the kernel takes (a warp of 16-byte vectors in bf16).
MAX_WIDTH = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 2 ** 30


def reset_launch_counts() -> None:
    LAUNCHES["layer_norm"] = 0


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float,
                     gelu: bool = False) -> torch.Tensor:
    """`F.layer_norm` over the last axis, then, with `gelu`, the exact
    `F.gelu` of its rounded output: the port's path before the kernel."""
    y = F.layer_norm(x, weight.shape, weight, bias, eps)
    return F.gelu(y) if gelu else y


def row_layout(x: torch.Tensor) -> tuple:
    """x's rows as the kernel addresses them: (rows, h, w, s_n, s_h, s_w,
    s_c), row r = (n, i, j) of a leading grid [rows / (h w), h, w] at
    n*s_n + i*s_h + j*s_w elements and channel k at k*s_c more. Leading
    axes merge where their strides allow; more than three that do not
    raise."""
    if x.is_contiguous():
        rows = x.numel() // x.shape[-1]
        return rows, 1, rows, 0, 0, x.shape[-1], 1
    merged = []
    for n, s in zip(x.shape[:-1], x.stride()[:-1]):
        if n == 1:
            continue
        if merged and merged[-1][1] == n * s:
            merged[-1] = (merged[-1][0] * n, s)
        else:
            merged.append((n, s))
    if len(merged) > 3:
        raise ValueError(f"layer_norm: the leading axes of shape "
                         f"{tuple(x.shape)}, strides {x.stride()} do not "
                         f"merge into three")
    (nn, s_n), (h, s_h), (w, s_w) = [(1, 0)] * (3 - len(merged)) + merged
    return nn * h * w, h, w, s_n, s_h, s_w, x.stride(-1)


_ENTRY = []  # (the C entry point, the current stream), bound at first use


def layer_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float,
                    gelu: bool = False) -> torch.Tensor:
    """K5 kernel launch: x [..., C] (C <= MAX_WIDTH, bf16 or float32, any
    strides), weight and bias [C] contiguous in x's dtype. Returns a
    contiguous tensor of x's shape. The decode chain queues a dozen of
    these a pass from the host, so the checks are cheap ones and the
    stream is read raw."""
    if not _ENTRY:
        from ._cuda import library

        stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda i: torch.cuda.current_stream(i).cuda_stream)
        _ENTRY.extend((library().sam_layer_norm, stream))
    c, dtype, device = x.shape[-1], x.dtype, x.get_device()
    code = _DTYPES.get(dtype)
    if device < 0 or weight.get_device() != device or (
            bias.get_device() != device):
        raise ValueError("layer_norm: all inputs must be on one CUDA device")
    if code is None or weight.dtype != dtype or bias.dtype != dtype:
        raise TypeError(f"layer_norm: the kernel takes bfloat16 or float32 "
                        f"with weights of the same type, not {dtype}, "
                        f"{weight.dtype}, {bias.dtype}")
    if (not 1 <= c <= MAX_WIDTH or weight.shape != (c,)
            or bias.shape != (c,) or not weight.is_contiguous()
            or not bias.is_contiguous()):
        raise ValueError(f"layer_norm: unsupported shapes {tuple(x.shape)}, "
                         f"{tuple(weight.shape)}, {tuple(bias.shape)}")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return out
    rows, h, w, s_n, s_h, s_w, s_c = row_layout(x)
    if rows > _MAX_ROWS:
        raise ValueError(f"layer_norm: {rows} rows, more than {_MAX_ROWS}")
    status = _ENTRY[0](
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        rows, c, h, w, s_n, s_h, s_w, s_c, eps, gelu, code,
        _ENTRY[1](device))
    if status:
        raise RuntimeError(f"sam_layer_norm: CUDA error {status} at launch")
    LAUNCHES["layer_norm"] += 1
    if tracing.enabled():
        tracing.count("ln.launches")
        tracing.count("ln.rows", rows)
    return out


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, gelu: bool = False) -> torch.Tensor:
    """LayerNorm of x [..., C] over C with float32 statistics and affine,
    rounded once to x's dtype (weight and bias are cast to it first), then
    with `gelu` the exact GELU of that, rounded again."""
    if weight.dtype != x.dtype:
        weight = weight.to(x.dtype)
    if bias.dtype != x.dtype:
        bias = bias.to(x.dtype)
    if x.is_cuda and x.shape[-1] <= MAX_WIDTH:
        return layer_norm_cuda(x, weight, bias, eps, gelu)
    return layer_norm_plain(x, weight, bias, eps, gelu)
