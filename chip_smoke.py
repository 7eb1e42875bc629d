"""Smoke run of the PyTorch port on one CUDA card: its kernels, its main
path, and each later path, each with its own launch counts.

    python3 chip_smoke.py            # full run (needs one CUDA card)
    python3 chip_smoke.py --profile  # full run + stage splits and profiles

Phases, in order; any failure exits non-zero before the verdict line:
  1. The card's name and power limit (nvidia-smi), torch/CUDA versions.
  2. Build the CUDA kernels from `sam_pt_torch/csrc` (nvcc, sm_90a).
  3. Kernel phase: the window and flash bodies' resident blocks per SM at
     ViT-H's shapes and K3 image->token's at the decoder's 8 heads, then
     K1/K2/K3 against their plain PyTorch versions at the main path's
     shapes in bf16 (seeded inputs), K4 in both its regimes
     (ViT-H global width, 64 x 4096 x 80; ViT-H windows, 1600 x 196 x 80),
     max abs error against a stated tolerance, and CUDA-event times
     (single calls, median of 5 runs) of the kernel, its plain version and
     one PyTorch call of the same function (`scaled_dot_product_attention`
     on head-split views, the rel-pos bias as a materialised mask), the
     kernel and that call also over 50 back-to-back calls (`loop_ms`,
     with the host's time a call to queue them) and, with --profile, by
     the profiler's device time (`profiled_ms`), beside the kernel's bound
     (`attention_roofline`).
  4. Slice phase: the port's SamPt (SAM ViT-H + CoTracker, random bf16
     weights from a seeded generator, two output biases set so that points
     are visible and masks pass the IoU gate) over two DAVIS-shaped 480 x 854
     videos (24 frames x 1 object, 35 x 3), then device fusion to uint8
     index masks. Launch counts are reset just before and read just after,
     and must equal the schedule's counts. A second, timed pass gives the
     wall time and frames/s.
  5. Reference phase: the first video's first encode chunk and first
     decode chunk again, with the kernels' plain versions in place of the
     kernels, against the kernel outputs.
  6. Query-points phase: the main-path SamPt over a 24 x 1 video given as
     17 query points on frame 0, with the same checks.
  7. K4 route phase: one ViT-H-width `Attention` (1280 wide, 16 heads x
     80, a 64 x 64 grid, 4 frames, bf16, seeded weights) through the
     raw-qkv route (K2) and its default route (K4): the outputs agree and
     each kernel launched once.
  8. Reinit phase: the reinit factory (`build.REINIT_SETTINGS`, the same
     weights, the last mask-upscaling bias zeroed so that masks are not
     empty) over a DAVIS-shaped 36-frame x 2-object video with query masks
     on frames 0 and 12 (so the flipped pass runs): output checks, the
     horizon windows per direction, launches equal to one encode and to
     the decode chunks of the windows, and a timed second pass.
Then one JSON line with the per-kernel numbers, and as the last line
{"ok": true, "device": {...}}. The kernel phase alone:

    python3 -c "import torch, chip_smoke; from sam_pt_torch.ops import \
flash_attention as fa; chip_smoke.build_phase(); \
chip_smoke.kernel_phase(fa, torch.device('cuda'))"
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel vs plain version on the same bf16 inputs: |got - ref| <= ATOL +
# RTOL * |ref| everywhere. Both normalise p before rounding it to bf16
# and round the output once, so they differ where f32 sums in another
# order, or ex2.approx against exp, tip a rounding of p or of the output
# (one output ulp is up to 2^-7 relative): two ulps, plus 1e-2 for values
# near 0.
ATOL, RTOL = 1e-2, 2 ** -6
# Per-kernel numbers of the JSON line (a second case adds a suffix): `ms`,
# `plain_ms` and `library_ms` time single calls (`cuda_ms`), `loop_ms` and
# `library_loop_ms` back-to-back calls (`loop_ms`).
TIMES = ("ms", "loop_ms", "plain_ms", "library_ms", "library_loop_ms",
         "bound_ms", "bound_by")
VIDEOS = [(24, 1), (35, 3)]  # (frames, objects) at 480 x 854
H, W = 480, 854
# One H100 SXM at its 700 W limit (NVIDIA's data sheet): dense bf16 tensor
# cores and HBM3 bandwidth.
PEAK_BF16_FLOP_S = 989e12
PEAK_BYTES_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of `fn` in ms, after one warm-up call. The
    events enclose one call from the host, so the time includes the host
    work that comes before the launch (the wrapper's checks, the output's
    allocation, the ctypes call) where that is longer than the queue."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def loop_ms(fn, calls: int = 50) -> tuple:
    """The CUDA-event time of `calls` back-to-back calls of `fn` divided by
    `calls`, in ms, after one warm-up call: one event before the first
    call and one after the last, so the host's work for each call overlaps
    the device's work for the calls queued before it. Also the host's time
    a call to queue them: where that is as long, the host bounds the
    loop."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls, host * 1e3 / calls


def self_cuda_us(table: str) -> float:
    """The device time of a torch.profiler table, from its own footer
    (operators and the kernels they launch both carry device time, so a
    sum over the rows would count it twice)."""
    found = re.search(r"Self CUDA time total: ([0-9.]+)(us|ms|s)", table)
    return float(found.group(1)) * {"us": 1, "ms": 1e3,
                                    "s": 1e6}[found.group(2)]


def profiled_ms(fn, calls: int = 20) -> float:
    """Device time a call of `fn` in ms by torch.profiler (the kernels'
    own durations, no launch or host time), over `calls` calls after one
    warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return self_cuda_us(prof.key_averages().table()) / 1e3 / calls


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def attention_roofline(problems: int, nq: int, nk: int, d: int,
                       nbytes: int) -> dict:
    """The least time one H100 could take for `problems` attentions of nq
    queries against nk keys at head dim d (q.k^T and p.v, a multiply-add
    = 2 operations) that move `nbytes` (each input read once, the output
    written once): the larger of the two times, and what bounds it."""
    flop = 4 * problems * nq * nk * d
    ops_ms = flop / PEAK_BF16_FLOP_S * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    return {"flop": flop, "bytes": nbytes, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def materialised_bias(bias_h, bias_w):
    """[..., N, kh] and [..., N, kw] -> the additive mask [..., N, kh*kw]
    with mask[.., i, j] = bias_h[.., i, j // kw] + bias_w[.., i, j % kw],
    summed in f32 and stored in their dtype, one leading index at a time."""
    kh, kw = bias_h.shape[-1], bias_w.shape[-1]
    n = kh * kw
    ys = torch.arange(n, device=bias_h.device) // kw
    xs = torch.arange(n, device=bias_h.device) % kw
    mask = torch.empty((*bias_h.shape[:-1], n), dtype=bias_h.dtype,
                       device=bias_h.device)
    for i in range(bias_h.shape[0]):
        mask[i] = bias_h[i].float()[..., ys] + bias_w[i].float()[..., xs]
    return mask


# The library yardsticks: one `scaled_dot_product_attention` call on
# head-split views computing each kernel's function, its mask built here,
# before the call is timed. The port never calls it.

def library_fused_qkv(qkv, bias, *, scale, heads, kh):
    """K1 and K2: qkv [B, N, 3*H*d], bias [B, N, H, kh + kw]."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    b, n, chans = qkv.shape
    x = qkv.view(b, n, 3, heads, chans // (3 * heads)).permute(2, 0, 3, 1, 4)
    split = bias.permute(0, 2, 1, 3)  # [B, H, N, kh + kw]
    mask = materialised_bias(split[..., :kh], split[..., kh:])
    return lambda: sdpa(x[0], x[1], x[2], attn_mask=mask, scale=scale)


def library_relpos(q, k, v, bias_h, bias_w, *, scale):
    """K4: q, k, v [B, N, d], bias_h [B, N, kh], bias_w [B, N, kw]."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    mask = materialised_bias(bias_h, bias_w)[:, None]
    return lambda: sdpa(q[:, None], k[:, None], v[:, None], attn_mask=mask,
                        scale=scale)


def library_cross(q, k, v, *, heads, divisor, kv_valid=None):
    """K3: q [B, Nq, H*16], k and v [B, Nk, H*16], kv_valid [B, Nk]."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    def split(x):
        b, n, chans = x.shape
        return x.view(b, n, heads, chans // heads).transpose(1, 2)

    mask = None if kv_valid is None else kv_valid.bool()[:, None, None, :]
    qh, kh, vh = split(q), split(k), split(v)
    return lambda: sdpa(qh, kh, vh, attn_mask=mask, scale=1.0 / divisor)


def relpos_inputs(randn, b, kh, kw, d=80):
    """K4's operands as the `Attention` default route makes them: split
    q/k/v [b, N, d] and the two bias einsums over tables [k, k, d]."""
    q, k, v = (randn(b, kh * kw, d) for _ in range(3))
    rh, rw = randn(kh, kh, d, std=0.2), randn(kw, kw, d, std=0.2)
    rq = q.reshape(b, kh, kw, d)
    bias_h = torch.einsum("bhwc,hkc->bhwk", rq, rh).reshape(b, -1, kh)
    bias_w = torch.einsum("bhwc,wkc->bhwk", rq, rw).reshape(b, -1, kw)
    return q, k, v, bias_h.contiguous(), bias_w.contiguous()


def kernel_cases(fa, device) -> dict:
    """Name -> a function that makes one case at the main path's shapes:
    the kernel, its plain version and its library yardstick as calls, the
    inputs they read and (problems, nq, nk, d) for the bound. Made one at
    a time, so that each case's inputs (K2's and K4's masks are 2.1 GB)
    are freed before the next."""
    g = torch.Generator(device=device).manual_seed(1)

    def randn(*shape, std=1.0):
        return (std * torch.randn(shape, generator=g, device=device)
                ).to(torch.bfloat16)

    def window():  # K1: 25 windows x 4 frames, 196 tokens, 16 heads x 80
        qkv = randn(100, 196, 3 * 16 * 80)
        rh, rw = randn(14, 14, 80, std=0.2), randn(14, 14, 80, std=0.2)
        bias = fa.window_bias(qkv, rh, rw, 16)
        kw = dict(scale=80 ** -0.5, heads=16)
        return (lambda: fa.window_attention_cuda(qkv, bias, **kw),
                lambda: fa.window_attention_plain(qkv, bias, **kw),
                library_fused_qkv(qkv, bias, kh=14, **kw),
                (qkv, bias), (100 * 16, 196, 196, 80))

    def global_():  # K2: 4 frames of 64 x 64 tokens, 16 heads x 80
        qkv = randn(4, 4096, 3 * 16 * 80)
        rh, rw = randn(64, 64, 80, std=0.2), randn(64, 64, 80, std=0.2)
        bias = fa.global_bias(qkv, rh, rw, 16, 64, 64)
        kw = dict(scale=80 ** -0.5, heads=16)
        return (lambda: fa.global_attention_cuda(qkv, bias, kh=64, kw=64,
                                                 **kw),
                lambda: fa.global_attention_plain(qkv, bias, kh=64, kw=64,
                                                  **kw),
                library_fused_qkv(qkv, bias, kh=64, **kw),
                (qkv, bias), (4 * 16, 4096, 4096, 80))

    # K3: 48 pairs, 8 heads x 16; 60 prompt + output tokens, 4096 image
    # tokens. Token -> image unmasked, with k and v distinct as in the
    # decoder (keys + key_pe against keys); image -> token with a key mask
    # (padded prompts) and without (one object), two kernel instances.
    kc = dict(heads=8, divisor=4.0)

    def cross():
        tok, k, v = randn(48, 60, 128), randn(48, 4096, 128), randn(
            48, 4096, 128)
        return (lambda: fa.cross_attention_cuda(tok, k, v, **kc),
                lambda: fa.cross_attention_plain(tok, k, v, **kc),
                library_cross(tok, k, v, **kc),
                (tok, k, v), (48 * 8, 60, 4096, 16))

    def cross_masked(masked=True):
        img, k, v = randn(48, 4096, 128), randn(48, 60, 128), randn(
            48, 60, 128)
        valid = torch.rand((48, 60), generator=g, device=device) > 0.3
        valid[:, :5] = True
        valid_u8 = valid.to(torch.uint8)
        if not masked:
            valid = valid_u8 = None
        return (lambda: fa.cross_attention_cuda(img, k, v, kv_valid=valid_u8,
                                                **kc),
                lambda: fa.cross_attention_plain(img, k, v, kv_valid=valid,
                                                 **kc),
                library_cross(img, k, v, kv_valid=valid, **kc),
                tuple(t for t in (img, k, v, valid_u8) if t is not None),
                (48 * 8, 4096, 60, 16))

    # K4 from 1024 tokens (flash): 4 frames x 16 heads over 64 x 64 tokens;
    # below (whole problem per block): 100 windows x 16 heads of 14 x 14.
    def relpos(b, kh, kw):
        ops = relpos_inputs(randn, b, kh, kw)
        s = 80 ** -0.5
        return (lambda: fa.relpos_attention_cuda(*ops, scale=s),
                lambda: fa.relpos_attention_plain(*ops, scale=s),
                library_relpos(*ops, scale=s),
                ops, (b, kh * kw, kh * kw, 80))

    return {"window": window, "global": global_, "cross": cross,
            "cross_masked": cross_masked,
            "cross_unmasked": lambda: cross_masked(False),
            "relpos": lambda: relpos(64, 64, 64),
            "relpos_window": lambda: relpos(1600, 14, 14)}


def build_phase() -> None:
    """Build the kernels; print the time and ptxas's registers, shared
    memory and spills per kernel."""
    from sam_pt_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({'built' if _cuda.BUILD_INFO['built'] else 'cached'}) "
        f"{_cuda.BUILD_INFO['path']}")
    for line in _cuda.BUILD_INFO.get("log", "").splitlines():
        if ("registers" in line or "smem" in line or "spill" in line
                or "Compiling entry" in line):
            log(f"  ptxas: {line.strip()}")


def kernel_phase(fa, device, profiling: bool = False) -> dict:
    """The window and flash bodies' resident blocks per SM at ViT-H's
    shapes and K3 image->token's at SAM's, then each case of
    `kernel_cases`: agreement with the plain version, times (with
    `profiling`, also the profiler's device time), bound."""
    from sam_pt_torch.ops import _cuda

    blocks = _cuda.library().sam_window_blocks_per_sm(14, 14, 80)
    log(f"kernel window body: {blocks} blocks resident per SM at 14 x 14 "
        f"tokens, head dim 80 (occupancy calculator)")
    if blocks < 1:
        raise SystemExit("the window body cannot run at ViT-H's windows")
    blocks = _cuda.library().sam_flash_blocks_per_sm(64, 64, 80)
    log(f"kernel flash body: {blocks} blocks resident per SM at 64 x 64 "
        f"tokens, head dim 80 (occupancy calculator)")
    if blocks < 1:
        raise SystemExit("the flash body cannot run at ViT-H's global grid")
    for masked in (True, False):
        blocks = _cuda.library().sam_cross_i2t_blocks_per_sm(8, masked, True)
        log(f"kernel K3 image->token: {blocks} blocks resident per SM at 8 "
            f"heads x 16, {'with' if masked else 'without'} the key mask "
            f"(occupancy calculator)")
        if blocks < 1:
            raise SystemExit("K3 image->token cannot run at SAM's heads")
    report = {}
    for name, make in kernel_cases(fa, device).items():
        kernel, plain, library, inputs, shape = make()
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        diff = (got.float() - ref.float()).abs()
        err = float(diff.max())
        ratio = float((diff / (ATOL + RTOL * ref.float().abs())).max())
        ok = bool(torch.isfinite(got.float()).all()) and ratio <= 1.0
        roof = attention_roofline(*shape, tensor_bytes(*inputs, got))
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain)
        library_ms = cuda_ms(library)
        (kernel_loop, kernel_host), (library_loop, library_host) = (
            loop_ms(kernel), loop_ms(library))
        profiled = ""
        if profiling:
            profiled = (f"; device time by the profiler: kernel "
                        f"{profiled_ms(kernel):.4f} ms library "
                        f"{profiled_ms(library):.4f} ms")
        log(f"kernel {name}: {got.dtype} shape {tuple(got.shape)} "
            f"max_abs_err {err:.3e} (|err| <= {ATOL:g} + {RTOL:g}|ref|: "
            f"worst {ratio:.3f} of the bound) kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms library {library_ms:.4f} ms "
            f"(kernel / library {ms / library_ms:.2f}); back to back: "
            f"kernel {kernel_loop:.4f} ms library {library_loop:.4f} ms "
            f"(kernel / library {kernel_loop / library_loop:.2f}; host "
            f"{kernel_host:.4f} and {library_host:.4f} ms a call to queue "
            f"them){profiled}; bound "
            f"{roof['bound_ms']:.4f} ms by {roof['bound_by']} "
            f"({roof['flop'] / 1e9:.2f} GFLOP, {roof['bytes'] / 1e6:.1f} MB; "
            f"{100 * roof['bound_ms'] / ms:.1f}% of it) "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"kernel {name} disagrees with its plain version")
        report[name] = dict(max_abs_err=err, ms=ms, loop_ms=kernel_loop,
                            plain_ms=plain_ms, library_ms=library_ms,
                            library_loop_ms=library_loop,
                            bound_ms=roof["bound_ms"],
                            bound_by=roof["bound_by"])
        del kernel, plain, library, inputs, got, ref, diff
        torch.cuda.empty_cache()
    return report


def make_video(n_frames: int, n_masks: int, seed: int,
               query_ts=None) -> dict:
    """DAVIS-shaped synthetic video: random frames, box query masks on
    frame 0 or on frames `query_ts` (the shapes of bench.py's schedule)."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((n_masks, H, W), np.float32)
    for i in range(n_masks):
        r0 = 30 + (i * 83) % (H - 150)
        c0 = 60 + (i * 157) % (W - 420)
        masks[i, r0:r0 + 110, c0:c0 + 360] = 1
    return {
        "image": rng.integers(0, 255, (n_frames, H, W, 3)).astype(np.uint8),
        "target_hw": (H, W),
        "query_masks": masks,
        "query_point_timestep": np.asarray(
            query_ts if query_ts is not None else [0] * n_masks, np.float32),
    }


def launch_schedule(sam_pt, encodes, decodes) -> dict:
    """Kernel launches of encode calls over `encodes` frames each and
    decode calls over `decodes` pairs each: K1 28 and K2 4 per encode
    chunk, K3 5 per decoder pass and decode chunk, no K4."""
    ec, dc = sam_pt.sam_encode_chunk, sam_pt.sam_decode_chunk
    enc = sum(-(-t // ec) for t in encodes)
    dec = sum(-(-n // min(dc, n)) for n in decodes)
    passes = 2 + sam_pt.iterative_refinement_iterations
    return {"window": 28 * enc, "global": 4 * enc, "cross": 5 * passes * dec,
            "relpos": 0}


def bias_for_a_live_run(sam_pt) -> None:
    """With N(0, 0.02^2) weights every point would be invisible (sigmoid ~
    0.5 < 0.7) and every IoU below the 0.7 gate, so no prompt would reach
    the decoder's visible-point paths and every plane would be gated.
    Two output biases are set so that both paths are live."""
    with torch.no_grad():
        sam_pt.point_tracker.model.vis_predictor[0].bias.fill_(3.0)
        sam_pt.sam_predictor.model.mask_decoder.iou_prediction_head.layers[
            -1].bias.fill_(1.0)


def run_video(sam_pt, video, fuse):
    out = sam_pt.forward(video)
    if "query_masks" in video:
        gt, ts = video["query_masks"], video["query_point_timestep"]
    else:  # query points: no ground-truth mask to paste on the query frame
        n_masks = video["query_points"].shape[0]
        gt = np.zeros((n_masks, H, W), np.float32)
        ts = video["query_points"][:, 0, 0]
    return out, fuse(out["logits"], gt, [int(t) for t in ts])


def check_outputs(out, masks, n_frames, n_masks, n_points, query_ts=None):
    """Shapes and values of one forward. IoU scores must be finite wherever
    a prompt was visible, on the frames each object's own pass scored:
    from its query frame on with re-initialisation (`query_ts`), whose
    stitch keeps the backward pass's scores unflipped before it, as the
    JAX package does; every frame otherwise."""
    from sam_pt_torch.utils.util import PointVisibilityType

    shapes = {
        "logits": (n_masks, n_frames, H, W),
        "trajectories": (n_frames, n_masks, n_points, 2),
        "visibilities": (n_frames, n_masks, n_points),
        "scores_per_frame": (n_frames, n_masks),
        "scores": (n_masks,),
    }
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise SystemExit(f"{key}: shape {tuple(out[key].shape)} != {shape}")
    if out["logits"].dtype != torch.float16:
        raise SystemExit("logits are not float16")
    spf = out["scores_per_frame"]
    rows = torch.arange(n_frames, device=spf.device)[:, None]
    own = rows >= torch.as_tensor(
        query_ts if query_ts is not None else [0] * n_masks,
        device=spf.device)[None, :]
    visible = ~torch.isneginf(spf) & own  # -inf: no visible prompt
    if not bool(torch.isfinite(spf[visible]).all()) or not bool(visible.any()):
        raise SystemExit("IoU scores not finite where a prompt was visible")
    kinds = {float(v) for v in PointVisibilityType}
    found = set(torch.unique(out["visibilities"]).tolist())
    if not found <= kinds:
        raise SystemExit(f"visibilities {sorted(found - kinds)} are no "
                         f"PointVisibilityType")
    if not bool(torch.isfinite(out["trajectories"]).all()):
        raise SystemExit("trajectories not finite")
    logits = out["logits"]
    if bool(torch.isnan(logits).any()):
        raise SystemExit("NaN logits")
    if masks.shape != (n_frames, H, W) or masks.dtype != np.uint8 or int(
            masks.max()) > n_masks:
        raise SystemExit(f"bad index masks {masks.shape} {masks.dtype}")
    return (f"logits {tuple(logits.shape)} float16, trajectories "
            f"{tuple(out['trajectories'].shape)}, index masks {masks.shape} "
            f"uint8, {int(visible.sum())}/{visible.numel()} pairs scored, "
            f"{int((~torch.isneginf(logits.flatten(2)).all(-1)).sum())} "
            f"planes kept by the IoU gate, labels {sorted(np.unique(masks))}, "
            f"visibilities {sorted(found)}")


def reference_phase(sam_pt, fa, video) -> None:
    """Encode chunk and decode chunk with kernels vs with plain versions."""
    predictor = sam_pt.sam_predictor
    device = sam_pt.device
    frames = torch.from_numpy(video["image"][:4]).to(device)
    hw = (H, W)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    emb_k = predictor.encode_frames(frames, hw)
    plain = {
        "window_attention_cuda": fa.window_attention_plain,
        "global_attention_cuda": fa.global_attention_plain,
        "cross_attention_cuda": lambda q, k, v, kv_valid=None, **kw:
            fa.cross_attention_plain(
                q, k, v, kv_valid=None if kv_valid is None
                else kv_valid.bool(), **kw),
    }
    saved = {name: getattr(fa, name) for name in plain}
    try:
        for name, fn in plain.items():
            setattr(fa, name, fn)
        emb_p = predictor.encode_frames(frames, hw)
    finally:
        for name, fn in saved.items():
            setattr(fa, name, fn)
    e = rel(emb_k, emb_p)
    log(f"reference: encoder embeddings kernels vs plain rel_l2 {e:.3e}")

    rng = np.random.default_rng(3)
    b = 8
    pts = torch.as_tensor(rng.uniform(0, [W, H], (b, 18, 2)),
                          dtype=torch.float32, device=device)
    lbl = torch.as_tensor(np.r_[[1] * 16, 0, -1][None].repeat(b, 0),
                          device=device)
    emb = emb_k[torch.arange(b, device=device) % 4]
    up_k, iou_k = sam_pt._chain(emb, pts, lbl, hw)
    try:
        for name, fn in plain.items():
            setattr(fa, name, fn)
        up_p, iou_p = sam_pt._chain(emb, pts, lbl, hw)
    finally:
        for name, fn in saved.items():
            setattr(fa, name, fn)
    d_iou = float((iou_k - iou_p).abs().max())
    agree = float(((up_k > 0) == (up_p > 0)).float().mean())
    log(f"reference: decode chain kernels vs plain: iou max diff {d_iou:.3e}, "
        f"mask agreement {agree:.5f}, logits rel_l2 {rel(up_k, up_p):.3e}")
    if not (e < 5e-2 and d_iou < 5e-2 and agree > 0.99):
        raise SystemExit("kernel path disagrees with the plain path")


# The two routes of one Attention run the same flash body on the same bf16
# q, k and v; only the bias einsums differ, in layout ([B, N, H, kh + kw]
# from the fused qkv against [B*H, N, kh] from split heads), and may round
# a bias value one bf16 ulp apart.
ROUTE_REL_L2 = 1e-2


def route_phase(fa, device) -> dict:
    """One ViT-H-width Attention, 4 frames over a 64 x 64 grid in bf16,
    through the raw-qkv route (K2) and its default route (K4)."""
    from sam_pt_torch.models.sam.image_encoder import Attention

    g = torch.Generator(device=device).manual_seed(4)
    c, heads, grid = 1280, 16, 64

    def randn(*shape, std):
        return std * torch.randn(shape, generator=g, device=device)

    state = {"qkv.weight": randn(3 * c, c, std=c ** -0.5),
             "qkv.bias": randn(3 * c, std=0.1),
             "proj.weight": randn(c, c, std=c ** -0.5),
             "proj.bias": randn(c, std=0.1),
             "rel_pos_h": randn(2 * grid - 1, c // heads, std=0.2),
             "rel_pos_w": randn(2 * grid - 1, c // heads, std=0.2)}
    routes = {}
    for name, raw in (("raw_qkv", True), ("default", False)):
        attn = Attention(c, heads, (grid, grid), raw_qkv=raw)
        attn.load_state_dict(state)
        routes[name] = attn.to(device, torch.bfloat16).eval()
    x = randn(4, grid * grid, c, std=1.0).to(torch.bfloat16)
    with torch.no_grad():
        fa.reset_launch_counts()
        outs = {name: attn(x, (grid, grid)) for name, attn in routes.items()}
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        ms = {name: cuda_ms(lambda attn=attn: attn(x, (grid, grid)))
              for name, attn in routes.items()}
    ref, got = outs["raw_qkv"].float(), outs["default"].float()
    rel = float((got - ref).norm() / ref.norm())
    ok = (rel <= ROUTE_REL_L2 and bool(torch.isfinite(got).all())
          and launches == {"window": 0, "global": 1, "cross": 0, "relpos": 1})
    log(f"route: Attention 1280 x 16 heads, 4 x 64 x 64 bf16: K4 route vs "
        f"K2 route rel_l2 {rel:.3e} (bound {ROUTE_REL_L2:g}), launches "
        f"{launches}, whole block K2 route {ms['raw_qkv']:.4f} ms, K4 route "
        f"{ms['default']:.4f} ms {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the K4 route disagrees with the K2 route")
    return launches


def reinit_phase(fa, device, fuse, card: str, profiling: bool) -> None:
    """The reinit configuration at full width over 36 frames x 2 objects,
    query masks on frames 0 and 12."""
    from sam_pt_torch.build import REINIT_SETTINGS, build_sam_pt

    sam_pt = build_sam_pt(device, dtype=torch.bfloat16, seed=0,
                          **REINIT_SETTINGS)
    bias_for_a_live_run(sam_pt)
    # With every weight N(0, 0.02^2) the last upscaling conv's bias
    # outweighs its input, so every predicted mask is empty and every
    # re-initialisation samples from an empty mask. Zeroed, the masks cover
    # part of each frame and the points are re-sampled from them.
    with torch.no_grad():
        sam_pt.sam_predictor.model.mask_decoder.output_upscaling[
            3].bias.zero_()
    t, m, query_ts = 36, 2, [0, 12]
    video = make_video(t, m, seed=5, query_ts=query_ts)
    n_points = sam_pt.positive_points_per_mask + sam_pt.negative_points_per_mask

    fa.reset_launch_counts()
    out, masks = run_video(sam_pt, video, fuse)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    windows = list(sam_pt.reinit_windows)
    for direction in ("forward", "backward"):
        log(f"reinit: {direction} windows (start, end, masks): "
            + ", ".join(f"({a}, {b}, {k})" for d, a, b, k in windows
                        if d == direction))
    expected = launch_schedule(sam_pt, [t],
                               [(b - a) * k for _, a, b, k in windows])
    log(f"reinit: launches {launches} expected {expected}")
    if launches != expected or {d for d, *_ in windows} != {"forward",
                                                             "backward"}:
        raise SystemExit("reinit: launches or windows differ")
    log(f"reinit: video {t} frames x {m} objects, query frames {query_ts}: "
        + check_outputs(out, masks, t, m, n_points, query_ts))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_video(sam_pt, video, fuse)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"reinit: timed pass {wall:.3f} s for {t} frames = {t / wall:.3f} "
        f"frames/s, {len(sam_pt.reinit_windows)} windows, on {card}")
    if profiling:  # serialized split by stage, then the profiler
        stages = {}

        def timed(name, fn):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
                return out
            return run

        names = ("_encode_all_frames", "_track_points", "_apply_sam",
                 "extract_query_points")
        for name in names:
            setattr(sam_pt, name, timed(name, getattr(sam_pt, name)))
        t0 = time.perf_counter()
        run_video(sam_pt, video, fuse)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        for name in names:
            delattr(sam_pt, name)
        log(f"profile reinit_{t}x{m}: serialized {total:.4f} s: " + ", ".join(
            f"{k} {v:.4f} ({100 * v / total:.1f}%)" for k, v in stages.items())
            + f", rest {total - sum(stages.values()):.4f}")
        device_profile(f"reinit_{t}x{m}",
                       lambda: run_video(sam_pt, video, fuse), card)
    del sam_pt
    torch.cuda.empty_cache()


def query_points_phase(sam_pt, fa, fuse) -> None:
    """The main-path SamPt over 24 frames given 17 query points of one
    object on frame 0."""
    t, n_points = 24, 17
    rng = np.random.default_rng(7)
    video = make_video(t, 1, seed=6)
    del video["query_masks"], video["query_point_timestep"]
    xy = rng.uniform([60, 30], [420, 140], (1, n_points, 2))
    video["query_points"] = np.concatenate(
        [np.zeros((1, n_points, 1)), xy], axis=2).astype(np.float32)
    fa.reset_launch_counts()
    out, masks = run_video(sam_pt, video, fuse)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    # the query frame's decode (one pair), then the video's
    expected = launch_schedule(sam_pt, [t], [1, t])
    log(f"query points: launches {launches} expected {expected}")
    if launches != expected:
        raise SystemExit("query points: launch counts differ")
    log(f"query points: video {t} frames, {n_points} points on frame 0: "
        + check_outputs(out, masks, t, 1, n_points))


def profile_phase(sam_pt, video, fuse, card: str) -> None:
    """Serialized stage split of one video, then a torch.profiler pass:
    device time by kernel and the device busy share."""
    images = video["image"]
    t, h, w, _ = images.shape
    m = video["query_masks"].shape[0]
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    images_dev = timed("upload", lambda: torch.from_numpy(images).to(
        sam_pt.device))
    emb = timed("sam_encode", lambda: sam_pt._encode_all_frames(images_dev))
    qp = timed("query_sampling_host", lambda: sam_pt.extract_query_points(
        images, video["query_masks"], video["query_point_timestep"]))
    traj, vis = timed("tracker", lambda: sam_pt._track_points_device(
        images_dev, qp, (h, w)))
    logits, _ = timed("sam_decode_chain", lambda: sam_pt._apply_sam_device(
        (h, w), traj, vis, emb))
    timed("fusion_download", lambda: fuse(logits.half(), video["query_masks"],
                                          [0] * m))
    total = sum(stages.values())
    log(f"profile {t}x{m}: serialized stages (s): " + ", ".join(
        f"{k} {v:.4f} ({100 * v / total:.1f}%)" for k, v in stages.items()))

    device_profile(f"{t}x{m}", lambda: run_video(sam_pt, video, fuse), card)


def device_profile(label: str, run, card: str) -> None:
    """One `run()` under torch.profiler: wall, device busy share, the top
    kernels by device time and the port's own; the table goes to
    chiprun_out/profile_<label>.txt."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    table = events.table(sort_by="self_cuda_time_total", row_limit=60)
    device_us = self_cuda_us(table)
    log(f"profile {label}: wall {wall:.4f} s under the profiler, device "
        f"busy {device_us / 1e6:.4f} s = {100 * device_us / 1e6 / wall:.1f}% "
        f"on {card}")
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)
    # The 12 largest, then the port's own kernels (namespace sampt) below.
    shown = [e for e in top[:12] if e.self_device_time_total > 0]
    shown += [e for e in top[12:] if "sampt::" in e.key
              and e.self_device_time_total > 0]
    for e in shown:
        log(f"  device {e.self_device_time_total / 1e3:10.3f} ms "
            f"{100 * e.self_device_time_total / device_us:5.1f}% "
            f"x{e.count:<6d} {e.key[:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/profile_{label}.txt", "w") as f:
        f.write(table)


# JSON row -> (source, the TPU function it replaces)
KERNEL_SOURCES = {
    "window": ("sam_pt_torch/csrc/window_attention.cu",
               "sam_pt_tpu/ops/flash_attention.py:542"),
    "global": ("sam_pt_torch/csrc/global_attention.cu",
               "sam_pt_tpu/ops/flash_attention.py:219"),
    "cross": ("sam_pt_torch/csrc/cross_attention.cu",
              "sam_pt_tpu/ops/flash_attention.py:381"),
    "relpos": ("sam_pt_torch/csrc/relpos_attention.cu",
               "sam_pt_tpu/ops/flash_attention.py:87"),
}


def kernel_json(report: dict, launches: dict, route_launches: dict) -> list:
    """The kernel line's rows: per kernel its launches on the main path
    (K4: in the route phase), the worst error of its cases and each
    case's `TIMES`, the second case's with a suffix."""
    kernels = []
    for key, (source, replaces) in KERNEL_SOURCES.items():
        r = report[key]
        entry = {"name": f"{key}_attention", "route": "cuda",
                 "source": source, "replaces": replaces,
                 "launches": launches[key], "max_abs_err": r["max_abs_err"],
                 **{f: r[f] for f in TIMES}}
        # K3 token->image above and image->token (masked) here; K4 flash
        # above and window here, launched by the route phase, not the slice.
        second = {"cross": ("cross_masked", "_image_to_token"),
                  "relpos": ("relpos_window", "_window")}.get(key)
        if second:
            m = report[second[0]]
            entry["max_abs_err"] = max(r["max_abs_err"], m["max_abs_err"])
            entry.update({f + second[1]: m[f] for f in TIMES})
        # Image->token without the mask: its error counts, its times are
        # only logged.
        if key == "cross":
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       report["cross_unmasked"]["max_abs_err"])
        if key == "relpos":
            entry["launches"] = route_launches["relpos"]
        kernels.append(entry)
    return kernels


def main() -> int:
    profiling = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a GPU",
              file=sys.stderr)
        return 2
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    try:
        import cv2  # noqa: F401
        log("cv2 importable: yes")
    except ImportError:
        log("cv2 importable: no (the mixed negative sampler skips "
            "Shi-Tomasi; a host-side sampling difference)")

    # The port and its kernel sources must be this checkout's, beside the
    # script, not a copy found elsewhere on the path.
    import sam_pt_torch
    here = os.path.dirname(os.path.realpath(__file__))
    if os.path.dirname(os.path.dirname(os.path.realpath(
            sam_pt_torch.__file__))) != here:
        raise SystemExit(f"sam_pt_torch imported from {sam_pt_torch.__file__}"
                         f", not from this checkout ({here})")
    from sam_pt_torch.ops import flash_attention as fa

    build_phase()
    device = torch.device("cuda")
    report = kernel_phase(fa, device, profiling)

    from sam_pt_torch.build import build_sam_pt
    from sam_pt_torch.vos_eval.eval import device_fuse_index_masks

    t0 = time.perf_counter()
    sam_pt = build_sam_pt(device, dtype=torch.bfloat16, seed=0)
    bias_for_a_live_run(sam_pt)
    torch.cuda.synchronize()
    log(f"slice: built SamPt (ViT-H + CoTracker, random bf16) in "
        f"{time.perf_counter() - t0:.1f} s")
    videos = [make_video(t, m, seed=i) for i, (t, m) in enumerate(VIDEOS)]
    n_points = sam_pt.positive_points_per_mask + sam_pt.negative_points_per_mask

    fa.reset_launch_counts()
    outs = [run_video(sam_pt, v, device_fuse_index_masks) for v in videos]
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    expected = launch_schedule(sam_pt, [t for t, _ in VIDEOS],
                               [t * m for t, m in VIDEOS])
    log(f"slice: launches {launches} expected {expected}")
    if launches != expected or not all(
            launches[k] for k in ("window", "global", "cross")):
        raise SystemExit("launch counts differ from the schedule")
    for (t, m), (out, masks) in zip(VIDEOS, outs):
        log(f"slice: video {t} frames x {m} objects: "
            + check_outputs(out, masks, t, m, n_points))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for v in videos:
        run_video(sam_pt, v, device_fuse_index_masks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    frames = sum(t for t, _ in VIDEOS)
    log(f"slice: timed pass {wall:.3f} s for {frames} frames = "
        f"{frames / wall:.3f} frames/s on {card}")

    reference_phase(sam_pt, fa, videos[0])
    if profiling:
        profile_phase(sam_pt, videos[-1], device_fuse_index_masks, card)
    query_points_phase(sam_pt, fa, device_fuse_index_masks)
    del sam_pt
    torch.cuda.empty_cache()
    route_launches = route_phase(fa, device)
    reinit_phase(fa, device, device_fuse_index_masks, card, profiling)

    log(json.dumps({"kernels": kernel_json(report, launches,
                                           route_launches)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
