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
     shapes in bf16 (seeded inputs), K1/K2 also at ViT-B's (12 heads x
     64), K4 in both its regimes
     (ViT-H global width, 64 x 4096 x 80; ViT-H windows, 1600 x 196 x 80),
     max abs error against a stated tolerance, and CUDA-event times
     (single calls, median of 5 runs) of the kernel, its plain version and
     one PyTorch call of the same function (`scaled_dot_product_attention`
     on head-split views, the rel-pos bias as a materialised mask), the
     kernel and that call also over 50 back-to-back calls (`loop_ms`,
     with the host's time a call to queue them) and, with --profile, by
     the profiler's device time (`profiled_ms`), beside the kernel's bound
     (`attention_roofline`). Then K5 (the channel LayerNorm with its GELU)
     at the decode chain's shapes (`LN_CASES`), held to the same
     tolerance, its yardstick one `F.layer_norm` (+ `F.gelu`) call and its
     bound the bytes alone (`bytes_roofline`).
  3b. Helpers phase: the JAX package's last public helpers on the card:
     `evaluate_batch` / `unpack_results` of the main path's CoTracker
     (8 frames of 480 x 854, 16 points; bit-equal to `forward`, one
     record a point), `encode_boxes` (bf16 weights) within 2^-14 +
     2^-14 |ref| of the CPU's, `resize_nearest` and
     `grid_sample_nearest` equal to the CPU's; one `helpers:` line.
  4. Slice phase: the port's SamPt (SAM ViT-H + CoTracker, random bf16
     weights from a seeded generator, two output biases set so that points
     are visible and masks pass the IoU gate) over two DAVIS-shaped 480 x 854
     videos (24 frames x 1 object, 35 x 3), then device fusion to uint8
     index masks. Launch counts are reset just before and read just after,
     and must equal the schedule's counts (K5's: `layer_norm_schedule`).
     A second, timed pass gives the wall time and frames/s.
  5. Reference phase: the first video's first encode chunk and first
     decode chunk again, with the kernels' plain versions in place of the
     kernels (K5's too), against the kernel outputs.
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
  9. Default-model phase: `configs/model/sam_pt.yaml` (SAM ViT-B bf16 +
     PIPS f32, decode chunk 32, the same two output biases set) over a
     DAVIS-shaped 24-frame x 2-object video: launches equal to the
     schedule, output checks, a timed second pass, and the reference
     check of phase 5 at ViT-B; with --profile its stage split.
 10. Tracker phase: PIPS++ (512 x 896) and RAFT (32 iterations) tracking
     17 points through a 24-frame 480 x 854 video (finite, pinned at the
     query frames, timed second pass); then PIPS, PIPS++ and RAFT on an
     8-frame 96 x 160 video, the card's float32 run against the CPU's on
     the same weights, TF32 off.
 11. CLI phase: a synthetic DAVIS-2017 tree (two videos of 24 random-
     texture 480 x 854 PNG frames written by the port's codec, a palette
     annotation a frame with two moving boxes, the second video's objects
     labelled 2 and 5) under the gitignored `build/`; the port's
     `sam_pt_torch/configs/vos_eval_root.yaml` composed with the tree and
     both `allow_random_init=true`, `cfg["model"]` (the default model)
     instantiated on the card with the two output biases set, then
     `evaluate`: 24 PNGs a video and the zip written, J&F finite in
     [0, 1], launches equal to the schedule, every written mask equal,
     pixel for pixel, to the direct forward's fused and remapped masks on
     the same frames (the model's rng reset between the two). A second,
     timed `evaluate` (FPS, the host's time to read a video), then
     `python -m sam_pt_torch.vos_eval.eval` as a subprocess (one video,
     8 frames, unscored: the DAVIS scorer reads every annotated frame, as
     the JAX one does; the device left at its default): it must exit 0 on
     `cuda`.
 12. Patch-filter phase (run after phase 6, on its SamPt): the main path
     with `use_patch_matching_filtering` over 24 textured frames x 1
     object (still, then moving): launches, output checks, every kind of
     patch flag, the flags against the same similarities and cascade
     computed on the CPU from the card's trajectories (equal except for
     points with a similarity within 1e-4 of the threshold), the filter's
     seconds.
 13. Crop phase (after 12, on the same SamPt): the main path with
     `crop_pad_tokens` over the 24 x 1 video (global blocks over 36 x 64
     tokens, 15 windows a frame): launches, output checks, the
     embedding's pad rows zero, phase 5's kernels-vs-plain check, and the
     encode stage's device time uncropped and cropped in turns.
 14. Interactive phase: the CLI's `simulate_interactive_point_correction`
     with `SamPtInteractive` on the default model (online, 3 interactions
     a frame, the default budget), composed as the JAX command is, over
     the CLI tree's first video cut to 12 frames, both objects one at a
     time: launches equal to 5 K3 a pass of each decode chain the model
     ran, the interactions within budget, the history JSON and pickles
     written, every IoU finite in [0, 1], J&F finite, the stages' host
     times, the written masks equal to a direct `forward` per object with
     the rng reset; then `input_only_one_gt_mask_point` over the same
     video with the default model: launches as scheduled, J&F finite.
 15. HQ phase: HQ-SAM ViT-H + PIPS composed as the CLI composes
     `model=sam_pt model/sam@model.sam_predictor=samhq_vit_huge` (full
     width, random bf16 weights, the two output biases set) over 24 x 2:
     launches equal to the schedule (K3 with the HQ token, 42 keys in a
     refinement pass), output checks, frames/s, phase 5's check through
     the encoder (its `interm`, the first global block's output,
     included) and the HQ decode chain; with --profile its stage split.
 16. MobileSAM and Light HQ-SAM phase: `sam_mobile_vit_tiny` and
     `samhq_light_vit_tiny` + PIPS over 24 x 2: launches (K3 only, K1
     and K2 at 0: TinyViT runs no kernel), output checks, frames/s, K3
     against its plain version through the decode chain, TinyViT's bf16
     embedding against the same weights in float32 on the card, the
     encode's device time beside ViT-B's in turns (A B B A).
 17. Demo phase: a synthetic PNG frame directory (24 frames, two moving
     boxes) and a query-points file under the gitignored `build/`; the
     port's demo `main` with the default model (biases set): launches,
     24 overlay frames written, masks and tracks equal to a direct
     forward with the rng reset; then `python -m sam_pt_torch.demo` as a
     subprocess: exit 0, 24 frames, its frames/s line.
 18. VIS phase: a synthetic UVO-format tree under the gitignored
     `build/` (two videos of 16 PNG frames at 480 x 854, 2-3 textured
     shapes moving over a dark background, a class-agnostic YTVIS JSON
     whose ground-truth tracks are RLE), registered with
     `register_dataset`; the port's `vis_eval_sam_pt` config composed
     (SAM ViT-H bf16, one predictor shared by the automatic mask
     generator and SamPt + PIPS; a 32 x 32 grid in batches of 64, the
     config's gates, 100 masks) on random weights made live
     (`vis_live_weights`); the generator's first batch with kernels
     against the plain route (and its K3 token count against
     `amg_tokens`); `evaluate`: launches equal to the schedule
     (`vis_schedule`), the gates' survivors (the device's counts), 2-100
     tracks a video, the 12 AP/AR stats finite or -1, SamPt's first
     decode chunk of the run against the plain route, `results.json`
     equal, record for record, to a direct adapter call with the rng
     reset and decoding to its masks; the generator's seconds a frame,
     SamPt's frames/s, `evaluate`'s fps (with --profile a stage split and
     a profile of one video); the capacity run (`vis_capacity_run`: 100
     masks over 8 frames, prompts past 1024 tokens, so K3 also runs the
     decoder's head-dim-32 self-attention; launches, the first decode
     chunk against the plain route); then `python -m
     sam_pt_torch.vis_eval.eval` on `cuda` as a subprocess (one video,
     the random weights as built, which keep no proposal: exit 0,
     scored); the phase's own seconds. After it, K3 at the evaluate
     run's prompt length (`vis_kernel_cases`) against its plain version.
 19. TAPIR and TapNet phase: for each, `build_sam_pt(sam="vit_b",
     tracker=..., **DEFAULT_SETTINGS)` (SAM bf16, the tracker f32 at its
     published widths, random weights, the occlusion and IoU biases set)
     over a DAVIS-shaped 24-frame x 2-object video: launches equal to the
     schedule, output checks, a timed second pass, phase 5's check at
     ViT-B; then each tracker alone over 17 points through 24 x 480 x 854
     (finite, TapNet pinned at its query frames, timed), and TAPIR, TapNet
     and the online TAPIR (4 frames streamed) on 8 x 96 x 160, the card
     against the CPU, TF32 off; the phase's seconds. Then phase 11's CLI
     run with `model/point_tracker=tapir` on the tree's first video
     (masks equal to the direct forward's, the `python -m` entry point),
     and both standalone tracker demos as subprocesses over phase 17's
     PNG frames (exit 0, their frames/s).
 20. SuperGlue phase: `build_sam_pt(sam="vit_b", tracker="superglue",
     **DEFAULT_SETTINGS)` (SAM bf16, SuperGlue f32 at its published
     widths: 1024 keypoints, 9 pairs x 4 heads, 100 Sinkhorn iterations,
     threshold 0.2) on random weights made live
     (`superglue_live_weights`) over a 24-frame x 2-object 480 x 854
     textured video whose texture moves: launches equal to the schedule,
     output checks, the matches a frame and each mask's visible positives
     (a mask fails with none on more than half of frames 1-23), a timed
     second pass, phase 5's check at ViT-B; one re-initialising pass
     (`REINIT_SETTINGS`, query frames 0 and 12: each window's masks set on
     the tracker, launches with their decodes); the tracker alone over 24
     x 480 x 854 (timed, SuperPoint, SuperGlue and the Sinkhorn's
     synchronised seconds) and on 8 x 96 x 160 the card against the CPU
     (TF32 off: keypoints, log transport plans, matches, trajectories);
     label propagation card against CPU; the phase's seconds. Then phase
     11's CLI run with `model/point_tracker=superglue` on one video (its
     random weights are not live: it shows the entry point runs) and
     `python -m sam_pt_torch.models.tracker.superglue.match_pairs` on two
     of phase 17's PNG frames (exit 0, the matches file's keys).
 21. Parallel phase (`sam_pt_torch/parallel/`), each world spawned from
     the script with its own rendezvous and a timeout; several ranks
     share the one card over gloo (NCCL takes one rank a card), so its
     times are bring-up numbers of a shared card, not a multi-GPU speed.
     A world of 2 (gloo, both ranks on the card): the main path with
     `data_parallel=True` over phase 4's two videos (fused masks agreeing
     with phase 4's unsharded run on > 0.999 of pixels, scores within
     1e-3, every rank's outputs bit-equal, K1/K2/K3 launches a rank as
     its schedule), SAM ViT-H tensor-parallel over a model axis of 2
     encoding 4 frames (8 local heads: K1 28 and K2 4 launches a rank;
     embeddings within rel. L2 1e-2 of the unsharded encode; the MLP's
     `psum` in the working dtype, bf16, the attention's in float32, each
     logged with its calls and bytes a rank per encode), and TapNet
     and TAPIR at their YAML widths time-sharded over 23 frames of 256 x
     256 (TF32 off: tracks within 1e-3 px and logits within 1e-4 of the
     unsharded run); a world of 4 (gloo): the TP encode on a 2 x 2 data x
     model mesh; a world of 3 (gloo): the time-sharded trackers again; a
     world of 1 over NCCL: the data-parallel main path; with more than
     one card, a world of one rank a card over NCCL (the data-parallel
     main path, the time-sharded trackers, TP on data x model 2).
Then the script's seconds, one JSON line with the per-kernel numbers
(rows of K1-K4 at the main path's shapes, K1/K2 at ViT-B's with the
default model's launches and phases 19's and 20's,
`global_attention_crop` at phase 13's grid, `image_to_token_interactive`
at phase 14's 325 token keys, `cross_attention_hq` at phase 15's pairs
and tokens, `cross_attention_amg` at phase 18's generator batch,
`cross_attention_vis` at its tracked prompts and `cross_attention_self`
(K3 at head dim 32, the decoder's self-attention from 1024 tokens) at
its capacity run's, `window_attention_tp2` and `global_attention_tp2`
(K1/K2 at 8 heads x 80) with a rank's launches in phase 21's TP encode,
`layer_norm` (K5 at HQ-SAM's `embedding_maskfeature` and, suffixed, the
upscaling's and `norm4`'s shapes) with the slice's K5 launches, each held
to its plain version), and as the last line {"ok": true,
"device": {...}}. The kernel phase alone:

    python3 -c "import torch, chip_smoke; from sam_pt_torch.ops import \
flash_attention as fa; chip_smoke.build_phase(); \
chip_smoke.kernel_phase(fa, torch.device('cuda'))"

Phase 21 alone, after the build, the two `_tp2` kernel cases, the main
path's unsharded run it is held to and a probe of the backends (gloo's
`all_reduce` of CUDA tensors by 2 ranks on one card, each dtype and 256
MB of int32; what NCCL says to 2 ranks on one card):

    python3 chip_smoke.py --parallel
    python3 chip_smoke.py --parallel --cards  # one rank a card, 2+ cards

The matrix products of the main path over 35 x 3 and of a 24-frame
encode, by input shape, with a version of the package to compare (a
copy unpacked under the gitignored `build/`, run in turns):

    python3 chip_smoke.py --gemm-profile [--package build/<copy>]
"""
from __future__ import annotations

import contextlib
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
# SAM's mask decoder: the IoU token and 4 mask tokens.
DECODER_TOKENS = 5
# One H100 SXM at its 700 W limit (NVIDIA's data sheet): dense bf16 tensor
# cores and HBM3 bandwidth.
PEAK_BF16_FLOP_S = 989e12
PEAK_BYTES_S = 3.35e12
# K5's cases, the decode chain's norms at a chunk of 48 pairs: name ->
# (shape, gelu). HQ-SAM's `embedding_maskfeature` (LayerNorm2d(64) and GELU
# at 256 x 256), the upscaling's (at 128 x 128) and the two-way
# transformer's `norm4` over the image's 4096 rows of 256.
LN_CASES = {"layer_norm_hq": ((48, 256, 256, 64), True),
            "layer_norm_upscaling": ((48, 128, 128, 64), True),
            "layer_norm_norm4": ((48, 4096, 256), False)}


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


def bytes_roofline(nbytes: int) -> dict:
    """The least time one H100 could take to move `nbytes` (each input
    read once, the output written once): K5's bound. Its operations (about
    30 float32 ones a value with the GELU's erf, on the CUDA cores) are
    not counted: they take less time than the bytes, if not much less."""
    return {"flop": None, "bytes": nbytes,
            "bound_ms": nbytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes"}


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


def bf16_randn(device, seed: int):
    """randn(*shape, std=1.0) -> a bf16 tensor on `device`, N(0, std^2)
    from one generator seeded with `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, std=1.0):
        return (std * torch.randn(shape, generator=g, device=device)
                ).to(torch.bfloat16)
    return randn


def cross_pair_cases(fa, randn, valid) -> tuple:
    """K3 in both directions of a decoder pass over b pairs whose prompt
    has nt tokens, `valid` [b, nt] bool the image->token key mask: the
    makers of the token->image case (nt tokens against 4096 image tokens)
    and of the image->token case, as `kernel_cases` makes cases."""
    b, nt = valid.shape
    kc = dict(heads=8, divisor=4.0)

    def token_to_image():
        tok, k, v = randn(b, nt, 128), randn(b, 4096, 128), randn(
            b, 4096, 128)
        return (lambda: fa.cross_attention_cuda(tok, k, v, **kc),
                lambda: fa.cross_attention_plain(tok, k, v, **kc),
                library_cross(tok, k, v, **kc),
                (tok, k, v), (b * 8, nt, 4096, 16))

    def image_to_token():
        img, k, v = randn(b, 4096, 128), randn(b, nt, 128), randn(b, nt, 128)
        valid_u8 = valid.to(torch.uint8)
        return (lambda: fa.cross_attention_cuda(img, k, v, kv_valid=valid_u8,
                                                **kc),
                lambda: fa.cross_attention_plain(img, k, v, kv_valid=valid,
                                                 **kc),
                library_cross(img, k, v, kv_valid=valid, **kc),
                (img, k, v, valid_u8),
                (b * 8, 4096, int(valid[0].sum()), 16))
    return token_to_image, image_to_token


def kernel_cases(fa, device) -> dict:
    """Name -> a function that makes one case at the main path's shapes:
    the kernel, its plain version and its library yardstick as calls, the
    inputs they read and (problems, nq, nk, d) for the bound. Made one at
    a time, so that each case's inputs (K2's and K4's masks are 2.1 GB)
    are freed before the next."""
    g = torch.Generator(device=device).manual_seed(1)
    randn = bf16_randn(device, 1)

    # K1: 25 windows x 4 frames, 196 tokens; K2: 4 frames of 64 x 64
    # tokens. ViT-H: 16 heads x 80; ViT-B (the default model): 12 x 64.
    def window(heads=16, d=80):
        qkv = randn(100, 196, 3 * heads * d)
        rh, rw = randn(14, 14, d, std=0.2), randn(14, 14, d, std=0.2)
        bias = fa.window_bias(qkv, rh, rw, heads)
        kw = dict(scale=d ** -0.5, heads=heads)
        return (lambda: fa.window_attention_cuda(qkv, bias, **kw),
                lambda: fa.window_attention_plain(qkv, bias, **kw),
                library_fused_qkv(qkv, bias, kh=14, **kw),
                (qkv, bias), (100 * heads, 196, 196, d))

    def global_(heads=16, d=80):
        qkv = randn(4, 4096, 3 * heads * d)
        rh, rw = randn(64, 64, d, std=0.2), randn(64, 64, d, std=0.2)
        bias = fa.global_bias(qkv, rh, rw, heads, 64, 64)
        kw = dict(scale=d ** -0.5, heads=heads)
        return (lambda: fa.global_attention_cuda(qkv, bias, kh=64, kw=64,
                                                 **kw),
                lambda: fa.global_attention_plain(qkv, bias, kh=64, kw=64,
                                                  **kw),
                library_fused_qkv(qkv, bias, kh=64, **kw),
                (qkv, bias), (4 * heads, 4096, 4096, d))

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

    # K2 on the grid that crop_pad_tokens leaves of a 480 x 854 frame
    # (`crop_grid`), ViT-H's tables (127 rows) center-sliced to it.
    def global_crop():
        from sam_pt_torch.models.sam.image_encoder import rel_pos_table

        kh, kw = crop_grid()
        qkv = randn(4, kh * kw, 3 * 16 * 80)
        rh = rel_pos_table(randn(127, 80, std=0.2), kh, kh, cropped=True)
        rw = rel_pos_table(randn(127, 80, std=0.2), kw, kw, cropped=True)
        bias = fa.global_bias(qkv, rh, rw, 16, kh, kw)
        kw_ = dict(scale=80 ** -0.5, heads=16)
        return (lambda: fa.global_attention_cuda(qkv, bias, kh=kh, kw=kw,
                                                 **kw_),
                lambda: fa.global_attention_plain(qkv, bias, kh=kh, kw=kw,
                                                  **kw_),
                library_fused_qkv(qkv, bias, kh=kh, **kw_),
                (qkv, bias), (4 * 16, kh * kw, kh * kw, 80))

    # K3 image->token in the interactive phase's box refinements: a full
    # pass over INTERACTIVE_FRAMES frames, keys laid out as the decoder
    # lays them (`interactive_key_mask`); in the HQ phase's refinement
    # passes: a decode chunk of HQ_PAIRS pairs against hq_tokens() token
    # keys (the HQ token the sixth output token), keys laid out as the
    # decoder lays them; in the VIS phase's generator: a batch of
    # AMG_PAIRS one-point prompts, amg_tokens() tokens, every one valid in
    # the key mask the decoder passes.
    _, cross_interactive = cross_pair_cases(
        fa, randn, interactive_key_mask(INTERACTIVE_FRAMES, device))
    cross_hq, cross_hq_masked = cross_pair_cases(
        fa, randn, hq_key_mask(HQ_PAIRS, device))
    cross_amg, cross_amg_masked = cross_pair_cases(
        fa, randn, torch.ones((AMG_PAIRS, amg_tokens()), dtype=torch.bool,
                              device=device))

    # K3 at head dim 32: the decoder's token self-attention, which takes
    # K3 from 1024 tokens (the VIS path's prompts for 100 masks, as its
    # capacity run tracks them: a refinement pass's vis_tokens() tokens,
    # a decode chunk of 32 pairs), with a key mask.
    def cross_self():
        b, nt = 32, vis_tokens()
        x, k, v = (randn(b, nt, 256) for _ in range(3))
        valid = torch.rand((b, nt), generator=g, device=device) > 0.3
        valid[:, :DECODER_TOKENS] = True
        valid_u8 = valid.to(torch.uint8)
        ks = dict(heads=8, divisor=32 ** 0.5)
        return (lambda: fa.cross_attention_cuda(x, k, v, kv_valid=valid_u8,
                                                **ks),
                lambda: fa.cross_attention_plain(x, k, v, kv_valid=valid,
                                                 **ks),
                library_cross(x, k, v, kv_valid=valid, **ks),
                (x, k, v, valid_u8), (b * 8, nt, int(valid[0].sum()), 32))

    return {"window": window, "global": global_, "cross": cross,
            "cross_masked": cross_masked,
            "cross_unmasked": lambda: cross_masked(False),
            "relpos": lambda: relpos(64, 64, 64),
            "relpos_window": lambda: relpos(1600, 14, 14),
            "window_vit_b": lambda: window(12, 64),
            "global_vit_b": lambda: global_(12, 64),
            # ViT-H's heads split over a model axis of 2 (phase 21)
            "window_tp2": lambda: window(8, 80),
            "global_tp2": lambda: global_(8, 80),
            "global_crop": global_crop,
            "cross_interactive": cross_interactive,
            "cross_hq": cross_hq, "cross_hq_masked": cross_hq_masked,
            "cross_amg": cross_amg, "cross_amg_masked": cross_amg_masked,
            "cross_self": cross_self}


def layer_norm_cases(device) -> dict:
    """K5's cases (`LN_CASES`) as `kernel_cases` makes its own: the
    kernel, its plain version (PyTorch's LayerNorm, then GELU, as the port
    ran them before), one `F.layer_norm` (+ `F.gelu`) call, the inputs, and
    the bound's function of the bytes, in bf16."""
    import torch.nn.functional as F

    from sam_pt_torch.ops import layer_norm as ln

    g = torch.Generator(device=device).manual_seed(2)

    def case(shape, gelu):
        c = shape[-1]
        x = (2 * torch.randn(shape, generator=g, device=device)
             + 0.5).bfloat16()
        w = (1 + 0.2 * torch.randn(c, generator=g, device=device)).bfloat16()
        b = (0.2 * torch.randn(c, generator=g, device=device)).bfloat16()

        def library():
            y = F.layer_norm(x, (c,), w, b, 1e-6)
            return F.gelu(y) if gelu else y

        return (lambda: ln.layer_norm_cuda(x, w, b, 1e-6, gelu=gelu),
                lambda: ln.layer_norm_plain(x, w, b, 1e-6, gelu=gelu),
                library, (x, w, b), bytes_roofline)

    return {name: (lambda s=shape, gl=gelu: case(s, gl))
            for name, (shape, gelu) in LN_CASES.items()}


def layer_norm_schedule(sam_pt, encodes, decodes) -> int:
    """K5 launches of encode calls over `encodes` frames each and decode
    calls over `decodes` pairs each: the neck's two LayerNorm2d(256) an
    encode chunk (HQ-SAM: two more, its image-level features); a decoder
    pass's ten (the two-way transformer's nine token and image norms, the
    upscaling's), two more in every pass after the first (the mask
    path's), one more with HQ-SAM (`embedding_maskfeature`)."""
    ec, dc = sam_pt.sam_encode_chunk, sam_pt.sam_decode_chunk
    enc = sum(-(-t // ec) for t in encodes)
    dec = sum(-(-n // min(dc, n)) for n in decodes)
    passes = 2 + sam_pt.iterative_refinement_iterations
    hq = int(sam_pt.sam_predictor.model.use_hq)
    return 2 * (1 + hq) * enc + dec * ((10 + hq) * passes + 2 * (passes - 1))


def crop_grid(image_size: int = 1024) -> tuple:
    """The rows and columns of SAM's 16-pixel tokens that cover an H x W
    frame after the longest-side resize to `image_size`: 36 x 64 of 64 x 64
    for 480 x 854 (576 x 1024)."""
    from sam_pt_torch.ops.resize import get_longest_side_target_hw

    th, tw = get_longest_side_target_hw(H, W, image_size)
    return -(-th // 16), -(-tw // 16)


# The interactive phase's video length (frames of the synthetic tree).
INTERACTIVE_FRAMES = 12
# Visible points of the key mask of the interactive kernel row: the
# default model's 17 initial points and 18 added ones, halfway through a
# 12-frame online run at 3 interactions a frame.
INTERACTIVE_VISIBLE = 35


def interactive_capacity() -> int:
    """The prompt's slots in the interactive phase: the default model's
    points a mask (16 k-medoids positives and 1 negative) and
    SamPtInteractive's default interaction budget (300)."""
    import inspect

    from sam_pt_torch.build import SAM_PT_SETTINGS
    from sam_pt_torch.models.sam_pt_interactive import SamPtInteractive

    budget = inspect.signature(SamPtInteractive).parameters[
        "interactions_max"].default
    return (SAM_PT_SETTINGS["positive_points_per_mask"]
            + SAM_PT_SETTINGS["negative_points_per_mask"] + budget)


def interactive_tokens() -> int:
    """Keys of the decoder's image->token attention in the interactive
    chain's box-refinement passes (12 of its 14): the output tokens, the
    prompt's capacity, 2 box corners and the appended pad slot."""
    return DECODER_TOKENS + interactive_capacity() + 2 + 1


def interactive_key_mask(b: int, device) -> torch.Tensor:
    """[b, interactive_tokens()] bool: what `Sam.decode_masks` lets a
    refinement pass attend to: the output tokens, the visible points at the
    front of the prompt, the 2 box corners; not the capacity's empty slots
    nor the pad slot (a box is given)."""
    valid = torch.zeros((b, interactive_tokens()), dtype=torch.bool,
                        device=device)
    corners = DECODER_TOKENS + interactive_capacity()
    valid[:, :DECODER_TOKENS + INTERACTIVE_VISIBLE] = True
    valid[:, corners:corners + 2] = True
    return valid


# The HQ phase: HQ-SAM ViT-H + PIPS with the default model's settings (16
# k-medoids positives and 1 negative a mask, the other object's positives
# as negatives, decode chunk 32) over VARIANT_VIDEO.
HQ_PAIRS = 32
# (frames, objects) of the HQ, MobileSAM and Light HQ-SAM phases.
VARIANT_VIDEO = (24, 2)


def hq_tokens() -> int:
    """Keys of the HQ decoder's image->token attention in a refinement
    pass (12 of its 14): the 6 output tokens (the HQ token the sixth), a
    mask's 17 points, the other object's 16 positives, 2 box corners and
    the appended pad slot: at most 64, so the call stays on K3's
    image->token kernel."""
    from sam_pt_torch.build import SAM_PT_SETTINGS

    n_pos = SAM_PT_SETTINGS["positive_points_per_mask"]
    points = n_pos + SAM_PT_SETTINGS["negative_points_per_mask"]
    return (DECODER_TOKENS + 1 + points + n_pos * (VARIANT_VIDEO[1] - 1)
            + 2 + 1)


def hq_key_mask(b: int, device) -> torch.Tensor:
    """[b, hq_tokens()] bool: every point visible; the pad slot masked out
    (a box is given)."""
    valid = torch.ones((b, hq_tokens()), dtype=torch.bool, device=device)
    valid[:, -1] = False
    return valid


# The VIS phase's generator decodes a batch of `points_per_batch` (64)
# one-point prompts at a time.
AMG_PAIRS = 64


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
    report = measure_cases(kernel_cases(fa, device), profiling)
    report.update(measure_cases(layer_norm_cases(device), profiling))
    return report


def measure_cases(cases: dict, profiling: bool = False) -> dict:
    """Each case of `cases` (made as `kernel_cases` makes them), one at a
    time: agreement with the plain version, times (with `profiling`, also
    the profiler's device time), bound (`attention_roofline` of the case's
    (problems, nq, nk, d), or the case's own function of the bytes moved).
    Fails at the first case that disagrees."""
    report = {}
    for name, make in cases.items():
        kernel, plain, library, inputs, shape = make()
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        diff = (got.float() - ref.float()).abs()
        err = float(diff.max())
        ratio = float((diff / (ATOL + RTOL * ref.float().abs())).max())
        ok = bool(torch.isfinite(got.float()).all()) and ratio <= 1.0
        nbytes = tensor_bytes(*inputs, got)
        roof = (shape(nbytes) if callable(shape)
                else attention_roofline(*shape, nbytes))
        flop = ("" if roof["flop"] is None
                else f"{roof['flop'] / 1e9:.2f} GFLOP, ")
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
            f"({flop}{roof['bytes'] / 1e6:.1f} MB; "
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


HELPER_FRAMES = 8  # the helpers phase's CoTracker video: 8 x 480 x 854
HELPER_QUERIES = 16
# `encode_boxes` card vs CPU: the box embeddings are float32 (the bf16
# weights are cast up; TF32 is off for the call), sin and cos of
# arguments up to ~40 rad, where a float32 ulp is 3.8e-6. A few ulps of
# argument, plus as much relative (an H100 read 1.19e-7: PERF.md).
BOX_ATOL = BOX_RTOL = 2 ** -14


def build_main_cotracker(device):
    """The main path's CoTracker tracker (`build.build_sam_pt`'s: stride
    4, window 8, 384 x 512, bf16), random weights from a generator on the
    device seeded 0."""
    from sam_pt_torch.models.tracker.cotracker.model import CoTracker
    from sam_pt_torch.models.tracker.cotracker.tracker import (
        CoTrackerPointTracker,
    )
    from sam_pt_torch.utils.checkpoint import randomize_

    generator = torch.Generator(device=device).manual_seed(0)
    model = randomize_(CoTracker(s=8, stride=4).to(device), generator)
    return CoTrackerPointTracker(
        interp_shape=(384, 512), support_grid_size=2,
        support_grid_every_n_frames=12, iters=6,
        model=model.to(torch.bfloat16).eval().requires_grad_(False))


def helpers_phase(device, card: str) -> None:
    """Phase 3b: the JAX package's last public helpers in the port, on the
    card. `CoTrackerPointTracker.evaluate_batch` over HELPER_FRAMES frames
    of 480 x 854 and HELPER_QUERIES points (packed trajectories and
    visibilities bit-equal to `forward`'s on the same video tensor,
    `unpack_results` one record a point); `PromptEncoder.encode_boxes`
    (bf16 weights, SAM's 1024 input, the PE matrix N(0, 1); float32
    out) within BOX_ATOL + BOX_RTOL |ref| of the same call on the CPU; `resize_nearest` (decoder
    logits 4 x 256 x 256 to 480 x 854 in float32, an index mask 480 x
    854 to 240 x 427 in uint8) and `grid_sample_nearest` (a uint8 frame
    at 8 x 16 points, out-of-range ones too) equal to the CPU's."""
    from sam_pt_torch.models.sam.prompt_encoder import PromptEncoder
    from sam_pt_torch.ops import grid_sample_nearest, resize_nearest
    from sam_pt_torch.utils.checkpoint import randomize_

    t0 = time.perf_counter()
    rng = np.random.default_rng(16)
    tracker = build_main_cotracker(device)
    video = torch.from_numpy(rng.integers(
        0, 255, (1, HELPER_FRAMES, H, W, 3)).astype(np.uint8)).to(device)
    qp = np.stack([rng.integers(0, HELPER_FRAMES, HELPER_QUERIES),
                   rng.uniform(0, W - 1, HELPER_QUERIES),
                   rng.uniform(0, H - 1, HELPER_QUERIES)], -1)[None].astype(
                       np.float32)
    traj, vis = tracker.forward(video, qp)
    packed = tracker.evaluate_batch(video, qp)
    rows = type(tracker).unpack_results(packed, batch_idx=0)
    if not (np.array_equal(packed["trajectories_pred"], traj)
            and np.array_equal(packed["visibilities_pred"], vis)
            and traj.shape == (1, HELPER_FRAMES, HELPER_QUERIES, 2)
            and len(rows) == HELPER_QUERIES):
        raise SystemExit("helpers: evaluate_batch differs from forward or "
                         "unpack_results from one record a point")
    t_track = time.perf_counter() - t0

    g = torch.Generator().manual_seed(16)
    encoder = randomize_(PromptEncoder(), g).requires_grad_(False)
    encoder.pe_layer.positional_encoding_gaussian_matrix.normal_(generator=g)
    encoder = encoder.to(torch.bfloat16)
    boxes = np.sort(rng.uniform(0, 1024, (32, 2, 2)), axis=1).reshape(
        32, 4).astype(np.float32)
    with no_tf32():
        ref = encoder.encode_boxes(boxes)
        got = encoder.to(device).encode_boxes(boxes)
    box_err = (got.cpu() - ref).abs()
    boxes_ok = bool(got.dtype == ref.dtype == torch.float32
                    and (box_err <= BOX_ATOL + BOX_RTOL * ref.abs()).all())

    logits = torch.from_numpy(rng.standard_normal((4, 256, 256, 1)).astype(
        np.float32))
    mask = torch.from_numpy(rng.integers(0, 4, (H, W)).astype(np.uint8))
    frame = torch.from_numpy(rng.integers(0, 255, (H, W, 3)).astype(
        np.uint8))
    xs = torch.from_numpy(rng.uniform(-20, W + 20, (8, 16)).astype(
        np.float32))
    ys = torch.from_numpy(rng.uniform(-20, H + 20, (8, 16)).astype(
        np.float32))
    nearest = {
        "resize_nearest logits": (resize_nearest, (logits, (H, W))),
        "resize_nearest mask": (resize_nearest, (mask, (H // 2, W // 2)),
                                dict(h_axis=0, w_axis=1)),
        "grid_sample_nearest": (grid_sample_nearest, (frame, xs, ys)),
    }
    exact = {}
    for name, (fn, args, *kw) in nearest.items():
        kw = kw[0] if kw else {}
        cpu = fn(*args, **kw)
        card_out = fn(*[a.to(device) if isinstance(a, torch.Tensor) else a
                        for a in args], **kw)
        exact[name] = (card_out.dtype == cpu.dtype
                       and torch.equal(card_out.cpu(), cpu))
    torch.cuda.synchronize()
    log(f"helpers: evaluate_batch of the main path's CoTracker over "
        f"{HELPER_FRAMES} x {H} x {W}, {HELPER_QUERIES} points: packed "
        f"outputs bit-equal to forward's, {len(rows)} records "
        f"({t_track:.1f} s); encode_boxes of 32 boxes within "
        f"{float(box_err.max()):.2e} of the CPU's "
        f"({'OK' if boxes_ok else 'FAIL'} at {BOX_ATOL:g} + {BOX_RTOL:g} "
        f"|ref|); "
        + ", ".join(f"{k} {'equal' if v else 'DIFFERENT'}"
                    for k, v in exact.items())
        + f" to the CPU's; the phase took {time.perf_counter() - t0:.1f} s "
          f"on {card}")
    if not boxes_ok or not all(exact.values()):
        raise SystemExit("helpers: a card result differs from the CPU's")
    del tracker, video
    torch.cuda.empty_cache()


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
    decode calls over `decodes` pairs each: per encode chunk one K1 a
    window block and one K2 a global block of the model's ViT (ViT-H: 28
    and 4, ViT-B: 8 and 4; none for TinyViT), K3 5 per decoder pass and
    decode chunk, no K4."""
    ec, dc = sam_pt.sam_encode_chunk, sam_pt.sam_decode_chunk
    encoder = sam_pt.sam_predictor.model.image_encoder
    # TinyViT (MobileSAM) runs no kernel: its attention is plain.
    n_global = len(getattr(encoder, "global_attn_indexes", ()))
    n_window = len(encoder.blocks) - n_global if n_global else 0
    enc = sum(-(-t // ec) for t in encodes)
    dec = sum(-(-n // min(dc, n)) for n in decodes)
    passes = 2 + sam_pt.iterative_refinement_iterations
    return {"window": n_window * enc, "global": n_global * enc,
            "cross": 5 * passes * dec, "relpos": 0}


def bias_for_a_live_run(sam_pt) -> None:
    """With N(0, 0.02^2) weights every point would be invisible (sigmoid ~
    0.5 < 0.7) and every IoU below the 0.7 gate, so no prompt would reach
    the decoder's visible-point paths and every plane would be gated.
    Two output biases are set so that both paths are live: the tracker's
    visibility (PIPS's visibility head; TAPIR's and TapNet's occlusion
    logits, at -3; SuperGlue has none: `superglue_live_weights`) and SAM's
    IoU head."""
    with torch.no_grad():
        model = getattr(sam_pt.point_tracker, "model", None)
        if hasattr(model, "occlusion_out"):  # TAPIR, TapNet
            model.occlusion_out.bias.fill_(-3.0)
        elif model is not None:  # SuperGlue has no visibility head
            model.vis_predictor[0].bias.fill_(3.0)
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


@contextlib.contextmanager
def plain_route(fa):
    """The kernels' plain versions in their wrappers' place (K3's key mask
    as bool; K5's too), until the block ends."""
    from sam_pt_torch.ops import layer_norm as ln

    plain = {
        "window_attention_cuda": fa.window_attention_plain,
        "global_attention_cuda": fa.global_attention_plain,
        "cross_attention_cuda": lambda q, k, v, kv_valid=None, **kw:
            fa.cross_attention_plain(
                q, k, v, kv_valid=None if kv_valid is None
                else kv_valid.bool(), **kw),
    }
    saved = {name: getattr(fa, name) for name in plain}
    saved_ln = ln.layer_norm_cuda
    try:
        for name, fn in plain.items():
            setattr(fa, name, fn)
        ln.layer_norm_cuda = ln.layer_norm_plain
        yield
    finally:
        for name, fn in saved.items():
            setattr(fa, name, fn)
        ln.layer_norm_cuda = saved_ln


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def chain_check(sam_pt, fa, args, label: str, kernel_out=None) -> None:
    """One decode chunk, `sam_pt._chain(*args)`, with the kernels (or
    `kernel_out`, what a run computed with them) and with their plain
    versions: IoU diff, mask agreement and rel. L2 of the logits (over the
    pixels finite on both sides: float16 logits may overflow). Fails
    unless IoU diff < 5e-2, agreement > 0.99 and rel. L2 < 5e-2."""
    up_k, iou_k = kernel_out or sam_pt._chain(*args)
    with plain_route(fa):
        up_p, iou_p = sam_pt._chain(*args)
    d_iou = float((iou_k - iou_p).abs().max())
    agree = float(((up_k > 0) == (up_p > 0)).float().mean())
    finite = torch.isfinite(up_k) & torch.isfinite(up_p)
    rel = rel_l2(up_k[finite], up_p[finite])
    ok = d_iou < 5e-2 and agree > 0.99 and rel < 5e-2
    log(f"{label}: decode chain kernels vs plain: iou max diff {d_iou:.3e}, "
        f"mask agreement {agree:.5f}, logits rel_l2 {rel:.3e} "
        f"({int(finite.sum())}/{finite.numel()} finite on both sides) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{label}: the kernel path disagrees with the plain "
                         f"path")


def reference_phase(sam_pt, fa, video, label: str = "reference") -> None:
    """Encode chunk and decode chunk with kernels vs with plain versions
    (every part of HQ-SAM's embeddings, `interm` included; the chunk
    decodes them as `decode_ready` makes them, HQ-SAM's features once a
    frame)."""
    from sam_pt_torch.utils.tree import tree_map

    predictor = sam_pt.sam_predictor
    device = sam_pt.device
    frames = torch.from_numpy(video["image"][:4]).to(device)
    hw = (H, W)

    emb_k = predictor.encode_frames(frames, hw)
    with plain_route(fa):
        emb_p = predictor.encode_frames(frames, hw)
    parts = (emb_k.keys() if isinstance(emb_k, dict) else [None])
    errs = {k: rel_l2(*(e if k is None else e[k] for e in (emb_k, emb_p)))
            for k in parts}
    log(f"{label}: encoder embeddings kernels vs plain rel_l2 "
        + ", ".join(f"{'' if k is None else k + ' '}{v:.3e}"
                    for k, v in errs.items()))
    if not max(errs.values()) < 5e-2:
        raise SystemExit("kernel path disagrees with the plain path")

    rng = np.random.default_rng(3)
    b = 8
    pts = torch.as_tensor(rng.uniform(0, [W, H], (b, 18, 2)),
                          dtype=torch.float32, device=device)
    lbl = torch.as_tensor(np.r_[[1] * 16, 0, -1][None].repeat(b, 0),
                          device=device)
    emb = tree_map(lambda x: x[torch.arange(b, device=device) % 4],
                   predictor.decode_ready(emb_k))
    chain_check(sam_pt, fa, (emb, pts, lbl, hw), label)


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
    if profiling:
        stage_split(sam_pt, f"reinit_{t}x{m}", ("_encode_all_frames",
                    "_track_points", "_apply_sam", "extract_query_points"),
                    lambda: run_video(sam_pt, video, fuse), card)
    del sam_pt
    torch.cuda.empty_cache()


class Stages:
    """Host seconds, calls and kernel launches of named calls, each between
    two synchronisations (serialized): `wrap(owner, name, label)` replaces
    the method or function `owner.name` until `restore()`; with `count`,
    `counts[label]` sums `count(output)` over the calls."""

    def __init__(self):
        from sam_pt_torch.ops import flash_attention as fa

        self.fa = fa
        self.seconds, self.calls, self.launches = {}, {}, {}
        self.counts = {}
        self._saved = []

    def wrap(self, owner, name: str, label: str, count=None) -> None:
        fn = getattr(owner, name)
        self._saved.append((owner, name, vars(owner).get(name)))

        def call(*args, **kwargs):
            torch.cuda.synchronize()
            before = dict(self.fa.LAUNCHES)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[label] = (self.seconds.get(label, 0.0)
                                   + time.perf_counter() - t0)
            self.calls[label] = self.calls.get(label, 0) + 1
            counts = self.launches.setdefault(label, {})
            for k, v in self.fa.LAUNCHES.items():
                counts[k] = counts.get(k, 0) + v - before[k]
            if count is not None:
                self.counts[label] = self.counts.get(label, 0) + count(out)
            return out

        setattr(owner, name, call)

    def restore(self) -> None:
        for owner, name, old in reversed(self._saved):
            if old is None:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
        self._saved = []


def stage_split(sam_pt, label: str, names, run, card: str) -> None:
    """One `run()` with the SamPt methods `names` timed on the host clock,
    each call between two synchronisations (serialized), then one
    `run()` under the profiler."""
    stages = Stages()
    for name in names:
        stages.wrap(sam_pt, name, name)
    try:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        stages.restore()
    log(f"profile {label}: serialized {total:.4f} s: " + ", ".join(
        f"{k} {v:.4f} ({100 * v / total:.1f}%)"
        for k, v in stages.seconds.items())
        + f", rest {total - sum(stages.seconds.values()):.4f}")
    device_profile(label, run, card)


def default_model_phase(fa, device, fuse, card: str,
                        profiling: bool) -> dict:
    """The repo's default model (configs/model/sam_pt.yaml: SAM ViT-B in
    bf16 + PIPS in f32) at full width over a DAVIS-shaped 24-frame x
    2-object video, query masks on frame 0: launches equal to the
    schedule, output checks, a timed second pass, kernels against plain
    versions through ViT-B's encoder and the decode chain. Returns the
    launches."""
    from sam_pt_torch.build import DEFAULT_SETTINGS, build_sam_pt

    t0 = time.perf_counter()
    sam_pt = build_sam_pt(device, dtype=torch.bfloat16, seed=0, sam="vit_b",
                          tracker="pips", **DEFAULT_SETTINGS)
    bias_for_a_live_run(sam_pt)
    torch.cuda.synchronize()
    log(f"default model: built SamPt (ViT-B bf16 + PIPS f32, random) in "
        f"{time.perf_counter() - t0:.1f} s")
    t, m = 24, 2
    video = make_video(t, m, seed=8)
    n_points = sam_pt.positive_points_per_mask + sam_pt.negative_points_per_mask

    fa.reset_launch_counts()
    out, masks = run_video(sam_pt, video, fuse)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    expected = launch_schedule(sam_pt, [t], [t * m])
    log(f"default model: launches {launches} expected {expected}")
    if launches != expected or not all(
            launches[k] for k in ("window", "global", "cross")):
        raise SystemExit("default model: launch counts differ")
    log(f"default model: video {t} frames x {m} objects: "
        + check_outputs(out, masks, t, m, n_points))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_video(sam_pt, video, fuse)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"default model: timed pass {wall:.3f} s for {t} frames = "
        f"{t / wall:.3f} frames/s on {card}")
    reference_phase(sam_pt, fa, video, label="default model reference")
    if profiling:
        stage_split(sam_pt, f"default_{t}x{m}", (
            "_encode_all_frames", "extract_query_points",
            "_track_points_device", "_apply_sam_device"),
            lambda: run_video(sam_pt, video, fuse), card)
    del sam_pt
    torch.cuda.empty_cache()
    return launches


# The card's float32 tracker run against the CPU's, TF32 off: the two differ
# in summation order only. The bound is about 1% of how far the points move
# (0.6-1.7 px on the 8-frame video, with the heads scaled as below).
TRACKER_CPU_ATOL = 1e-2


def small_steps_(name: str, model) -> None:
    """Scale a random tracker's update heads down for the card-vs-CPU
    comparison, so that float32 summation-order differences stay small:
    PIPS's flow-embedding input columns (frequencies up to ~970 a pixel)
    and visibility bias, PIPS++'s delta head, RAFT's flow head (at
    N(0, 0.02^2) these move points by 60-120 px in 8 frames, and a change
    in the last bit of the input by up to 50 px)."""
    with torch.no_grad():
        if name == "pips":
            model.delta_block.to_delta[0].weight[:, 324:516] *= 0.01
            model.vis_predictor[0].bias.fill_(3.0)
        elif name == "pips_plus_plus":
            model.delta_block.dense.weight.mul_(0.01)
            model.delta_block.dense.bias.mul_(0.01)
        else:
            model.update_block.flow_head.conv2.weight.mul_(0.01)
            model.update_block.flow_head.conv2.bias.mul_(0.01)


def tracker_phase(device, card: str) -> None:
    """PIPS++ (512 x 896, as configured) and RAFT (32 iterations), random
    f32 weights, each tracking 17 points through a 24-frame 480 x 854
    video (query frames 0, 8 and 23) on the card: finite trajectories,
    pinned at the query frames; a warm pass, then a timed one. Then PIPS,
    PIPS++ and RAFT on an 8-frame 96 x 160 video (query frames 0 and 7,
    PIPS++ at the video's size), the card's run against the same weights'
    run on the CPU, TF32 off."""
    from sam_pt_torch.build import TRACKER_SETTINGS
    from sam_pt_torch.models.tracker import TRACKER_REGISTRY

    rng = np.random.default_rng(9)
    n_points = 17

    def queries(frames, h, w):
        ts = np.asarray(frames)[np.arange(n_points) % len(frames)]
        xy = rng.uniform([8, 8], [w - 8, h - 8], (n_points, 2))
        return np.concatenate([ts[:, None], xy], 1)[None].astype(np.float32)

    t = 24
    video = torch.from_numpy(rng.integers(0, 255, (1, t, H, W, 3)).astype(
        np.uint8)).to(device)
    qp = queries([0, 8, 23], H, W)
    rows = np.arange(n_points)
    for name in ("pips_plus_plus", "raft"):
        tracker = TRACKER_REGISTRY[name](allow_random_init=True, seed=1,
                                         device=device,
                                         **TRACKER_SETTINGS[name])
        traj, vis = tracker.forward_device(video, qp)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traj, vis = tracker.forward_device(video, qp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        traj = traj[0].cpu().numpy()
        pin = float(np.abs(traj[qp[0, :, 0].astype(int), rows]
                           - qp[0, :, 1:]).max())
        ok = (traj.shape == (t, n_points, 2) and np.isfinite(traj).all()
              and pin <= 1e-3 and tuple(vis.shape) == (1, t, n_points))
        log(f"tracker {name}: {t} frames {H} x {W}, {n_points} points: "
            f"timed pass {wall:.3f} s = {t / wall:.3f} frames/s on {card}; "
            f"finite, query-frame error {pin:.2e} px (<= 1e-3), moved up "
            f"to {float(np.abs(traj - qp[0, None, :, 1:]).max()):.1f} px, "
            f"visible {float(vis.mean()):.3f} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"tracker {name}: bad trajectories")
        del tracker
        torch.cuda.empty_cache()

    small = torch.from_numpy(rng.integers(0, 255, (1, 8, 96, 160, 3)).astype(
        np.uint8))
    qp = queries([0, 7], 96, 160)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name in ("pips", "pips_plus_plus", "raft"):
            kwargs = dict(TRACKER_SETTINGS[name])
            if name == "pips_plus_plus":
                kwargs["image_size"] = (96, 160)
            runs = []
            for dev, video_on in ((device, small.to(device)), ("cpu", small)):
                tracker = TRACKER_REGISTRY[name](
                    allow_random_init=True, seed=1, device=dev, **kwargs)
                if runs:  # the card's weights, on the CPU
                    tracker.model.load_state_dict(weights)
                else:
                    small_steps_(name, tracker.model)
                    weights = {k: v.cpu() for k, v in
                               tracker.model.state_dict().items()}
                runs.append(tracker.forward_device(video_on, qp)[0].cpu())
            err = float((runs[0] - runs[1]).abs().max())
            moved = float((runs[1][0] - torch.from_numpy(qp[0, :, 1:])
                           ).abs().max())
            ok = (bool(torch.isfinite(runs[0]).all())
                  and err <= TRACKER_CPU_ATOL)
            log(f"tracker {name} card vs CPU (8 x 96 x 160, f32, TF32 off): "
                f"max |diff| {err:.3e} px (<= {TRACKER_CPU_ATOL:g}), points "
                f"moved up to {moved:.3f} px {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"tracker {name}: the card disagrees with "
                                 f"the CPU")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


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


# The CLI phase's DAVIS-2017 tree: 24 frames a video at 480 x 854, two
# objects each, labelled (1, 2) and (2, 5).
CLI_FRAMES = 24
CLI_LABELS = [(1, 2), (2, 5)]
CLI_PALETTE = [0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0, 0, 0, 128,
               128, 0, 128]
# The default model on random weights (the checkpoints are not in the
# repository).
CLI_MODEL = ("model.sam_predictor.allow_random_init=true",
             "model.point_tracker.allow_random_init=true")


def make_davis_tree(root: str, frames=None, videos=None) -> list:
    """A DAVIS-2017 layout under `root`: per video, random-texture PNG
    frames (8 x 8 blocks of random colour plus noise) and one palette
    annotation a frame with two boxes moving right and down. `frames`
    (CLI_FRAMES by default) and `videos` (all) give the first frames of
    the first videos of the full tree."""
    from sam_pt_torch.vos_eval.data.image_io import write_png

    frames = CLI_FRAMES if frames is None else frames
    rng = np.random.default_rng(11)
    names = []
    for v, labels in enumerate(CLI_LABELS[:videos]):
        name = f"video{v}"
        names.append(name)
        images = os.path.join(root, "trainval", "JPEGImages", "480p", name)
        annotations = os.path.join(root, "trainval", "Annotations", "480p",
                                   name)
        os.makedirs(images)
        os.makedirs(annotations)
        texture = rng.integers(0, 255, (H // 8 + 1, W // 8 + 1, 3))
        texture = texture.repeat(8, 0).repeat(8, 1)[:H, :W]
        for t in range(frames):
            noise = rng.integers(-20, 20, (H, W, 3))
            frame = np.clip(np.roll(texture, 3 * t, axis=1) + noise, 0, 255)
            write_png(os.path.join(images, f"{t:05d}.png"),
                      frame.astype(np.uint8))
            mask = np.zeros((H, W), np.uint8)
            for label, (y0, y1, x0, x1), (dy, dx) in zip(
                    labels, ((60, 200, 80, 300), (260, 420, 480, 700)),
                    ((2, 4), (1, 3))):  # boxes at 480 x 854, moving
                rows = slice((y0 + dy * t) * H // 480, (y1 + dy * t) * H // 480)
                cols = slice((x0 + dx * t) * W // 854, (x1 + dx * t) * W // 854)
                mask[rows, cols] = label
            write_png(os.path.join(annotations, f"{t:05d}.png"), mask,
                      CLI_PALETTE)
    sets = os.path.join(root, "trainval", "ImageSets", "2017")
    os.makedirs(sets)
    with open(os.path.join(sets, "val.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return names


def direct_masks(model, cfg, video_id: int) -> tuple:
    """The masks `evaluate` should write for one video: its frames read
    and its first-frame objects mapped as the harness does, one
    `model.forward`, device fusion, the labels mapped back."""
    from sam_pt_torch.vos_eval.data.mask_mapper import MaskMapper
    from sam_pt_torch.vos_eval.eval import (build_dataset,
                                            device_fuse_index_masks)

    reader = list(build_dataset(cfg).get_datasets())[video_id]
    mapper = MaskMapper()
    rgbs, masks = [], []
    for data in reader:
        rgbs.append(data["rgb"])
        if "mask" in data:
            onehot, _ = mapper.convert_mask(data["mask"])
            masks.append(onehot)
    query = masks[0]
    video = {"image": np.stack(rgbs), "target_hw": (H, W),
             "query_masks": query,
             "query_point_timestep": np.zeros(len(query), np.float32)}
    out = model.forward(video)
    fused = device_fuse_index_masks(out["logits"], query, [0] * len(query))
    return reader.vid_name, [mapper.remap_index_mask(m) for m in fused]


def cli_phase(fa, card: str, model=CLI_MODEL, videos=None,
              label: str = "cli") -> None:
    """The port's VOS evaluation CLI with the repo's default model over a
    synthetic DAVIS-2017 tree of two 24 x 480 x 854 videos (see the
    module's docstring, phase 11), or its first `videos`. `model` holds
    the overrides that give both runs their model (a rehearsal on the CPU
    passes `device=cpu` and a small model; phase 19 the TAPIR tracker);
    `label` starts the log lines."""
    import shutil
    import tempfile

    from sam_pt_torch.config import compose, instantiate
    from sam_pt_torch.config import resolve_interpolations
    from sam_pt_torch.vos_eval.data.image_io import read_index_mask
    from sam_pt_torch.vos_eval.eval import CONFIG_DIR, build_dataset, evaluate

    here = os.path.dirname(os.path.realpath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="cli_phase_", dir=os.path.join(here,
                                                                   "build"))
    try:
        t0 = time.perf_counter()
        names = make_davis_tree(os.path.join(root, "DAVIS"), videos=videos)
        log(f"{label}: wrote the DAVIS tree ({len(names)} videos x "
            f"{CLI_FRAMES} PNG frames {H} x {W}) in "
            f"{time.perf_counter() - t0:.1f} s")
        overrides = [
            "dataset=D17", "size=480", f"d17_path={root}/DAVIS",
            f"output={root}/out0", "visualize_results=false", *model]
        cfg = resolve_interpolations(compose(CONFIG_DIR, "vos_eval_root",
                                             overrides))
        t0 = time.perf_counter()
        sam_pt = instantiate(cfg["model"])
        bias_for_a_live_run(sam_pt)
        torch.cuda.synchronize()
        log(f"{label}: instantiated cfg['model'] ({type(sam_pt).__name__}: "
            f"SAM {len(sam_pt.sam_predictor.model.image_encoder.blocks)} blocks "
            f"{sam_pt.sam_predictor.model.dtype}, "
            f"{type(sam_pt.point_tracker).__name__}) on {sam_pt.device} in "
            f"{time.perf_counter() - t0:.1f} s")
        if sam_pt.device.type != cfg["device"]:
            raise SystemExit(f"{label}: the model is not on {cfg['device']}")
        cfg["model"] = sam_pt
        # SamPt's rng, and SuperGlue's (its quota sampling draws from it)
        rngs = [r for r in (sam_pt.rng, getattr(sam_pt.point_tracker, "rng",
                                                None)) if r is not None]
        rng_states = [r.bit_generator.state for r in rngs]

        fa.reset_launch_counts()
        results = evaluate(cfg)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        expected = launch_schedule(sam_pt, [CLI_FRAMES] * len(names),
                                   [2 * CLI_FRAMES] * len(names))
        log(f"{label}: launches {launches} expected {expected}")
        if launches != expected:
            raise SystemExit(f"{label}: launch counts differ from the "
                             f"schedule")
        out = cfg["output"]
        written = {n: sorted(os.listdir(os.path.join(out, n)))
                   for n in names}
        jf = results.get("J&F-Mean")
        ok = (all(len(v) == CLI_FRAMES for v in written.values())
              and os.path.exists(out + ".zip")
              and results["total_frames"] == len(names) * CLI_FRAMES
              and jf is not None and np.isfinite(jf) and 0.0 <= jf <= 1.0)
        log(f"{label}: evaluate wrote {[len(v) for v in written.values()]} "
            f"PNGs and {os.path.basename(out)}.zip, "
            f"{results['total_frames']} frames, J&F {jf} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{label}: the run's outputs are wrong")

        for r, state in zip(rngs, rng_states):
            r.bit_generator.state = state
        for v in range(len(names)):
            name, masks = direct_masks(sam_pt, cfg, v)
            labels = set()
            for t, frame in enumerate(written[name]):
                got = read_index_mask(os.path.join(out, name, frame))[0]
                labels |= set(np.unique(got).tolist())
                if not np.array_equal(got, masks[t]):
                    diff = int((got != masks[t]).sum())
                    raise SystemExit(f"{label}: {name}/{frame} differs from "
                                     f"the direct forward at {diff} pixels")
            log(f"{label}: {name}: {len(written[name])} written masks equal "
                f"the direct forward's pixel for pixel, labels "
                f"{sorted(labels)}")

        reader = next(iter(build_dataset(cfg).get_datasets()))
        t0 = time.perf_counter()
        for _ in reader:
            pass
        read_s = time.perf_counter() - t0
        cfg["output"] = f"{root}/out1"
        timed = evaluate(cfg)
        log(f"{label}: timed evaluate: {timed['total_frames']} frames in "
            f"{timed['total_process_time']:.3f} s = FPS {timed['fps']:.3f}; "
            f"the host reads a video ({CLI_FRAMES} PNG frames and the "
            f"first annotation, {H} x {W}) in {read_s:.3f} s; on {card}")

        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sam_pt_torch.vos_eval.eval",
             "dataset=D17", "size=480", f"d17_path={root}/DAVIS",
             f"output={root}/out2", "max_videos=1", "max_frames=8",
             "score=false", "visualize_results=false", *model],
            cwd=here, capture_output=True, text=True, timeout=600)
        lines = proc.stdout.splitlines()
        fps = [line for line in lines if line.startswith("FPS:")]
        on = [line for line in lines if line.startswith("Model on")]
        ok = (proc.returncode == 0 and len(fps) == 1
              and on == [f"Model on {sam_pt.device}"])
        log(f"{label}: python -m sam_pt_torch.vos_eval.eval (1 video, 8 "
            f"frames) exit {proc.returncode} in {time.perf_counter() - t0:.1f} s: "
            f"{'; '.join(on + fps)} {'OK' if ok else 'FAIL'}")
        if not ok:
            log(proc.stdout[-4000:])
            log(proc.stderr[-4000:])
            raise SystemExit(f"{label}: the entry point failed")
        del sam_pt, cfg
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def textured_frames(n_frames: int, seed: int, h=None, w=None) -> np.ndarray:
    """[T, h, w, 3] uint8 (H x W by default): 8 x 8 blocks of random
    colour, still for the first half of the video and then moving right 2
    pixels a frame, plus noise of +-8: a point's patches stay similar while
    the texture is still and, unless the point follows it, stop being
    similar after."""
    h, w = h or H, w or W
    rng = np.random.default_rng(seed)
    texture = rng.integers(0, 255, (h // 8 + 1, w // 8 + 1, 3))
    texture = texture.repeat(8, 0).repeat(8, 1)[:h, :w]
    still = n_frames // 2
    return np.stack([
        np.clip(np.roll(texture, 2 * max(0, t - still + 1), axis=1)
                + rng.integers(-8, 8, (h, w, 3)), 0, 255)
        for t in range(n_frames)]).astype(np.uint8)


# Patch similarities of the card and of the CPU differ in summation order
# (the LAB conversion, the bilinear taps); a flag may differ only where a
# similarity lies this close to the threshold.
PATCH_THRESHOLD_BAND = 1e-4


def patch_filter_phase(sam_pt, fa, fuse, card: str) -> None:
    """The main-path SamPt with `use_patch_matching_filtering` over a
    24-frame textured video with one object (`textured_frames`), the
    filter timed: launches equal to the
    schedule, output checks, and the visibility flags against the same
    similarities and cascade computed on the CPU from the card's
    trajectories and the tracker's visibilities."""
    from sam_pt_torch.models.sam_pt import patch_similarities
    from sam_pt_torch.utils.util import PointVisibilityType

    t = 24
    video = make_video(t, 1, seed=0)
    video["image"] = textured_frames(t, seed=12)
    n_points = sam_pt.positive_points_per_mask + sam_pt.negative_points_per_mask
    original = sam_pt._patch_filter
    calls = []

    def recorded(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flags = original(*args)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, args, flags))
        return flags

    sam_pt._patch_filter = recorded
    sam_pt.use_patch_matching_filtering = True
    try:
        fa.reset_launch_counts()
        out, masks = run_video(sam_pt, video, fuse)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
    finally:
        sam_pt.use_patch_matching_filtering = False
        del sam_pt._patch_filter
    expected = launch_schedule(sam_pt, [t], [t])
    log(f"patch filter: launches {launches} expected {expected}")
    if launches != expected or len(calls) != 1:
        raise SystemExit("patch filter: launch counts differ")
    log(f"patch filter: video {t} frames x 1 object: "
        + check_outputs(out, masks, t, 1, n_points))

    seconds, (images, qp, traj, vis), flags = calls[0]
    threshold = sam_pt.patch_similarity_threshold
    qp_cpu = torch.from_numpy(qp.reshape(-1, 3))
    sims_card = patch_similarities(images, traj.reshape(t, -1, 2),
                                   qp_cpu.to(images.device),
                                   sam_pt.patch_size).cpu()
    sims_cpu = patch_similarities(images.cpu(), traj.cpu().reshape(t, -1, 2),
                                  qp_cpu, sam_pt.patch_size)
    flags_cpu = original(images.cpu(), qp, traj.cpu(), vis.cpu())
    # Points with a similarity in the band may cascade differently.
    settled = ~((sims_cpu - threshold).abs() < PATCH_THRESHOLD_BAND).any(0)
    got = flags.cpu().reshape(t, -1)[:, settled]
    ref = flags_cpu.reshape(t, -1)[:, settled]
    kinds = {k.name: int((flags == float(k)).sum())
             for k in (PointVisibilityType.VISIBLE,
                       PointVisibilityType.PATCH_NON_SIMILAR,
                       PointVisibilityType.REJECTED_AFTER_PATCH_WAS_NON_SIMILAR)}
    ok = bool(torch.equal(got, ref)) and all(kinds.values())
    log(f"patch filter: flags {kinds}; card vs CPU similarities max |diff| "
        f"{float((sims_card - sims_cpu).abs().max()):.3e}, flags equal on "
        f"{int(settled.sum())}/{settled.numel()} points (the others within "
        f"{PATCH_THRESHOLD_BAND:g} of the threshold {threshold:g}); the "
        f"filter took {seconds:.4f} s ({t} frames x {n_points} points) on "
        f"{card} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("patch filter: the card's flags differ from the "
                         "CPU's, or a kind of flag never occurred")


def crop_phase(sam_pt, fa, fuse, card: str, profiling: bool = False) -> dict:
    """The main-path SamPt with `crop_pad_tokens` over the slice's first
    video (24 x 1): launches equal to the schedule, output checks, the pad
    region of the embedding zero, kernels against plain versions through
    the encoder and the decode chain, then the encode stage's device time
    uncropped and cropped, in turns (with `profiling`, each one's device
    time by kernel). Returns the launches."""
    model = sam_pt.sam_predictor.model
    t = 24
    video = make_video(t, 1, seed=0)
    n_points = sam_pt.positive_points_per_mask + sam_pt.negative_points_per_mask
    kh, kw = crop_grid(model.image_size)
    model.crop_pad_tokens = True
    try:
        fa.reset_launch_counts()
        out, masks = run_video(sam_pt, video, fuse)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        expected = launch_schedule(sam_pt, [t], [t])
        log(f"crop: launches {launches} expected {expected} (global blocks "
            f"over {kh} x {kw} tokens)")
        if launches != expected:
            raise SystemExit("crop: launch counts differ")
        log(f"crop: video {t} frames x 1 object: "
            + check_outputs(out, masks, t, 1, n_points))
        images = torch.from_numpy(video["image"][:4]).to(sam_pt.device)
        emb = sam_pt.sam_predictor.encode_frames(images, (H, W))
        pad = float(emb[:, kh:].abs().max()) if kh < emb.shape[1] else 0.0
        if pad != 0.0 or not bool(torch.isfinite(emb).all()):
            raise SystemExit(f"crop: the embedding's pad rows are not zero "
                             f"({pad})")
        reference_phase(sam_pt, fa, video, label="crop reference")
    finally:
        model.crop_pad_tokens = False

    images = torch.from_numpy(video["image"]).to(sam_pt.device)
    times = {False: [], True: []}
    for crop in (False, True, True, False):
        model.crop_pad_tokens = crop
        times[crop].append(profiled_ms(
            lambda: sam_pt._encode_all_frames(images), calls=1))
        if profiling and len(times[crop]) == 1:
            device_profile(f"encode_{t}_{'crop' if crop else 'full'}",
                           lambda: sam_pt._encode_all_frames(images), card)
    model.crop_pad_tokens = False
    full, cropped = (float(np.mean(times[c])) for c in (False, True))
    log(f"crop: encode of {t} frames, device time by the profiler (turns "
        f"A B B A): uncropped {times[False]} ms, cropped {times[True]} ms; "
        f"cropped / uncropped {cropped / full:.3f} (global blocks "
        f"{kh * kw} of {emb.shape[1] ** 2} tokens, window blocks "
        f"{window_count(kh, kw)} of {window_count(*emb.shape[1:3])} windows "
        f"a frame) on {card}")
    return launches


def window_count(kh: int, kw: int, window: int = 14) -> int:
    return -(-kh // window) * -(-kw // window)


def interactive_schedule(sam_pt, encodes) -> dict:
    """Launches of the interactive forwards: K1 and K2 per encode chunk as
    in `launch_schedule`, K3 5 per decoder pass of each decode chain the
    model ran (`chain_calls`: one a decoded chunk of frames)."""
    passes = 2 + sam_pt.iterative_refinement_iterations
    return dict(launch_schedule(sam_pt, encodes, []),
                cross=5 * passes * sam_pt.chain_calls)


def one_point_schedule(sam_pt, frames: int, objects: int) -> dict:
    """Launches of a one-point run over one video: each object's query
    frame encoded and decoded by one pass, then the video as on the plain
    path."""
    expected = launch_schedule(sam_pt, [1] * objects + [frames],
                               [objects * frames])
    expected["cross"] += 5 * objects
    return expected


def interactive_stages(sam_pt) -> Stages:
    """Time the interactive forward's stages on the host clock, each call
    between two synchronisations: the encode, the decodes (with their
    downloads), the tracker runs and the new points' DBSCAN + k-medoids."""
    from sam_pt_torch.models import sam_pt_interactive as module

    stages = Stages()
    for name in ("_encode_all_frames", "_predict_frames", "_track_points"):
        stages.wrap(sam_pt, name, name)
    stages.wrap(module, "extract_largest_cluster_points",
                "extract_largest_cluster_points")
    return stages


def direct_interactive_masks(model, cfg) -> tuple:
    """The masks the interactive run of `evaluate` should write for the
    tree's first video: its frames and every frame's objects read as the
    harness reads them, one `model.forward` an object with its ground
    truth, device fusion, the labels mapped back."""
    from sam_pt_torch.vos_eval.data.mask_mapper import MaskMapper
    from sam_pt_torch.vos_eval.eval import (build_dataset,
                                            device_fuse_index_masks)

    reader = next(iter(build_dataset(cfg).get_datasets()))
    mapper = MaskMapper()
    rgbs, onehots = [], []
    for data in reader:
        rgbs.append(data["rgb"])
        onehots.append(mapper.convert_mask(data["mask"],
                                           old_labels_allowed=True)[0])
    query = onehots[0]
    logits = []
    for i in range(len(query)):
        video = {"image": np.stack(rgbs), "target_hw": (H, W),
                 "query_masks": query[i:i + 1],
                 "query_point_timestep": np.zeros(1, np.float32),
                 "gt_masks": [m[i:i + 1] for m in onehots],
                 "video_id": f"direct-{i}"}
        logits.append(model.forward(video)["logits"])
    fused = device_fuse_index_masks(torch.cat(logits), query,
                                    [0] * len(query))
    return reader.vid_name, [mapper.remap_index_mask(m) for m in fused]


# The interactive run's model: the default model under SamPtInteractive,
# online, at most 3 interactions a frame, the default budget.
INTERACTIVE_MODEL = (
    "model._target_=sam_pt_torch.models.sam_pt_interactive.SamPtInteractive",
    "+model.online=true", "+model.interactions_max_per_frame=3")


def interactive_phase(fa, card: str, model=CLI_MODEL,
                      interactive=INTERACTIVE_MODEL) -> dict:
    """The CLI's interactive option and its one-point option, with the
    repo's default model, over the first video of the CLI phase's tree
    cut to INTERACTIVE_FRAMES frames (see the module's docstring, phase
    14). `model` and `interactive` hold the overrides that give the runs
    their model (a rehearsal on the CPU passes `device=cpu` and a small
    model). Returns the interactive run's launches."""
    import pickle
    import shutil
    import tempfile

    from sam_pt_torch.config import compose, instantiate
    from sam_pt_torch.config import resolve_interpolations
    from sam_pt_torch.vos_eval.data.image_io import read_index_mask
    from sam_pt_torch.vos_eval.eval import CONFIG_DIR, evaluate

    here = os.path.dirname(os.path.realpath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="interactive_phase_",
                            dir=os.path.join(here, "build"))
    t = INTERACTIVE_FRAMES
    try:
        (name,) = make_davis_tree(os.path.join(root, "DAVIS"), frames=t,
                                  videos=1)
        base = ["dataset=D17", "size=480", f"d17_path={root}/DAVIS",
                "visualize_results=false", *model]
        cfg = resolve_interpolations(compose(CONFIG_DIR, "vos_eval_root", [
            *base, f"output={root}/out0",
            "simulate_interactive_point_correction=true", *interactive,
            f"+model.output_root={root}/interactions"]))
        sam_pt = instantiate(cfg["model"])
        bias_for_a_live_run(sam_pt)
        if (type(sam_pt).__name__ != "SamPtInteractive"
                or sam_pt.device.type != cfg["device"]):
            raise SystemExit(f"interactive: built {type(sam_pt).__name__} "
                             f"on {sam_pt.device}")
        cfg["model"] = sam_pt
        rng_state = sam_pt.rng.bit_generator.state
        stages = interactive_stages(sam_pt)
        fa.reset_launch_counts()
        sam_pt.chain_calls = 0
        t0 = time.perf_counter()
        try:
            results = evaluate(cfg)
            torch.cuda.synchronize()
        finally:
            stages.restore()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        expected = interactive_schedule(sam_pt, [t, t])
        n_ppm = (sam_pt.positive_points_per_mask
                 + sam_pt.negative_points_per_mask)
        log(f"interactive: launches {launches} expected {expected} "
            f"({sam_pt.chain_calls} decode chains of "
            f"{2 + sam_pt.iterative_refinement_iterations} passes, "
            f"{DECODER_TOKENS + n_ppm + sam_pt.interactions_max + 3} tokens "
            f"in a refinement pass)")
        if launches != expected or not sam_pt.chain_calls:
            raise SystemExit("interactive: launch counts differ")

        budget = sam_pt.interactions_max - n_ppm
        used, ious, actions = [], [], {}
        for i in range(2):
            folder = os.path.join(root, "interactions",
                                  f"000--{name}--mask-{i}")
            with open(os.path.join(folder, "history.json")) as f:
                history = json.load(f)
            for file in ("achieved_iou_thresholds_cache.pkl", "final.pkl"):
                with open(os.path.join(folder, file), "rb") as f:
                    pickle.load(f)
            per_frame = {}
            for e in history:
                key = (e["frame_idx"], e["current_iou_threshold"])
                per_frame[key] = per_frame.get(key, 0) + 1
                action = f"{e['action']} {e['type']}"
                actions[action] = actions.get(action, 0) + 1
                ious += [e[k] for k in ("iou_before", "iou_after",
                                        "overall_iou_before",
                                        "overall_iou_after")]
            used.append(len(history))
            if len(history) > budget or max(
                    per_frame.values(), default=0) > 3:
                raise SystemExit(f"interactive: object {i} used "
                                 f"{len(history)} interactions")
        ious = np.asarray(ious)
        jf = results.get("J&F-Mean")
        ok = (np.isfinite(ious).all() and ((ious >= 0) & (ious <= 1)).all()
              and jf is not None and np.isfinite(jf)
              and results["total_frames"] == t)
        log(f"interactive: evaluate ({t} frames x 2 objects, online, IoU "
            f"threshold {sam_pt.online_interactive_iou_threshold}) used "
            f"{used} interactions of {budget} each ({actions}), histories "
            f"and pickles written, {ious.size} IoUs finite in [0, 1], J&F "
            f"{jf}, {wall:.3f} s, FPS {results['fps']:.3f} on {card} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("interactive: the run's outputs are wrong")
        timed = sum(stages.seconds.values())
        log("interactive: stages (serialized, host clock): " + ", ".join(
            f"{k} {v:.3f} s ({stages.calls[k]} calls)"
            for k, v in stages.seconds.items())
            + f", rest (the IoU and boundary scores, the harness) "
            f"{wall - timed:.3f} s")

        out = cfg["output"]
        sam_pt.rng.bit_generator.state = rng_state
        sam_pt.output_root = os.path.join(root, "direct")
        _, masks = direct_interactive_masks(sam_pt, cfg)
        frames = sorted(os.listdir(os.path.join(out, name)))
        for ti, frame in enumerate(frames):
            got = read_index_mask(os.path.join(out, name, frame))[0]
            if not np.array_equal(got, masks[ti]):
                raise SystemExit(f"interactive: {name}/{frame} differs from "
                                 f"the direct forward at "
                                 f"{int((got != masks[ti]).sum())} pixels")
        log(f"interactive: {len(frames)} written masks equal the direct "
            f"forward's pixel for pixel")
        del sam_pt, cfg
        torch.cuda.empty_cache()

        cfg = resolve_interpolations(compose(CONFIG_DIR, "vos_eval_root", [
            *base, f"output={root}/out1",
            "input_only_one_gt_mask_point=true"]))
        sam_pt = instantiate(cfg["model"])
        bias_for_a_live_run(sam_pt)
        cfg["model"] = sam_pt
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        results = evaluate(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        one = dict(fa.LAUNCHES)
        expected = one_point_schedule(sam_pt, t, 2)
        jf = results.get("J&F-Mean")
        ok = one == expected and jf is not None and np.isfinite(jf)
        log(f"one point: launches {one} expected {expected}; J&F {jf}, "
            f"{wall:.3f} s on {card} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("one point: launches or J&F wrong")
        del sam_pt, cfg
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# The variants' models on random weights (the checkpoints are not in the
# repository), composed as the CLI composes them.
VARIANT_MODEL = ("model.sam_predictor.allow_random_init=true",
                 "model.point_tracker.allow_random_init=true")


def compose_model(sam_config: str, overrides=VARIANT_MODEL):
    """`cfg["model"]` of `model=sam_pt model/sam@model.sam_predictor=
    <sam_config>` from the port's configs, instantiated on the card, the
    two output biases set (`bias_for_a_live_run`)."""
    import warnings

    from sam_pt_torch.config import compose, instantiate
    from sam_pt_torch.config import resolve_interpolations
    from sam_pt_torch.vos_eval.eval import CONFIG_DIR

    cfg = resolve_interpolations(compose(CONFIG_DIR, "vos_eval_root", [
        "model=sam_pt", f"model/sam@model.sam_predictor={sam_config}",
        *overrides]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the checkpoints are missing
        sam_pt = instantiate(cfg["model"])
    bias_for_a_live_run(sam_pt)
    return sam_pt


def variant_run(sam_pt, fa, fuse, label: str, card: str, seed: int):
    """One variant over VARIANT_VIDEO: launches equal to the schedule (K3
    at least 5 a decoder pass), output checks, a timed second pass.
    Returns (launches, video)."""
    t, m = VARIANT_VIDEO
    video = make_video(t, m, seed=seed)
    n_points = sam_pt.positive_points_per_mask + sam_pt.negative_points_per_mask
    fa.reset_launch_counts()
    out, masks = run_video(sam_pt, video, fuse)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    expected = launch_schedule(sam_pt, [t], [t * m])
    log(f"{label}: launches {launches} expected {expected}")
    if launches != expected:
        raise SystemExit(f"{label}: launch counts differ")
    log(f"{label}: video {t} frames x {m} objects: "
        + check_outputs(out, masks, t, m, n_points))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_video(sam_pt, video, fuse)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"{label}: timed pass {wall:.3f} s for {t} frames = "
        f"{t / wall:.3f} frames/s on {card}")
    return launches, video


VARIANT_STAGES = ("_encode_all_frames", "extract_query_points",
                  "_track_points_device", "_apply_sam_device")


def hq_phase(fa, fuse, card: str, profiling: bool) -> dict:
    """HQ-SAM ViT-H + PIPS (`model=sam_pt model/sam@model.sam_predictor=
    samhq_vit_huge`) at full width over VARIANT_VIDEO: launches, output
    checks, frames/s, kernels against plain versions through the encoder
    (its `interm` included) and the HQ decode chain; with --profile its
    stage split. Returns the launches."""
    t0 = time.perf_counter()
    sam_pt = compose_model("samhq_vit_huge")
    torch.cuda.synchronize()
    model = sam_pt.sam_predictor.model
    vit_dim = model.mask_decoder.compress_vit_feat[0].in_channels
    log(f"hq: built SamPt (HQ-SAM ViT-H {len(model.image_encoder.blocks)} "
        f"blocks, early features {vit_dim} wide, {model.dtype} + "
        f"{type(sam_pt.point_tracker).__name__}, random) in "
        f"{time.perf_counter() - t0:.1f} s; image->token keys in a "
        f"refinement pass: {hq_tokens()}")
    launches, video = variant_run(sam_pt, fa, fuse, "hq", card, seed=13)
    reference_phase(sam_pt, fa, video, label="hq reference")
    if profiling:
        stage_split(sam_pt, "hq_{}x{}".format(*VARIANT_VIDEO), VARIANT_STAGES,
                    lambda: run_video(sam_pt, video, fuse), card)
    del sam_pt
    torch.cuda.empty_cache()
    return launches


# TinyViT's bf16 embedding against the same weights in float32 on the
# card: bf16 rounds each op to 2^-8 relative; 3.5e-3 measured on the CPU
# at 512 pixels.
TINY_VIT_F32_REL_L2 = 2e-2


def mobile_phase(fa, fuse, card: str, profiling: bool) -> dict:
    """MobileSAM and Light HQ-SAM + PIPS (`sam_mobile_vit_tiny`,
    `samhq_light_vit_tiny`) over VARIANT_VIDEO: launches (K3 only: TinyViT
    runs no kernel), output checks, frames/s, K3 against its plain version
    through the decode chain, the bf16 embedding against float32 weights on
    the card, and the encode's device time beside ViT-B's (the default
    model's), in turns. Returns each variant's launches."""
    import copy

    from sam_pt_torch.models.sam.predictor import SamPredictor

    vit_b = compose_model("sam_vit_base")
    found = {}
    for name, seed in (("sam_mobile_vit_tiny", 14),
                       ("samhq_light_vit_tiny", 15)):
        sam_pt = compose_model(name)
        launches, video = variant_run(sam_pt, fa, fuse, name, card, seed)
        if launches["window"] or launches["global"]:
            raise SystemExit(f"{name}: K1 or K2 launched by TinyViT")
        log(f"{name}: K1 and K2 at 0 (TinyViT's attention is plain, as in "
            f"the JAX package), K3 {launches['cross']}: the decoder's only")
        reference_phase(sam_pt, fa, video, label=f"{name} reference")

        frames = torch.from_numpy(video["image"][:4]).to(sam_pt.device)
        model32 = copy.deepcopy(sam_pt.sam_predictor.model).float()
        emb16 = sam_pt.sam_predictor.encode_frames(frames, (H, W))
        emb32 = SamPredictor(model32).encode_frames(frames, (H, W))
        parts = emb16.keys() if isinstance(emb16, dict) else [None]
        errs = {k: float((a.float() - b).norm() / b.norm())
                for k in parts for a, b in [(emb16, emb32) if k is None
                                            else (emb16[k], emb32[k])]}
        ok = max(errs.values()) <= TINY_VIT_F32_REL_L2
        log(f"{name}: TinyViT bf16 vs float32 weights on the card rel_l2 "
            + ", ".join(f"{'emb' if k is None else k} {v:.3e}"
                        for k, v in errs.items())
            + f" (<= {TINY_VIT_F32_REL_L2:g}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name}: bf16 TinyViT disagrees with float32")
        del model32

        images = torch.from_numpy(video["image"]).to(sam_pt.device)
        times = {"tiny_vit": [], "vit_b": []}
        for which in ("tiny_vit", "vit_b", "vit_b", "tiny_vit"):
            model = sam_pt if which == "tiny_vit" else vit_b
            times[which].append(profiled_ms(
                lambda: model._encode_all_frames(images), calls=1))
        tiny, base = (float(np.mean(times[k])) for k in ("tiny_vit",
                                                          "vit_b"))
        log(f"{name}: encode of {len(images)} frames, device time by the "
            f"profiler (turns A B B A): TinyViT {times['tiny_vit']} ms, "
            f"ViT-B {times['vit_b']} ms; TinyViT / ViT-B {tiny / base:.3f} "
            f"on {card}")
        if profiling:
            stage_split(sam_pt, "{}_{}x{}".format(name, *VARIANT_VIDEO),
                        VARIANT_STAGES,
                        lambda: run_video(sam_pt, video, fuse), card)
        found[name] = launches
        del sam_pt
        torch.cuda.empty_cache()
    del vit_b
    torch.cuda.empty_cache()
    return found


# The demo phase's frame directory: DEMO_FRAMES PNG frames at H x W, two
# boxes moving over a random texture; the query file: 4 positives and 1
# negative a box on frame 0.
DEMO_FRAMES = 24
DEMO_BOXES = ((60, 200, 80, 300, 2, 4), (260, 420, 480, 700, 1, 3))


def write_demo_inputs(root: str, frames=None) -> tuple:
    """The demo phase's frame directory and query-points file under
    `root`: returns their paths."""
    from sam_pt_torch.vos_eval.data.image_io import write_png

    frames = DEMO_FRAMES if frames is None else frames
    rng = np.random.default_rng(16)
    folder = os.path.join(root, "frames")
    os.makedirs(folder)
    texture = rng.integers(0, 255, (H // 8 + 1, W // 8 + 1, 3))
    texture = texture.repeat(8, 0).repeat(8, 1)[:H, :W]
    colours = ((230, 40, 40), (40, 40, 230))
    for t in range(frames):
        frame = texture + rng.integers(-10, 10, (H, W, 3))
        for (y0, y1, x0, x1, dy, dx), colour in zip(DEMO_BOXES, colours):
            rows = slice((y0 + dy * t) * H // 480, (y1 + dy * t) * H // 480)
            cols = slice((x0 + dx * t) * W // 854, (x1 + dx * t) * W // 854)
            frame[rows, cols] = colour
        write_png(os.path.join(folder, f"{t:05d}.png"),
                  np.clip(frame, 0, 255).astype(np.uint8))
    lines = ["4"]
    for y0, y1, x0, x1, _, _ in DEMO_BOXES:
        ys = np.linspace(y0 + 20, y1 - 20, 4) * H / 480
        xs = np.linspace(x0 + 20, x1 - 20, 4) * W / 854
        neg = ((y1 + 25) * H / 480, (x1 + 25) * W / 854)
        lines.append("0 ; " + " ".join(
            f"{x:.1f},{y:.1f}" for x, y in [*zip(xs, ys), neg[::-1]]))
    points = os.path.join(root, "query_points.txt")
    with open(points, "w") as f:
        f.write("\n".join(lines) + "\n")
    return folder, points


def demo_phase(fa, card: str, model=CLI_MODEL) -> dict:
    """The port's demo with the repo's default model over a synthetic PNG
    frame directory (`write_demo_inputs`) under the gitignored `build/`:
    `main` in the process with the two output biases set (launches, 24
    overlay frames written, masks and tracks equal to a direct
    `SamPt.forward` on the same frames with the rng reset), then
    `python -m sam_pt_torch.demo` as a subprocess (exit 0, 24 frames, its
    frames/s line). `model` holds the overrides that give both runs their
    model. Returns the launches."""
    import shutil
    import tempfile

    from sam_pt_torch import demo
    from sam_pt_torch.config import compose, instantiate
    from sam_pt_torch.config import resolve_interpolations

    here = os.path.dirname(os.path.realpath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="demo_phase_",
                            dir=os.path.join(here, "build"))
    try:
        folder, points = write_demo_inputs(root)
        base = [f"frames_path={folder}", f"query_points_path={points}",
                *model]
        cfg = resolve_interpolations(compose(demo.CONFIG_DIR, "demo", [
            *base, f"output_dir={root}/out0"]))
        sam_pt = instantiate(cfg["model"])
        bias_for_a_live_run(sam_pt)
        cfg["model"] = sam_pt
        rng_state = sam_pt.rng.bit_generator.state
        fa.reset_launch_counts()
        outputs = demo.main(cfg)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        images, scale = demo.load_frames(folder, cfg["frame_stride"],
                                         cfg["max_frames"],
                                         cfg["longest_side_length"])
        qp, _ = demo.load_query_points(points, scale)
        t, m = len(images), len(qp)
        # the query frame's decode (one pair an object), then the video's
        expected = launch_schedule(sam_pt, [t], [m, t * m])
        written = sorted(os.listdir(os.path.join(root, "out0", "frames")))
        log(f"demo: main over {t} PNG frames {H} x {W} resized to "
            f"{images.shape[1]} x {images.shape[2]}, {m} masks of "
            f"{qp.shape[1]} points: launches {launches} expected "
            f"{expected}, {len(written)} frames written")
        if launches != expected or len(written) != t:
            raise SystemExit("demo: launches or written frames differ")

        sam_pt.rng.bit_generator.state = rng_state
        direct = demo.run_inference(sam_pt, images, qp)
        same = (np.array_equal(direct["logits"].float().cpu().numpy() > 0,
                               outputs["logits"] > 0)
                and np.array_equal(direct["trajectories"].cpu().numpy(),
                                   outputs["trajectories"]))
        fg = float((outputs["logits"] > 0).mean())
        log(f"demo: masks and tracks equal the direct forward's: {same} "
            f"(foreground {fg:.4f} of the pixels) {'OK' if same else 'FAIL'}")
        if not same:
            raise SystemExit("demo: the masks differ from the direct forward")
        del sam_pt, cfg
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sam_pt_torch.demo", *base,
             f"output_dir={root}/out1"],
            cwd=here, capture_output=True, text=True, timeout=600)
        fps = [line for line in proc.stdout.splitlines()
               if line.startswith("Inference:")]
        n = len(os.listdir(os.path.join(root, "out1", "frames"))) if (
            os.path.isdir(os.path.join(root, "out1", "frames"))) else 0
        ok = proc.returncode == 0 and len(fps) == 1 and n == t
        log(f"demo: python -m sam_pt_torch.demo exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s, {n} frames written: "
            f"{'; '.join(fps)} on {card} {'OK' if ok else 'FAIL'}")
        if not ok:
            log(proc.stdout[-4000:])
            log(proc.stderr[-4000:])
            raise SystemExit("demo: the entry point failed")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# The VIS phase's synthetic UVO-format tree: VIS_VIDEOS videos of
# VIS_FRAMES PNG frames at H x W; the port's VIS config at its own widths
# (SAM ViT-H shared by the generator and SamPt + PIPS, a 32 x 32 grid in
# batches of 64, 100 masks), on random weights (the checkpoints are not in
# the repository).
VIS_FRAMES = 16
VIS_VIDEOS = 2
VIS_CONFIG = "vis_eval_sam_pt"
VIS_DATASET = "chip_smoke_uvo"
VIS_MODEL = ("sam_shared.allow_random_init=true",
             "vos_model.point_tracker.allow_random_init=true")
# The hypernetworks' output scale of `vis_live_weights`.
VIS_LOGIT_SCALE = 1e4


def amg_tokens() -> int:
    """Tokens of the generator's decoder pass: the output tokens, the one
    point and the pad point `Sam.decode_masks` appends when no box is
    given (all valid); the VIS phase checks the count on the card."""
    return DECODER_TOKENS + 1 + 1


def vis_tokens(masks: int = 100) -> int:
    """Tokens of a box-refinement pass of SamPt's decode chain over
    `masks` masks with the VIS config's points (16 k-medoids positives, 1
    negative, every other mask's positives as negatives): the output
    tokens, the prompt, 2 box corners and the pad point; from 1024 the
    decoder's token self-attention takes K3 at head dim 32."""
    from sam_pt_torch.build import SAM_PT_SETTINGS

    n_pos = SAM_PT_SETTINGS["positive_points_per_mask"]
    points = n_pos + SAM_PT_SETTINGS["negative_points_per_mask"]
    return DECODER_TOKENS + points + n_pos * (masks - 1) + 2 + 1


def vis_frames(n_frames: int, seed: int) -> tuple:
    """[T, H, W, 3] uint8 frames of 2-3 shapes (a rectangle, an ellipse, a
    rectangle), each a colour of its own textured by 8 x 8 blocks of +-40,
    moving over a flat dark background, with noise of +-6, and the shapes'
    masks [T, n, H, W] bool (a later shape covers an earlier one)."""
    rng = np.random.default_rng(seed)
    n = 2 + seed % 2
    yy, xx = np.mgrid[0:H, 0:W]
    shapes = []
    for k in range(n):
        h, w = rng.integers(H // 5, H // 3), rng.integers(W // 6, W // 4)
        y0 = rng.integers(H // 16, H - h - H // 8)
        span = (W - w - W // 8) // n  # room to move right
        x0 = W // 32 + rng.integers(k * span, (k + 1) * span)
        dy, dx = rng.integers(-2, 3), rng.integers(2, 5)
        blocks = rng.integers(-40, 41, (H // 8 + 1, W // 8 + 1, 3))
        texture = rng.integers(60, 200, 3) + blocks.repeat(8, 0).repeat(
            8, 1)[:H, :W]
        shapes.append((h, w, y0, x0, dy, dx, texture, k == 1))
    frames = np.empty((n_frames, H, W, 3), np.uint8)
    masks = np.zeros((n_frames, n, H, W), bool)
    for t in range(n_frames):
        frame = np.full((H, W, 3), 24, np.int64)
        for k, (h, w, y0, x0, dy, dx, texture, ellipse) in enumerate(shapes):
            y, x = y0 + dy * t, x0 + dx * t
            if ellipse:
                inside = ((yy - y - h / 2) / (h / 2)) ** 2 + (
                    (xx - x - w / 2) / (w / 2)) ** 2 <= 1
            else:
                inside = (yy >= y) & (yy < y + h) & (xx >= x) & (xx < x + w)
            frame[inside] = texture[inside]
            masks[t, :k, inside] = False
            masks[t, k] = inside
        frames[t] = np.clip(frame + rng.integers(-6, 7, (H, W, 3)), 0, 255)
    return frames, masks


def make_vis_tree(root: str, frames=None, videos=None) -> tuple:
    """The VIS phase's tree under `root`, laid out as UVO v1's tiny split
    (`uvo_v1_val_tiny` under `data_root=root`): PNG frames and a
    class-agnostic YTVIS JSON whose ground-truth tracks are RLE, one a
    shape. Returns (json path, frame root, the JSON)."""
    from sam_pt_torch.vis_eval.rle import encode_mask
    from sam_pt_torch.vos_eval.data.image_io import write_png

    frames = VIS_FRAMES if frames is None else frames
    videos = VIS_VIDEOS if videos is None else videos
    image_root = os.path.join(root, "UVOv1.0", "uvo_videos_dense_frames")
    json_dir = os.path.join(root, "UVOv1.0", "VideoDenseSet")
    os.makedirs(json_dir)
    entries, anns = [], []
    for v in range(videos):
        images, masks = vis_frames(frames, seed=20 + v)
        names = [f"video{v}/{t:05d}.png" for t in range(frames)]
        os.makedirs(os.path.join(image_root, f"video{v}"))
        for name, image in zip(names, images):
            write_png(os.path.join(image_root, name), image)
        entries.append({"id": v + 1, "height": H, "width": W,
                        "length": frames, "file_names": names})
        for k in range(masks.shape[1]):
            anns.append({"id": len(anns) + 1, "video_id": v + 1,
                         "category_id": 1, "iscrowd": 0,
                         "segmentations": [encode_mask(m) if m.any()
                                           else None for m in masks[:, k]]})
    gt = {"videos": entries, "annotations": anns,
          "categories": [{"id": 1, "name": "object"}]}
    json_file = os.path.join(json_dir, "UVO_video_val_dense_tiny.json")
    with open(json_file, "w") as f:
        json.dump(gt, f)
    return json_file, image_root, gt


def vis_live_weights(adapter) -> None:
    """With N(0, 0.02^2) weights the generator keeps nothing, and output
    biases or scales alone do not change that: every predicted IoU lies
    near 0 (gate: > 0.88); every low-resolution
    logit within +-1 (stability, the share of pixels above +1 among those
    above -1: gate >= 0.95); the LayerNorms' N(0, 0.02^2) weights and
    biases wash the image out of the decoder's features, so a mask is the
    same for every point and image; and the random transposed convs give
    each of the 4 x 4 pixels a token upscales to its own sign, so every
    mask spans the frame and box NMS keeps one. Set, so that masks follow
    the image and the point: the two output biases of
    `bias_for_a_live_run` (the IoU head's last bias to 1, so IoUs lie near
    1; PIPS's visibility bias); the mask decoder's and the encoder neck's
    LayerNorms at their standard init (weight 1, bias 0); the decoder's
    two transposed convs with their four taps tied and no bias (each
    upscaled pixel a function of its own token); the prompt encoder's
    Gaussian positional matrix at SAM's scale, N(0, 1) (x 50); the four
    hypernetworks' last layers scaled by VIS_LOGIT_SCALE (every mask logit
    times it, so few pixels stay within +-1)."""
    bias_for_a_live_run(adapter.model)
    sam = adapter.model.sam_predictor.model
    decoder = sam.mask_decoder
    with torch.no_grad():
        for module in (decoder, sam.image_encoder.neck):
            for norm in module.modules():
                if isinstance(norm, torch.nn.LayerNorm):
                    norm.weight.fill_(1.0)
                    norm.bias.zero_()
        for i in (0, 3):
            conv = decoder.output_upscaling[i]
            conv.weight.copy_(conv.weight[..., :1, :1].expand_as(
                conv.weight))
            conv.bias.zero_()
        sam.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix.mul_(
            50.0)
        for mlp in decoder.output_hypernetworks_mlps:
            mlp.layers[-1].weight.mul_(VIS_LOGIT_SCALE)
            mlp.layers[-1].bias.mul_(VIS_LOGIT_SCALE)


def vis_schedule(adapter, tracked) -> dict:
    """Kernel launches of the VIS path over videos of (frames, tracked
    masks) `tracked`: per video, the generator's one-frame encode and its
    decodes (K3 5 a batch of `points_per_batch` points), then SamPt's
    (`launch_schedule`); a decoder pass whose tokens reach 1024 (100
    masks' prompts: 17 points and 16 of each other mask) also sends its
    two self-attentions through K3."""
    sam_pt, gen = adapter.model, adapter.sam_generator
    found = launch_schedule(sam_pt, [1] * len(tracked), [])
    batches = -(-len(gen.point_grids[0]) // gen.points_per_batch)
    found["cross"] = 5 * batches * len(tracked)
    tracked = [(t, m) for t, m in tracked if m]
    own = launch_schedule(sam_pt, [t for t, _ in tracked],
                          [t * m for t, m in tracked])
    points = sam_pt.positive_points_per_mask + sam_pt.negative_points_per_mask
    for key in ("window", "global"):
        found[key] += own[key]
    found["cross"] += own["cross"]
    dc = sam_pt.sam_decode_chunk
    for t, m in tracked:
        prompt = points + (sam_pt.positive_points_per_mask * (m - 1) if (
            sam_pt.add_other_objects_positive_points_as_negative_points)
            else 0)
        chunks = -(-t * m // min(dc, t * m))
        first = DECODER_TOKENS + prompt + 1  # the pad point
        passes = [first] * (2 if sam_pt.negative_points_per_mask else 1)
        passes += [first + 2] * sam_pt.iterative_refinement_iterations
        found["cross"] += 2 * chunks * sum(n >= 1024 for n in passes)
    return found


def vis_generator_check(gen, fa, frame: np.ndarray) -> None:
    """The generator's first batch of points on `frame` with the kernels
    and with their plain versions in their place: low-resolution logits
    rel. L2 and IoU as `reference_phase` holds them; the decoder's token
    count as `amg_tokens` says."""
    hw = frame.shape[:2]
    pts = gen.point_grids[0][:gen.points_per_batch] * np.array(
        [hw[1], hw[0]], np.float32)
    shapes = []
    cross = fa.cross_attention

    def recorded(q, k, v, **kwargs):
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return cross(q, k, v, **kwargs)

    fa.cross_attention = recorded
    try:
        emb = gen._encode(frame)
        low_k, iou_k = gen._decode(emb, pts, hw)
    finally:
        fa.cross_attention = cross
    with plain_route(fa):
        low_p, iou_p = gen._decode(gen._encode(frame), pts, hw)
    rel = rel_l2(low_k, low_p)
    d_iou = float((iou_k - iou_p).abs().max())
    tokens = sorted({q[1] for q, k in shapes if k[1] >= 1024})
    b = gen.points_per_batch
    ok = rel < 5e-2 and d_iou < 5e-2 and (
        not shapes or tokens == [amg_tokens()])
    log(f"vis generator: first batch ({b} points x 3 masks) kernels vs "
        f"plain: low-res logits rel_l2 {rel:.3e}, iou max diff "
        f"{d_iou:.3e}; K3 calls {len(shapes)} of q x k "
        f"{sorted(set(shapes))} (tokens {tokens}, amg_tokens() "
        f"{amg_tokens()}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("vis: the generator's kernel path disagrees")


@contextlib.contextmanager
def first_decode_chunk(sam_pt):
    """Within the block, record the first decode chunk that `sam_pt` runs
    (`_chain`): yields a list that then holds (its inputs, its outputs)."""
    chain = sam_pt._chain
    first = []

    def recorded(*args):
        out = chain(*args)
        if not first:
            first.append((args, out))
        return out

    sam_pt._chain = recorded
    try:
        yield first
    finally:
        del sam_pt._chain


# The capacity run's video length: video 0 cut to its first frames.
VIS_CAPACITY_FRAMES = 8


def vis_capacity_run(adapter, fa, dataset) -> dict:
    """The VIS path at the config's `max_num_masks` (100; UVO's videos
    give about as many proposals): video 0 cut to VIS_CAPACITY_FRAMES
    frames, the generator's box NMS threshold raised to 1 so that it keeps
    every survivor of its gates and the adapter tracks the first 100. The
    prompts then hold vis_tokens() tokens, past 1024, so the decoder's
    token self-attention takes K3 at head dim 32 (`vis_schedule`'s
    branch). Fails unless the launches equal the schedule, every track is
    kept and the run's first decode chunk agrees with the plain route.
    Returns the launches."""
    sam_pt, gen = adapter.model, adapter.sam_generator
    video = dataset.load_video(dataset.videos[0])
    video["image"] = video["image"][:VIS_CAPACITY_FRAMES]
    t = len(video["image"])
    nms = gen.box_nms_thresh
    gen.box_nms_thresh = 1.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fa.reset_launch_counts()
    try:
        with first_decode_chunk(sam_pt) as first:
            out = adapter([video])
            torch.cuda.synchronize()
    finally:
        gen.box_nms_thresh = nms
    seconds = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    m = len(out["pred_masks"])
    expected = vis_schedule(adapter, [(t, m)])
    args, kernel_out = first[0]
    points = args[1].shape[1]
    ok = (launches == expected and m == adapter.max_num_masks
          and all(mask.shape == (t, H, W) for mask in out["pred_masks"])
          and bool(np.isfinite(out["trajectories"]).all()))
    log(f"vis capacity: video 0's first {t} frames, box NMS threshold 1: "
        f"{m} tracks, {points} points a prompt ({DECODER_TOKENS + points + 3}"
        f" tokens in a refinement pass), launches {launches} expected "
        f"{expected}, {seconds:.3f} s {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("vis capacity: launches or tracks are wrong")
    chain_check(sam_pt, fa, args, f"vis capacity SamPt (its first chunk, "
                f"{len(args[1])} pairs)", kernel_out)
    return launches


def vis_kernel_cases(fa, device, pairs: int, masks: int) -> dict:
    """K3 at the VIS evaluate run's tracked prompts (`cross_attention_vis`):
    a decode chunk of `pairs` pairs in a box-refinement pass over `masks`
    masks, vis_tokens(masks) tokens, the pad slot masked out of the
    image->token direction's keys (a box is given); above 64 keys both
    directions take the token->image kernel."""
    valid = torch.ones((pairs, vis_tokens(masks)), dtype=torch.bool,
                       device=device)
    valid[:, -1] = False
    t2i, i2t = cross_pair_cases(fa, bf16_randn(device, 2), valid)
    return {"cross_vis": t2i, "cross_vis_masked": i2t}


# (label, owner on the adapter, method) of the VIS stage split; the
# generator's host work (boxes, records, NMS) is what `generate` spends
# outside the three stages below it.
VIS_STAGES = (("generator", "sam_generator", "generate"),
              ("generator encode", "sam_generator", "_encode"),
              ("generator decode", "sam_generator", "_decode"),
              ("gate and upscale", "sam_generator", "_gate_and_upscale"),
              ("SamPt", "model", "forward"))


def vis_phase(fa, card: str, model=VIS_MODEL,
              profiling: bool = False) -> dict:
    """The port's VIS path at full width (see the module's docstring,
    phase 18). `model` holds the overrides that give both runs their
    model (a rehearsal on the CPU passes `device=cpu` and tiny models).
    Returns the launches of the evaluate run ("launches") and, in it, the
    K3 launches of the generator's decodes ("amg") and of SamPt
    ("sam_pt"), its tracks a video ("tracked"), SamPt's decode chunk
    ("pairs") and the launches of `vis_capacity_run` ("capacity")."""
    import shutil
    import tempfile

    from sam_pt_torch.config import compose, instantiate
    from sam_pt_torch.config import resolve_interpolations
    from sam_pt_torch.vis_eval import eval as vis_eval
    from sam_pt_torch.vis_eval.datasets import VISDataset, register_dataset
    from sam_pt_torch.vis_eval.rle import decode_mask

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.realpath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="vis_phase_",
                            dir=os.path.join(here, "build"))
    try:
        t0 = time.perf_counter()
        json_file, image_root, gt = make_vis_tree(root)
        register_dataset(VIS_DATASET, json_file, image_root,
                         class_agnostic=True)
        log(f"vis: wrote the UVO-format tree ({VIS_VIDEOS} videos x "
            f"{VIS_FRAMES} PNG frames {H} x {W}, "
            f"{len(gt['annotations'])} ground-truth tracks as RLE) in "
            f"{time.perf_counter() - t0:.1f} s")
        cfg = resolve_interpolations(compose(vis_eval.CONFIG_DIR, VIS_CONFIG, [
            f"dataset={VIS_DATASET}", f"output={root}/out0", *model]))
        t0 = time.perf_counter()
        adapter = instantiate(cfg["model"])
        vis_live_weights(adapter)
        torch.cuda.synchronize()
        sam_pt, gen = adapter.model, adapter.sam_generator
        encoder = sam_pt.sam_predictor.model.image_encoder
        log(f"vis: instantiated cfg['model'] ({type(adapter).__name__}: SAM "
            f"{len(encoder.blocks)} blocks {sam_pt.sam_predictor.model.dtype}"
            f" shared by the generator and "
            f"{type(sam_pt).__name__} + "
            f"{type(sam_pt.point_tracker).__name__}; a "
            f"{int(len(gen.point_grids[0]) ** 0.5)}^2 grid in batches of "
            f"{gen.points_per_batch}, {adapter.max_num_masks} masks, tracker"
            f" batch {sam_pt.point_tracker_mask_batch_size}) on "
            f"{sam_pt.device} in {time.perf_counter() - t0:.1f} s")
        if gen.predictor is not sam_pt.sam_predictor:
            raise SystemExit("vis: the generator and SamPt hold two "
                             "predictors")
        if sam_pt.device.type != cfg["device"]:
            raise SystemExit(f"vis: the model is not on {cfg['device']}")
        dataset = VISDataset(json_file, image_root, True)
        first = dataset.load_video(dataset.videos[0])["image"][0]
        vis_generator_check(gen, fa, first)

        cfg["model"] = adapter
        rng_state = sam_pt.rng.bit_generator.state
        stages = Stages()
        stages.wrap(gen, "_decode", "generator decode")
        stages.wrap(gen, "_gate_and_upscale", "gates",
                    count=lambda out: 0 if out is None else len(out[0]))
        stages.wrap(sam_pt, "forward", "SamPt")
        fa.reset_launch_counts()
        try:
            with first_decode_chunk(sam_pt) as first_chunk:
                results = vis_eval.evaluate(cfg)
                torch.cuda.synchronize()
        finally:
            stages.restore()
        launches = dict(fa.LAUNCHES)
        with open(os.path.join(root, "out0", "results.json")) as f:
            records = json.load(f)
        tracked = [sum(r["video_id"] == v["id"] for r in records)
                   for v in dataset.videos]
        expected = vis_schedule(adapter, [(VIS_FRAMES, m) for m in tracked])
        amg = stages.launches["generator decode"]["cross"]
        own = stages.launches.get("SamPt", {}).get("cross", 0)
        log(f"vis: launches {launches} expected {expected}; K3 of the "
            f"generator's decodes {amg}, of SamPt {own}; "
            f"{stages.counts.get('gates', 0)} of "
            f"{3 * len(gen.point_grids[0]) * len(dataset.videos)} candidates "
            f"passed both gates (the device's counts), {sum(tracked)} "
            f"tracked after box NMS")
        if launches != expected:
            raise SystemExit("vis: launch counts differ from the schedule")
        stats = {k: v for k, v in results.items()
                 if k not in ("fps", "n_records")}
        ok = (len(stats) == 12 and all(np.isfinite(v) and (
            v == -1.0 or 0.0 <= v <= 1.0) for v in stats.values())
            and all(2 <= m <= adapter.max_num_masks for m in tracked)
            and all(len(r["segmentations"]) == VIS_FRAMES for r in records))
        log(f"vis: evaluate: {results['n_records']} tracks ({tracked} a "
            f"video), fps {results['fps']:.3f}, "
            + ", ".join(f"{k} {v:.4f}" for k, v in stats.items())
            + f" {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("vis: the run's outputs are wrong")
        args, kernel_out = first_chunk[0]
        chain_check(sam_pt, fa, args, f"vis SamPt (video 0's first chunk: "
                    f"{len(args[1])} pairs, {args[1].shape[1]} points a "
                    f"prompt)", kernel_out)
        del first_chunk, args, kernel_out

        sam_pt.rng.bit_generator.state = rng_state
        timed = Stages()
        timed.wrap(gen, "generate", "generate")
        timed.wrap(sam_pt, "forward", "track")
        frames, outs = 0, []
        try:
            for meta in dataset.videos:
                video = dataset.load_video(meta)
                frames += len(video["image"])
                outs.append(adapter([video]))
        finally:
            timed.restore()
        for v, (meta, out) in enumerate(zip(dataset.videos, outs)):
            direct = vis_eval.predictions_to_records(out, meta["id"])
            written = [r for r in records if r["video_id"] == meta["id"]]
            same = len(direct) == len(written) and all(
                a["segmentations"] == b["segmentations"]
                and a["score"] == b["score"] for a, b in zip(direct, written))
            decoded = all(
                np.array_equal(decode_mask(seg) if seg else
                               np.zeros((H, W), bool), m)
                for r, masks in zip(written, out["pred_masks"])
                for seg, m in zip(r["segmentations"], masks))
            log(f"vis: video {v}: {len(written)} tracks, the written "
                f"records equal a direct adapter call's with the rng reset: "
                f"{same}; results.json decodes to the downloaded masks: "
                f"{decoded} {'OK' if same and decoded else 'FAIL'}")
            if not (same and decoded):
                raise SystemExit("vis: the records differ from the direct "
                                 "adapter call")
        log(f"vis: generator {timed.seconds['generate'] / VIS_VIDEOS:.3f} s "
            f"a frame ({len(gen.point_grids[0])} points, 3 masks each); "
            f"SamPt tracking {frames / timed.seconds['track']:.3f} frames/s "
            f"({tracked} masks over {frames} frames); evaluate fps "
            f"{results['fps']:.3f}; on {card}")

        if profiling:
            stages = Stages()
            for label, owner, name in VIS_STAGES:
                stages.wrap(getattr(adapter, owner), name, label)
            stages.wrap(vis_eval, "predictions_to_records", "RLE encoding")
            stages.wrap(vis_eval.YTVOSEvaluator, "evaluate", "scoring")
            cfg["output"] = f"{root}/out1"
            t0 = time.perf_counter()
            try:
                vis_eval.evaluate(cfg)
                torch.cuda.synchronize()
            finally:
                stages.restore()
            total = time.perf_counter() - t0
            split = dict(stages.seconds)
            split["generator host"] = split.pop("generator") - sum(
                split[k] for k in ("generator encode", "generator decode",
                                   "gate and upscale"))
            log(f"profile vis: serialized {total:.4f} s: " + ", ".join(
                f"{k} {v:.4f} ({100 * v / total:.1f}%)"
                for k, v in split.items())
                + f", rest {total - sum(split.values()):.4f}")
            video = dataset.load_video(dataset.videos[0])
            device_profile("vis_video0", lambda: adapter([video]), card)

        capacity = vis_capacity_run(adapter, fa, dataset)
        # The entry point shares the card: hand back the blocks this
        # process keeps cached (the capacity run leaves ~79 GB reserved
        # for 27 GB allocated at most).
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sam_pt_torch.vis_eval.eval",
             "dataset=uvo_v1_val_tiny", f"data_root={root}",
             f"output={root}/out2", "max_videos=1",
             "+vos_model.point_tracker_mask_batch_size=100",
             f"device={cfg['device']}", *model],
            cwd=here, capture_output=True, text=True, timeout=600)
        lines = proc.stdout.splitlines()
        shown = [line for line in lines if line.startswith(
            ("Model on", "Generated", "FPS:", "{'AP'"))]
        ok = (proc.returncode == 0
              and f"Model on {sam_pt.device}" in shown
              and any(line.startswith("{'AP'") for line in shown)
              and os.path.exists(os.path.join(root, "out2", "results.json")))
        # Random weights as built keep no proposal: the run tracks nothing.
        log(f"vis: python -m sam_pt_torch.vis_eval.eval (1 video, random "
            f"weights as built) exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s: {'; '.join(shown)} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            log(proc.stdout[-4000:])
            log(proc.stderr[-4000:])
            raise SystemExit("vis: the entry point failed")
        pairs = sam_pt.sam_decode_chunk
        del adapter, sam_pt, gen, cfg
        torch.cuda.empty_cache()
        log(f"vis: the phase took {time.perf_counter() - t_phase:.1f} s")
        return {"launches": launches, "amg": amg, "sam_pt": own,
                "tracked": tracked, "pairs": pairs, "capacity": capacity}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# Phase 19: TAPIR and TapNet under SamPt with SAM ViT-B (the YAMLs'
# settings, random f32 weights; no head scaled: on these weights the card's
# tracks stay well within TRACKER_CPU_ATOL of the CPU's, PERF.md §6).
HAIKU_TRACKERS = ("tapir", "tapnet")
HAIKU_VIDEO = (24, 2)


def build_haiku_sam_pt(device, name: str):
    """`build_sam_pt(device, sam="vit_b", tracker=name,
    **DEFAULT_SETTINGS)`, SAM in bf16."""
    from sam_pt_torch.build import DEFAULT_SETTINGS, build_sam_pt

    return build_sam_pt(device, dtype=torch.bfloat16, seed=0, sam="vit_b",
                        tracker=name, **DEFAULT_SETTINGS)


def tracker_queries(rng, n_points: int, frames, h: int, w: int):
    """[1, n_points, 3] (t, x, y): query frames cycling through `frames`,
    positions uniform 8 pixels inside the frame."""
    ts = np.asarray(frames)[np.arange(n_points) % len(frames)]
    xy = rng.uniform([8, 8], [w - 8, h - 8], (n_points, 2))
    return np.concatenate([ts[:, None], xy], 1)[None].astype(np.float32)


def haiku_tracker_phase(fa, device, fuse, card: str, profiling: bool,
                        build=build_haiku_sam_pt) -> dict:
    """Phase 19, for TAPIR and for TapNet: SamPt with SAM ViT-B (bf16) and
    the tracker (f32) over a DAVIS-shaped 24-frame x 2-object video
    (launches equal to the schedule, output checks, a timed second pass,
    the reference check through ViT-B's encoder and the decode chain;
    with --profile its stage split), then the trackers alone
    (`haiku_tracker_checks`). Returns each tracker's launches."""
    t_phase = time.perf_counter()
    found = {}
    t, m = HAIKU_VIDEO
    for name in HAIKU_TRACKERS:
        t0 = time.perf_counter()
        sam_pt = build(device, name)
        bias_for_a_live_run(sam_pt)
        torch.cuda.synchronize()
        log(f"{name}: built SamPt (SAM {sam_pt.sam_predictor.model.dtype}, "
            f"{type(sam_pt.point_tracker).__name__} float32, random) in "
            f"{time.perf_counter() - t0:.1f} s")
        video = make_video(t, m, seed=12)
        n_points = (sam_pt.positive_points_per_mask
                    + sam_pt.negative_points_per_mask)
        fa.reset_launch_counts()
        out, masks = run_video(sam_pt, video, fuse)
        torch.cuda.synchronize()
        found[name] = dict(fa.LAUNCHES)
        expected = launch_schedule(sam_pt, [t], [t * m])
        log(f"{name}: launches {found[name]} expected {expected}")
        if found[name] != expected:
            raise SystemExit(f"{name}: launch counts differ")
        log(f"{name}: video {t} frames x {m} objects: "
            + check_outputs(out, masks, t, m, n_points))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_video(sam_pt, video, fuse)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"{name}: timed pass {wall:.3f} s for {t} frames = "
            f"{t / wall:.3f} frames/s on {card}")
        reference_phase(sam_pt, fa, video, label=f"{name} reference")
        if profiling:
            stage_split(sam_pt, f"{name}_{t}x{m}", (
                "_encode_all_frames", "extract_query_points",
                "_track_points_device", "_apply_sam_device"),
                lambda: run_video(sam_pt, video, fuse), card)
        del sam_pt
        torch.cuda.empty_cache()
    haiku_tracker_checks(device, card)
    log(f"tapir/tapnet: the phase took {time.perf_counter() - t_phase:.1f} s")
    return found


def haiku_tracker_checks(device, card: str, frames: int = 24) -> None:
    """TAPIR and TapNet alone (random f32 weights, the YAMLs' settings):
    17 points through a `frames` x 480 x 854 video, query frames 0,
    frames // 3 and the last (finite; TapNet pinned at the query frames,
    TAPIR not: its refinement moves the query frame too), a warm pass, then a timed one.
    Then TAPIR, TapNet and the online TAPIR (4 frames streamed one at a
    time from the query frame) on an 8-frame 96 x 160 video, the card's
    run against the same weights' run on the CPU, TF32 off."""
    from sam_pt_torch.build import TRACKER_SETTINGS
    from sam_pt_torch.models.tracker import TRACKER_REGISTRY
    from sam_pt_torch.models.tracker.tapir.tracker import (
        OnlineTapirPointTracker)

    rng = np.random.default_rng(13)
    n_points = 17
    video = torch.from_numpy(rng.integers(0, 255, (1, frames, H, W, 3)
                                          ).astype(np.uint8)).to(device)
    qp = tracker_queries(rng, n_points, [0, frames // 3, frames - 1], H, W)
    rows = np.arange(n_points)
    for name in HAIKU_TRACKERS:
        tracker = TRACKER_REGISTRY[name](allow_random_init=True, seed=1,
                                         device=device,
                                         **TRACKER_SETTINGS[name])
        tracker.forward_device(video, qp)  # warm
        fresh = video.clone()  # a new tensor: the feature cache misses
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traj, vis = tracker.forward_device(fresh, qp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        traj = traj[0].cpu().numpy()
        pin = float(np.abs(traj[qp[0, :, 0].astype(int), rows]
                           - qp[0, :, 1:]).max())
        pinned = name == "tapnet"
        ok = (traj.shape == (frames, n_points, 2) and np.isfinite(traj).all()
              and (pin <= 1e-3 or not pinned)
              and tuple(vis.shape) == (1, frames, n_points))
        log(f"tracker {name}: {frames} frames {H} x {W}, {n_points} points: "
            f"timed pass {wall:.3f} s = {frames / wall:.3f} frames/s on "
            f"{card}; finite, query-frame error {pin:.2e} px "
            + ("(<= 1e-3)" if pinned else "(not pinned)")
            + f", moved up to "
            f"{float(np.abs(traj - qp[0, None, :, 1:]).max()):.1f} px, "
            f"visible {float(vis.mean()):.3f} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"tracker {name}: bad trajectories")
        del tracker, fresh
        torch.cuda.empty_cache()

    small = torch.from_numpy(rng.integers(0, 255, (1, 8, 96, 160, 3)).astype(
        np.uint8))
    qp = tracker_queries(rng, n_points, [0, 7], 96, 160)

    def online(tracker, frames):
        tracker.init_tracking(frames[0], qp[0, :, 1:])
        return torch.from_numpy(np.stack(
            [tracker.track_frame(f)[0] for f in frames[:4]]))

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name in (*HAIKU_TRACKERS, "online tapir"):
            runs = []
            for dev, video_on in ((device, small.to(device)), ("cpu", small)):
                if name == "online tapir":
                    tracker = OnlineTapirPointTracker(
                        allow_random_init=True, seed=1, device=dev)
                else:
                    tracker = TRACKER_REGISTRY[name](
                        allow_random_init=True, seed=1, device=dev,
                        **TRACKER_SETTINGS[name])
                if runs:  # the card's weights, on the CPU
                    tracker.model.load_state_dict(weights)
                else:
                    weights = {k: v.cpu() for k, v in
                               tracker.model.state_dict().items()}
                runs.append(online(tracker, video_on[0]) if name ==
                            "online tapir" else
                            tracker.forward_device(video_on, qp)[0][0].cpu())
            err = float((runs[0] - runs[1]).abs().max())
            ok = (bool(torch.isfinite(runs[0]).all())
                  and err <= TRACKER_CPU_ATOL)
            log(f"tracker {name} card vs CPU (8 x 96 x 160, f32, TF32 off"
                + (", 4 frames streamed" if name == "online tapir" else "")
                + f"): max |diff| {err:.3e} px (<= {TRACKER_CPU_ATOL:g}) "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"tracker {name}: the card disagrees with "
                                 f"the CPU")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


# The CLI phase's `evaluate` with TAPIR in the default model, one video.
TAPIR_CLI_MODEL = ("model/point_tracker=tapir", *CLI_MODEL)


def tracker_demo_phase(card: str, args=()) -> dict:
    """`python -m sam_pt_torch.models.tracker.<name>.demo` for TAPIR and
    TapNet as subprocesses over the demo phase's PNG frames (all 24, at
    the demo's 512-pixel longest side), on the card unless `args` say
    otherwise: exit 0 and the frames/s of the steady-state forward.
    Returns each demo's line."""
    import shutil
    import tempfile

    here = os.path.dirname(os.path.realpath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="tracker_demo_",
                            dir=os.path.join(here, "build"))
    found = {}
    try:
        folder, points = write_demo_inputs(root)
        for name in HAIKU_TRACKERS:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m",
                 f"sam_pt_torch.models.tracker.{name}.demo", "--frames",
                 folder, "--query-points", points, "--frame-stride", "1",
                 "--max-frames", str(DEMO_FRAMES), "--out",
                 os.path.join(root, name), *args],
                cwd=here, capture_output=True, text=True, timeout=600)
            lines = [line for line in proc.stdout.splitlines()
                     if "frames/s" in line]
            ok = proc.returncode == 0 and len(lines) == 1
            found[name] = lines[0] if lines else None
            log(f"tracker demo {name}: exit {proc.returncode} in "
                f"{time.perf_counter() - t0:.1f} s: {'; '.join(lines)} on "
                f"{card} {'OK' if ok else 'FAIL'}")
            if not ok:
                log(proc.stdout[-4000:])
                log(proc.stderr[-4000:])
                raise SystemExit(f"tracker demo {name}: the entry point "
                                 f"failed")
        return found
    finally:
        shutil.rmtree(root, ignore_errors=True)


# Phase 20: SamPt with SAM ViT-B and SuperGlue over 24 x 2, the tracker's
# live weights (`superglue_live_weights`) and the checks' bounds.
SUPERGLUE_VIDEO = (24, 2)
SUPERGLUE_PROJ_SCALE = 64.0
# A mask fails where it has no visible positive on more than this share of
# frames 1-23.
SUPERGLUE_EMPTY_SHARE = 0.5
# The card's log transport plan against the CPU's (float32, TF32 off), over
# the valid rows and columns and the dustbins: |diff| <= ATOL + RTOL |cpu|
# (entries reach ~1e3 with the live weights; 100 Sinkhorn iterations).
SUPERGLUE_PLAN_ATOL, SUPERGLUE_PLAN_RTOL = 1e-2, 1e-4
SUPERGLUE_CLI_MODEL = ("model/point_tracker=superglue", *CLI_MODEL)


def build_superglue_sam_pt(device):
    """`build_sam_pt(device, sam="vit_b", tracker="superglue",
    **DEFAULT_SETTINGS)`, SAM in bf16, SuperGlue in f32 at its published
    widths (1024 keypoints, 9 pairs x 4 heads, 100 Sinkhorn iterations,
    threshold 0.2)."""
    from sam_pt_torch.build import DEFAULT_SETTINGS, build_sam_pt

    return build_sam_pt(device, dtype=torch.bfloat16, seed=0, sam="vit_b",
                        tracker="superglue", **DEFAULT_SETTINGS)


def superglue_live_weights(tracker, scale: float = SUPERGLUE_PROJ_SCALE
                           ) -> None:
    """Random N(0, 0.02^2) weights give SuperPoint descriptors that are
    nearly constant over a frame (the biases outweigh the shrinking
    activations) and SuperGlue a near-uniform transport plan, which no
    match passes at 0.2. Live instead: SuperPoint's conv weights, the same
    draws, each filter made zero-mean (so that it answers the texture's
    contrast, not its brightness: otherwise any two descriptors of a frame
    have a cosine near 0.99) and rescaled to N(0, 2/fan_in), zero biases;
    SuperGlue's propagations' last convs and the keypoint encoder's output
    conv zero, so that the descriptors pass through the network as they
    are; `final_proj` `scale` times the identity, so that the scores are
    scale^2/16 times the descriptors' cosine; the dustbin score 1."""
    with torch.no_grad():
        for m in tracker.superpoint.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.sub_(m.weight.mean(dim=(1, 2, 3), keepdim=True))
                m.weight.mul_((2.0 / m.weight[0].numel()) ** 0.5
                              / m.weight.std())
                m.bias.zero_()
        sg = tracker.superglue
        for conv in [layer.mlp[-1] for layer in sg.gnn.layers] + [
                sg.kenc.encoder[-1]]:
            conv.weight.zero_()
            conv.bias.zero_()
        eye = torch.eye(sg.descriptor_dim, device=sg.bin_score.device)
        sg.final_proj.weight.copy_(scale * eye[:, :, None])
        sg.final_proj.bias.zero_()
        sg.bin_score.fill_(1.0)


def superglue_reinit_schedule(sam_pt, frames: int, windows) -> dict:
    """Launches of a re-initialising forward with SuperGlue: one encode
    of the video; per horizon window (direction, start, end, masks) the
    decode of its tracked pairs and, before its track, the decode of its
    query masks from its points (one pair a mask: `set_masks`)."""
    return launch_schedule(sam_pt, [frames],
                           [(b - a) * k for _, a, b, k in windows]
                           + [k for *_, k in windows])


def superglue_matches(tracker, images) -> np.ndarray:
    """Matches of frame 0 against each later frame of [T, H, W, 3] uint8
    `images` on the tracker's device: [T - 1] counts."""
    from sam_pt_torch.ops.color import rgb_to_gray

    det = tracker.detect(rgb_to_gray(images) / 255.0)
    matches = tracker.match({k: v[:1] for k, v in det.items()},
                            {k: v[1:] for k, v in det.items()},
                            tuple(images.shape[1:3]))
    return (matches > -1).sum(1).cpu().numpy()


def visible_positives(out, n_pos: int) -> np.ndarray:
    """[T, M] counts of each mask's visible positive points a frame."""
    return (out["visibilities"][:, :, :n_pos] == 1).sum(-1).cpu().numpy()


def superglue_video(n_frames: int, n_masks: int, seed: int) -> dict:
    """`make_video`'s boxes on frame 0 over `textured_frames`, whose
    texture moves in the second half."""
    video = make_video(1, n_masks, seed)
    video["image"] = textured_frames(n_frames, seed)
    return video


def superglue_phase(fa, device, fuse, card: str, profiling: bool,
                    build=build_superglue_sam_pt) -> dict:
    """Phase 20: SamPt with SAM ViT-B (bf16) and SuperGlue (f32, live
    weights) over a textured 24 x 2 video (launches, output checks, the
    matches a frame and each mask's visible positives, a timed second pass,
    the reference check at ViT-B); one re-initialising pass (the reinit
    `set_masks` branch); the tracker alone and against the CPU
    (`superglue_tracker_checks`); a short card check of label propagation.
    Returns the first run's launches."""
    from sam_pt_torch.build import REINIT_SETTINGS

    t_phase = time.perf_counter()
    t, m = SUPERGLUE_VIDEO
    t0 = time.perf_counter()
    sam_pt = build(device)
    bias_for_a_live_run(sam_pt)
    superglue_live_weights(sam_pt.point_tracker)
    torch.cuda.synchronize()
    n_pos = sam_pt.positive_points_per_mask
    n_points = n_pos + sam_pt.negative_points_per_mask
    log(f"superglue: built SamPt (SAM {sam_pt.sam_predictor.model.dtype}, "
        f"{type(sam_pt.point_tracker).__name__} float32, live random "
        f"weights) in {time.perf_counter() - t0:.1f} s")
    video = superglue_video(t, m, seed=14)
    fa.reset_launch_counts()
    out, masks = run_video(sam_pt, video, fuse)
    torch.cuda.synchronize()
    found = dict(fa.LAUNCHES)
    expected = launch_schedule(sam_pt, [t], [t * m])
    log(f"superglue: launches {found} expected {expected}")
    if found != expected:
        raise SystemExit("superglue: launch counts differ")
    log(f"superglue: video {t} frames x {m} objects: "
        + check_outputs(out, masks, t, m, n_points))
    images = torch.from_numpy(video["image"]).to(device)
    counts = superglue_matches(sam_pt.point_tracker, images)
    positives = visible_positives(out, n_pos)
    empty = (positives[1:] == 0).mean(0)
    ok = bool((empty <= SUPERGLUE_EMPTY_SHARE).all())
    log(f"superglue: matches a frame (1-{t - 1}) {counts.tolist()}; visible "
        f"positives a frame, per mask: "
        + "; ".join(f"mask {i}: {positives[1:, i].tolist()}"
                    for i in range(m))
        + f"; share of frames without one {np.round(empty, 3).tolist()} "
        f"(<= {SUPERGLUE_EMPTY_SHARE}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("superglue: a mask has no visible positive on most "
                         "frames")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_video(sam_pt, video, fuse)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"superglue: timed pass {wall:.3f} s for {t} frames = "
        f"{t / wall:.3f} frames/s on {card}")
    reference_phase(sam_pt, fa, video, label="superglue reference")
    if profiling:
        stage_split(sam_pt, f"superglue_{t}x{m}", (
            "_encode_all_frames", "extract_query_points",
            "_track_points_device", "_apply_sam_device"),
            lambda: run_video(sam_pt, video, fuse), card)

    # The reinit path on the same model: query masks on frames 0 and 12,
    # so that the flipped pass runs; each window sets its masks.
    settings = {k: getattr(sam_pt, k) for k in REINIT_SETTINGS}
    for k, v in REINIT_SETTINGS.items():
        setattr(sam_pt, k, v)
    tracker = sam_pt.point_tracker
    set_masks = tracker.set_masks
    mask_sets = []
    tracker.set_masks = lambda masks: (mask_sets.append(masks.shape),
                                       set_masks(masks))
    try:
        query_ts = [0, t // 2]
        reinit_video = superglue_video(t, m, seed=15)
        reinit_video["query_point_timestep"] = np.asarray(query_ts,
                                                          np.float32)
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        out, masks = run_video(sam_pt, reinit_video, fuse)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        windows = list(sam_pt.reinit_windows)
        expected = superglue_reinit_schedule(sam_pt, t, windows)
        log(f"superglue reinit: windows {windows}, set_masks of "
            f"{mask_sets}; launches {launches} expected {expected}; "
            f"{wall:.3f} s")
        if launches != expected or len(mask_sets) != 1 + len(windows):
            raise SystemExit("superglue reinit: launches or mask sets "
                             "differ")
        log("superglue reinit: " + check_outputs(out, masks, t, m, n_points,
                                                 query_ts))
    finally:
        del tracker.set_masks
        for k, v in settings.items():
            setattr(sam_pt, k, v)
    del sam_pt, tracker
    torch.cuda.empty_cache()
    superglue_tracker_checks(device, card, profiling=profiling)
    label_propagation_check(device)
    log(f"superglue: the phase took {time.perf_counter() - t_phase:.1f} s")
    return found


def superglue_tracker_checks(device, card: str, frames: int = 24,
                             keypoints: int = 1024,
                             small_keypoints: int = 1024,
                             profiling: bool = False) -> None:
    """SuperGlue alone (live weights, the YAML's settings, `keypoints`
    slots): 17 points of one mask through a `frames` x 480 x 854 textured
    video, timed, with the stages' synchronised wall times (SuperPoint on
    the frames, SuperGlue on the pairs, and the Sinkhorn alone on the
    pairs' score shape); then on an 8-frame 96 x 160 video the card
    against the CPU on the same weights, TF32 off, with `small_keypoints`
    slots: SuperPoint's valid keypoints equal as sets, their scores within
    1e-5 and descriptors within 1e-4; SuperGlue on the card's detections on
    both sides, the log transport plans within SUPERGLUE_PLAN_ATOL +
    SUPERGLUE_PLAN_RTOL |cpu| and the matches equal wherever the mutual-max
    margin exceeds the sides' difference; the trajectories equal with the
    rngs reset. With `profiling`, one pass of the first under
    torch.profiler."""
    from sam_pt_torch.build import TRACKER_SETTINGS
    from sam_pt_torch.models.tracker import TRACKER_REGISTRY
    from sam_pt_torch.models.tracker.superglue.superglue import log_sinkhorn
    from sam_pt_torch.models.tracker.superglue.tracker import match_data
    from sam_pt_torch.ops.color import rgb_to_gray

    def build(dev, slots):
        settings = dict(TRACKER_SETTINGS["superglue"], max_keypoints=slots)
        tracker = TRACKER_REGISTRY["superglue"](
            allow_random_init=True, seed=1, device=dev,
            positive_points_per_mask=16, negative_points_per_mask=1,
            **settings)
        superglue_live_weights(tracker)
        return tracker

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    tracker = build(device, keypoints)
    video = superglue_video(frames, 1, seed=16)
    rgbs = torch.from_numpy(video["image"]).to(device)[None]
    box = np.argwhere(video["query_masks"][0])  # the query points inside
    qp = np.concatenate([np.zeros((17, 1)), np.random.default_rng(17).uniform(
        box.min(0)[::-1], box.max(0)[::-1], (17, 2))], 1)[None].astype(
        np.float32)
    for timed in (False, True):
        tracker.set_masks(video["query_masks"])
        (traj, vis), wall = synced(lambda: tracker.forward_device(rgbs, qp))
    gray = rgb_to_gray(rgbs[0]) / 255.0
    det, detect_s = synced(lambda: tracker.detect(gray))
    first = {k: v[:1] for k, v in det.items()}
    rest = {k: v[1:] for k, v in det.items()}
    _, match_s = synced(lambda: tracker.match(first, rest, (H, W)))
    k = tracker.superpoint.max_keypoints
    scores = torch.randn(frames - 1, k, k, device=device)
    _, sinkhorn_s = synced(lambda: log_sinkhorn(
        scores, tracker.superglue.bin_score,
        tracker.superglue.sinkhorn_iterations))
    ok = (tuple(traj.shape) == (1, frames, 17, 2)
          and bool(torch.isfinite(traj).all()))
    log(f"tracker superglue: {frames} frames {H} x {W}, 17 points: timed "
        f"pass {wall:.3f} s = {frames / wall:.3f} frames/s on {card}; "
        f"SuperPoint {detect_s:.4f} s, SuperGlue {match_s:.4f} s over "
        f"{frames - 1} pairs, of which the Sinkhorn "
        f"({tracker.superglue.sinkhorn_iterations} iterations) "
        f"{sinkhorn_s:.4f} s = {sinkhorn_s / (detect_s + match_s):.3f} of "
        f"the two; visible {float(vis[0, 1:].mean()):.3f} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("tracker superglue: bad trajectories")
    if profiling:
        def forward():
            tracker.set_masks(video["query_masks"])
            tracker.forward_device(rgbs, qp)
        device_profile(f"superglue_tracker_{frames}", forward, card)
    del tracker, rgbs
    torch.cuda.empty_cache()

    rng = np.random.default_rng(18)
    small = textured_frames(8, 18, 96, 160)
    masks = np.zeros((1, 96, 160), np.float32)
    masks[0, 20:70, 30:110] = 1
    qp = np.concatenate([np.zeros((17, 1)), rng.uniform(
        [30, 20], [110, 70], (17, 2))], 1)[None].astype(np.float32)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for dev in (device, torch.device("cpu")):
            tracker = build(dev, small_keypoints)
            if runs:  # the card's weights, on the CPU
                tracker.superpoint.load_state_dict(weights[0])
                tracker.superglue.load_state_dict(weights[1])
            else:
                weights = [{k: v.cpu() for k, v in mod.state_dict().items()}
                           for mod in (tracker.superpoint,
                                       tracker.superglue)]
            images = torch.from_numpy(small).to(dev)
            det = tracker.detect(rgb_to_gray(images) / 255.0)
            # The matcher on the card's detections on both sides.
            on = {k: v.to(dev) for k, v in (runs[0]["det"] if runs
                                            else det).items()}
            with torch.no_grad():
                pred = tracker.superglue(match_data(
                    {k: v[:1].expand(7, *v.shape[1:]) for k, v in
                     on.items()}, {k: v[1:] for k, v in on.items()},
                    (96, 160)))
            tracker.set_masks(masks)
            traj, vis = tracker.forward_device(images[None], qp)
            runs.append({"det": {k: v.cpu() for k, v in det.items()},
                         "plan": pred["log_transport"].cpu(),
                         "matches": pred["matches0"].cpu(),
                         "traj": traj.cpu(), "vis": vis.cpu()})
        card_run, cpu_run = runs
        kp = keypoint_agreement(card_run["det"], cpu_run["det"])
        plan_err, margin_ok, n_matches = 0.0, True, 0
        for i in range(7):
            v0 = card_run["det"]["valid"][0]
            v1 = card_run["det"]["valid"][i + 1]
            rows = torch.cat([v0, torch.tensor([True])])
            cols = torch.cat([v1, torch.tensor([True])])
            a = card_run["plan"][i][rows][:, cols]
            b = cpu_run["plan"][i][rows][:, cols]
            excess = ((a - b).abs() - SUPERGLUE_PLAN_RTOL * b.abs()).max()
            plan_err = max(plan_err, float((a - b).abs().max()))
            if excess > SUPERGLUE_PLAN_ATOL:
                margin_ok = False
            inner = b[:-1, :-1]
            diff = float((a - b)[:-1, :-1].abs().max())
            gaps = [(top[..., 1] - top[..., 0]).min() for top in (
                inner.topk(2, dim=1).values.flip(-1),
                inner.topk(2, dim=0).values.T.flip(-1))]
            if min(float(g) for g in gaps) > 2 * diff and not torch.equal(
                    card_run["matches"][i], cpu_run["matches"][i]):
                margin_ok = False
            n_matches += int((cpu_run["matches"][i] > -1).sum())
        same_traj = (torch.equal(card_run["traj"], cpu_run["traj"])
                     and torch.equal(card_run["vis"], cpu_run["vis"]))
        ok = (kp["differ"] == 0 and kp["score"] <= 1e-5
              and kp["descriptor"] <= 1e-4 and margin_ok and same_traj
              and n_matches > 0)
        log(f"tracker superglue card vs CPU (8 x 96 x 160, {small_keypoints} "
            f"slots, f32, TF32 off): SuperPoint {kp['differ']} of "
            f"{kp['total']} valid keypoints differ (0), scores max |diff| "
            f"{kp['score']:.3e} (<= 1e-5), descriptors {kp['descriptor']:.3e} "
            f"(<= 1e-4); SuperGlue on the card's detections: log plan max "
            f"|diff| {plan_err:.3e} (<= {SUPERGLUE_PLAN_ATOL:g} + "
            f"{SUPERGLUE_PLAN_RTOL:g} |cpu|), matches equal where the "
            f"margins allow {margin_ok} ({n_matches} matches over 7 pairs); "
            f"trajectories equal with the rngs reset {same_traj} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("tracker superglue: the card disagrees with the "
                             "CPU")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def keypoint_agreement(det_a, det_b) -> dict:
    """Two SuperPoint outputs of the same frames: how many valid keypoints
    one has and the other lacks (`differ`, of `total`), and at the common
    ones the largest score and descriptor differences."""
    differ = total = 0
    score = descriptor = 0.0
    for f in range(det_a["keypoints"].shape[0]):
        found = []
        for det in (det_a, det_b):
            valid = det["valid"][f]
            keys = [tuple(p) for p in det["keypoints"][f][valid].int().tolist()]
            found.append(dict(zip(keys, torch.nonzero(valid)[:, 0].tolist())))
        common = found[0].keys() & found[1].keys()
        differ += len(found[0].keys() ^ found[1].keys())
        total += len(found[0])
        ia = [found[0][k] for k in common]
        ib = [found[1][k] for k in common]
        if common:
            score = max(score, float((det_a["scores"][f][ia]
                                      - det_b["scores"][f][ib]).abs().max()))
            descriptor = max(descriptor, float(
                (det_a["descriptors"][f][ia]
                 - det_b["descriptors"][f][ib]).abs().max()))
    return {"differ": differ, "total": total, "score": score,
            "descriptor": descriptor}


def label_propagation_check(device) -> None:
    """Label propagation on the card against the CPU: 24 x 24 feature
    nodes of 64 dims, 3 context frames of 4 labels, a 12-node window,
    within 1e-4 + 1e-4 |cpu|."""
    from sam_pt_torch.ops.label_propagation import label_propagation

    rng = np.random.default_rng(19)
    h = w = 24
    tar = rng.standard_normal((h * w, 64)).astype(np.float32)
    feats = [rng.standard_normal((64, h * w)).astype(np.float32)
             for _ in range(3)]
    segs = [rng.uniform(size=(1, 4, h, w)).astype(np.float32)
            for _ in range(3)]
    outs = []
    for dev in (device, torch.device("cpu")):
        out, _ = label_propagation(
            h, w, torch.from_numpy(tar).to(dev),
            [torch.from_numpy(f).to(dev) for f in feats],
            [torch.from_numpy(s).to(dev) for s in segs])
        outs.append(out.cpu())
    err = float(((outs[0] - outs[1]).abs() - 1e-4 * outs[1].abs()).max())
    ok = bool(torch.isfinite(outs[0]).all()) and err <= 1e-4
    log(f"label propagation card vs CPU (24 x 24 nodes, 64 dims, 3 context "
        f"frames): max |diff| - 1e-4 |cpu| {err:.3e} (<= 1e-4) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("label propagation: the card disagrees with the CPU")


def match_pairs_phase(card: str, args=("--device", "cuda")) -> None:
    """`python -m sam_pt_torch.models.tracker.superglue.match_pairs` as a
    subprocess on two of the demo phase's PNG frames (random weights,
    without --eval or --viz): exit 0 and the matches file's keys."""
    import shutil
    import tempfile

    here = os.path.dirname(os.path.realpath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="match_pairs_",
                            dir=os.path.join(here, "build"))
    try:
        folder, _ = write_demo_inputs(root, frames=2)
        pairs = os.path.join(root, "pairs.txt")
        with open(pairs, "w") as f:
            f.write("00000.png 00001.png\n")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "sam_pt_torch.models.tracker.superglue.match_pairs",
             "--input_pairs", pairs, "--input_dir", folder, "--output_dir",
             os.path.join(root, "out"), "--allow_random_init", *args],
            cwd=here, capture_output=True, text=True, timeout=600)
        path = os.path.join(root, "out", "00000_00001_matches.npz")
        keys = set(np.load(path)) if os.path.exists(path) else set()
        ok = proc.returncode == 0 and keys == {
            "keypoints0", "keypoints1", "matches", "match_confidence"}
        log(f"match_pairs: python -m ...superglue.match_pairs exit "
            f"{proc.returncode} in {time.perf_counter() - t0:.1f} s: "
            f"{proc.stdout.strip().splitlines()[-1:]}, keys {sorted(keys)} "
            f"on {card} {'OK' if ok else 'FAIL'}")
        if not ok:
            log(proc.stdout[-4000:])
            log(proc.stderr[-4000:])
            raise SystemExit("match_pairs: the entry point failed")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# JSON row -> (source, the TPU function it replaces)
# ---------------------------------------------------------------------------
# Phase 21: the parallel layer (`sam_pt_torch/parallel/`), each world
# spawned from the script (`parallel.launch.run_world`). Several ranks
# share the one card over gloo; times taken so are bring-up numbers of a
# shared card, not a multi-GPU speed.
# ---------------------------------------------------------------------------
TP_FRAMES = 4  # ViT-H frames the tensor-parallel encode takes, one chunk
TIME_FRAMES = 23  # time-sharded TapNet/TAPIR frames: no multiple of 2 or 3
TIME_QUERIES = 17
TIME_HW = 256  # TapNet's and TAPIR's input size
DP_AGREEMENT = 0.999  # fused-mask pixels equal to the unsharded run's
DP_SCORE_ATOL = 1e-3
TP_REL_L2 = 1e-2
TIME_TRACK_ATOL = 1e-3  # raster px, TF32 off
TIME_LOGIT_ATOL = 1e-4  # occlusion (and TAPIR's expected-distance) logits
WORLD_TIMEOUT = 600.0


def digest(*arrays) -> str:
    """One hash of the bytes of `arrays` (tensors or numpy arrays)."""
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().contiguous().view(torch.uint8).numpy()
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def build_main_dp(device):
    """The main path (ViT-H + CoTracker, random bf16 weights from seed 0,
    the live biases) with `data_parallel=True`: phase 4's model on a
    mesh of every rank."""
    from sam_pt_torch.build import build_sam_pt

    sam_pt = build_sam_pt(device, dtype=torch.bfloat16, seed=0,
                          data_parallel=True)
    bias_for_a_live_run(sam_pt)
    return sam_pt


def build_vit_h_sam(device):
    """SAM ViT-H with the main path's weights (`build_sam_pt`'s SAM: the
    first draws of a generator on the device seeded 0), bf16."""
    from sam_pt_torch.models.batch_norm import reset_batch_norm_stats_
    from sam_pt_torch.models.sam.sam_model import Sam
    from sam_pt_torch.utils.checkpoint import randomize_

    generator = torch.Generator(device=device).manual_seed(0)
    sam = reset_batch_norm_stats_(randomize_(Sam("vit_h").to(device),
                                             generator))
    return sam.to(torch.bfloat16).eval().requires_grad_(False)


def build_haiku_models(device):
    """TapNet's and TAPIR's models at their YAML widths, float32, the
    random weights their trackers draw from seed 1."""
    from sam_pt_torch.build import TRACKER_SETTINGS
    from sam_pt_torch.models.tracker import TRACKER_REGISTRY

    return {name: TRACKER_REGISTRY[name](
        allow_random_init=True, seed=1, device=device,
        **TRACKER_SETTINGS[name]).model for name in ("tapnet", "tapir")}


def tp_schedule(encoder, chunks: int = 1) -> dict:
    """K1 and K2 launches of `chunks` encode calls of a (sharded) ViT."""
    n_global = len(encoder.global_attn_indexes)
    return {"window": (len(encoder.blocks) - n_global) * chunks,
            "global": n_global * chunks}


def dp_job(device, build, schedule, videos):
    """A data-parallel SamPt (`build(device)`) over `videos` on this rank:
    launches (reset just before, read just after) against `schedule`,
    the fused masks, scores, a digest of every output, the wall time of
    that first pass and of a second, timed one."""
    from sam_pt_torch.ops import flash_attention as fa
    from sam_pt_torch.parallel.comm import group_size
    from sam_pt_torch.vos_eval.eval import device_fuse_index_masks

    sam_pt = build(device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [run_video(sam_pt, v, device_fuse_index_masks) for v in videos]
    sync()
    first = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    t0 = time.perf_counter()
    for v in videos:
        run_video(sam_pt, v, device_fuse_index_masks)
    sync()
    wall = time.perf_counter() - t0
    keys = ("logits", "scores", "scores_per_frame", "trajectories",
            "visibilities")
    return {"launches": launches,
            "expected": schedule(sam_pt, [v["image"].shape[0]
                                          for v in videos],
                                 [v["image"].shape[0] * len(v["query_masks"])
                                  for v in videos]),
            "masks": [m for _, m in outs],
            "scores": [o["scores"].float().cpu().numpy() for o, _ in outs],
            "digest": digest(*[o[k] for o, m in outs for k in keys],
                             *[m for _, m in outs]),
            "chunks": (sam_pt.sam_encode_chunk, sam_pt.sam_decode_chunk),
            "world": group_size(), "first": first, "wall": wall}


def tp_job(device, build, schedule, frames, n_model, n_data):
    """ViT SAM (`build(device)`) sharded over a (n_data x n_model) mesh
    encoding `frames` [B, H, W, 3] uint8 in one chunk: launches against
    `schedule(encoder)`, the local heads, rank 0's embeddings, a
    digest."""
    from sam_pt_torch.models.sam.predictor import SamPredictor
    from sam_pt_torch.ops import flash_attention as fa
    from sam_pt_torch.parallel.comm import group_rank
    from sam_pt_torch.parallel.tensor_parallel import create_tp_mesh

    sam = build(device)
    sam.tp_axis, sam.dp_axis = "model", ("data" if n_data > 1 else None)
    pred = SamPredictor(sam, mesh=create_tp_mesh(n_model, n_data))
    images = torch.from_numpy(frames).to(device)
    hw = tuple(frames.shape[1:3])
    with recorded_psums() as psums:
        pred.encode_frames(images, hw)  # warm-up
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    emb = pred.encode_frames(images, hw)
    sync()
    wall = time.perf_counter() - t0
    encoder = sam.image_encoder
    return {"launches": dict(fa.LAUNCHES), "expected": schedule(encoder),
            "psums": psums, "dtype": str(sam.dtype),
            "local_heads": encoder.blocks[0].attn.num_heads,
            "emb": emb.float().cpu().numpy() if group_rank() == 0 else None,
            "digest": digest(emb), "wall": wall}


@contextlib.contextmanager
def recorded_psums():
    """Within the block, every `psum` of `parallel/tensor_parallel.py`
    is recorded under the TP sublayer it runs in, `tp_mlp` or
    `tp_shardmap_attention` (each wrapped for the block; "outside" for a
    `psum` in neither): {sublayer: {"dtype", "calls", "bytes"}}."""
    from sam_pt_torch.parallel import tensor_parallel

    found, within = {}, ["outside"]
    saved = {name: getattr(tensor_parallel, name)
             for name in ("psum", "tp_mlp", "tp_shardmap_attention")}

    def recording(x, group=None):
        entry = found.setdefault(within[-1], {"dtype": str(x.dtype),
                                              "calls": 0, "bytes": 0})
        entry["calls"] += 1
        entry["bytes"] += x.numel() * x.element_size()
        return saved["psum"](x, group)

    def labelled(name):
        def sublayer(*args, **kwargs):
            within.append(name)
            try:
                return saved[name](*args, **kwargs)
            finally:
                within.pop()
        return sublayer

    tensor_parallel.psum = recording
    for name in ("tp_mlp", "tp_shardmap_attention"):
        setattr(tensor_parallel, name, labelled(name))
    try:
        yield found
    finally:
        for name, fn in saved.items():
            setattr(tensor_parallel, name, fn)


def time_job(device, build, video, query_points):
    """TapNet and TAPIR (`build(device)`) time-sharded over every rank,
    float32 with TF32 off: their outputs, a digest, the wall time."""
    from sam_pt_torch.parallel.mesh import create_mesh
    from sam_pt_torch.parallel.temporal import (
        tapir_forward_time_sharded,
        tapnet_forward_time_sharded,
    )

    forward = {"tapnet": tapnet_forward_time_sharded,
               "tapir": tapir_forward_time_sharded}
    models = build(device)
    mesh = create_mesh()
    found = {}
    with no_tf32(), torch.no_grad():
        for name, model in models.items():
            t0 = time.perf_counter()
            out = forward[name](model, torch.from_numpy(video).to(device),
                                torch.from_numpy(query_points).to(device),
                                mesh)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            found[name] = {"out": out, "digest": digest(*out.values()),
                           "wall": time.perf_counter() - t0}
    return found


@contextlib.contextmanager
def no_tf32():
    """Matrix products and convolutions in full float32 until the block
    ends."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def world_jobs(device, jobs):
    """Each (function, args) of `jobs` on this rank, in order:
    `function(device, *args)`; their results."""
    return [fn(device, *args) for fn, args in jobs]


def time_inputs(seed: int = 21):
    """TIME_FRAMES random frames of TIME_HW^2 in [-1, 1] and TIME_QUERIES
    (t, y, x) queries in the 256 raster, spread over the frames."""
    rng = np.random.default_rng(seed)
    video = rng.uniform(-1, 1, (TIME_FRAMES, TIME_HW, TIME_HW, 3)).astype(
        np.float32)
    qp = np.stack([np.linspace(0, TIME_FRAMES - 1, TIME_QUERIES).round(),
                   rng.uniform(8, 248, TIME_QUERIES),
                   rng.uniform(8, 248, TIME_QUERIES)], -1).astype(np.float32)
    return video, qp


def check_dp(label: str, ranks, reference, where: str) -> None:
    """Phase 21's data-parallel checks of one world's ranks against the
    unsharded run (`reference`: per video, fused masks and scores);
    `where` says where the ranks ran, for the times."""
    first = ranks[0]
    for r, res in enumerate(ranks):
        if res["launches"] != res["expected"]:
            raise SystemExit(f"{label}: rank {r} launches {res['launches']} "
                             f"differ from its schedule {res['expected']}")
        if res["digest"] != first["digest"]:
            raise SystemExit(f"{label}: rank {r}'s outputs differ from rank "
                             f"0's")
    for v, (masks, scores) in enumerate(reference):
        agree = float((first["masks"][v] == masks).mean())
        score_err = float(np.abs(first["scores"][v] - scores).max())
        log(f"{label}: video {v} fused masks agree on {agree:.6f} of pixels "
            f"(> {DP_AGREEMENT}), scores within {score_err:.2e} "
            f"(<= {DP_SCORE_ATOL:g})")
        if agree <= DP_AGREEMENT or not score_err <= DP_SCORE_ATOL:
            raise SystemExit(f"{label}: video {v} differs from the "
                             f"unsharded run")
    log(f"{label}: {len(ranks)} rank(s), chunks (encode, decode) "
        f"{first['chunks']}, launches a rank {first['launches']} as "
        f"scheduled, outputs bit-equal across ranks; both videos in "
        f"{max(r['first'] for r in ranks):.3f} s (first pass) and "
        f"{max(r['wall'] for r in ranks):.3f} s (second pass; {where})")


def check_tp(label: str, ranks, reference: np.ndarray, heads: int) -> dict:
    first = ranks[0]
    for r, res in enumerate(ranks):
        if res["launches"]["window"] != res["expected"]["window"] or res[
                "launches"]["global"] != res["expected"]["global"]:
            raise SystemExit(f"{label}: rank {r} launches {res['launches']} "
                             f"differ from {res['expected']}")
        if res["local_heads"] != heads or res["digest"] != first["digest"]:
            raise SystemExit(f"{label}: rank {r} has {res['local_heads']} "
                             f"heads or outputs unlike rank 0's")
    mlp, attn = (first["psums"].get(k, {}) for k in (
        "tp_mlp", "tp_shardmap_attention"))
    log(f"{label}: the MLP's psum {mlp.get('dtype')}, {mlp.get('calls')} "
        f"calls, {mlp.get('bytes', 0) / 1e6:.1f} MB a rank per encode; the "
        f"attention's {attn.get('dtype')}, {attn.get('calls')} calls, "
        f"{attn.get('bytes', 0) / 1e6:.1f} MB (working dtype "
        f"{first['dtype']})")
    if not mlp or not attn:
        raise SystemExit(f"{label}: no psum recorded in the MLP or in the "
                         f"attention sublayer: {first['psums']}")
    if (mlp["dtype"], attn["dtype"]) != (first["dtype"], "torch.float32"):
        raise SystemExit(f"{label}: the MLP's psum is not in the working "
                         f"dtype or the attention's not in float32")
    err = rel_l2(torch.from_numpy(first["emb"]), torch.from_numpy(reference))
    log(f"{label}: embeddings rel. L2 {err:.3e} from the unsharded encode "
        f"(< {TP_REL_L2:g}), {heads} local heads, K1 "
        f"{first['launches']['window']} and K2 "
        f"{first['launches']['global']} launches a rank, encode "
        f"{max(r['wall'] for r in ranks) * 1e3:.1f} ms")
    if not err < TP_REL_L2:
        raise SystemExit(f"{label}: TP embeddings differ from unsharded")
    return first["launches"]


def check_time(label: str, ranks, reference) -> None:
    for name, ref in reference.items():
        got = ranks[0][name]
        if any(r[name]["digest"] != got["digest"] for r in ranks):
            raise SystemExit(f"{label} {name}: ranks differ")
        errs = {k: float(np.abs(got["out"][k] - ref[k]).max()) for k in ref}
        limits = {k: TIME_TRACK_ATOL if k == "tracks" else TIME_LOGIT_ATOL
                  for k in ref}
        log(f"{label} {name}: {TIME_FRAMES} frames over {len(ranks)} ranks: "
            + ", ".join(f"{k} within {errs[k]:.2e} (<= {limits[k]:g})"
                        for k in ref)
            + f" of the unsharded run; "
              f"{max(r[name]['wall'] for r in ranks):.3f} s")
        if not all(errs[k] <= limits[k] for k in ref):
            raise SystemExit(f"{label} {name}: differs from unsharded")


def parallel_phase(device, card: str, dp_reference, videos=None,
                   shared_card: bool = True) -> dict:
    """Phase 21 (see the module docstring). `dp_reference`: per video of
    `videos` (VIDEOS by default), the unsharded main path's fused masks
    and scores. With more than one card, a world of one rank a card
    over NCCL (DP, time-sharded, and TP on data x model 2); without
    `shared_card`, only that world. Returns the TP world of 2's K1/K2
    launches a rank (None without `shared_card`)."""
    from sam_pt_torch.parallel.launch import run_world

    t_phase = time.perf_counter()
    if videos is None:
        videos = [make_video(t, m, seed=i) for i, (t, m) in enumerate(VIDEOS)]
    frames = videos[0]["image"][:TP_FRAMES]
    time_video, qp = time_inputs()
    builders = PARALLEL_BUILDERS
    # Unsharded references on this device.
    sam = builders["sam"](device)
    from sam_pt_torch.models.sam.predictor import SamPredictor
    tp_ref = SamPredictor(sam).encode_frames(
        torch.from_numpy(frames).to(device), tuple(frames.shape[1:3]))
    tp_ref = tp_ref.float().cpu().numpy()
    heads = sam.image_encoder.blocks[0].attn.num_heads
    del sam
    with no_tf32(), torch.no_grad():
        time_ref = {}
        for name, model in builders["haiku"](device).items():
            out = model(torch.from_numpy(time_video).to(device),
                        torch.from_numpy(qp).to(device))
            time_ref[name] = {k: v.cpu().numpy() for k, v in out.items()}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    on = "cpu" if device.type == "cpu" else f"cuda:{device.index or 0}"
    run = {"timeout": WORLD_TIMEOUT}

    dp = (dp_job, (builders["dp"], builders["schedule"], videos))
    tp2, tp4 = ((tp_job, (builders["sam"], builders["tp_schedule"], frames,
                          2, n_data)) for n_data in (1, 2))
    tm = (time_job, (builders["haiku"], time_video, qp))
    tp_launches = None
    if shared_card:
        tp_launches = shared_card_worlds(card, on, run, dp, tp2, tp4, tm,
                                         dp_reference, tp_ref, heads,
                                         time_ref)
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if cards > 1:  # one rank a card over NCCL, every card of the host
        t0 = time.perf_counter()
        tpn = (tp_job, (builders["sam"], builders["tp_schedule"], frames, 2,
                        cards // 2))
        jobs = [dp, tm] + ([tpn] if cards % 2 == 0 else [])
        ranks = run_world(world_jobs, cards, backend="nccl", args=(jobs,),
                          **run)
        log(f"parallel: world of {cards} (nccl, one rank a card) took "
            f"{time.perf_counter() - t0:.1f} s")
        check_dp(f"parallel dp nccl x{cards}", [r[0] for r in ranks],
                 dp_reference, f"one rank a card, {card}")
        check_time(f"parallel time nccl x{cards}", [r[1] for r in ranks],
                   time_ref)
        if cards % 2 == 0:
            check_tp(f"parallel tp nccl x{cards} (data {cards // 2} x "
                     f"model 2)", [r[2] for r in ranks], tp_ref, heads // 2)
    log(f"parallel: the phase took {time.perf_counter() - t_phase:.1f} s")
    return tp_launches


def shared_card_worlds(card, on, run, dp, tp2, tp4, tm, dp_reference,
                       tp_ref, heads, time_ref) -> dict:
    """Phase 21's worlds of ranks that share the card `on`: 2, 4 and 3
    over gloo, then 1 over NCCL on a card. Returns the TP world of 2's
    K1/K2 launches a rank."""
    from sam_pt_torch.parallel.launch import run_world

    t0 = time.perf_counter()
    two = run_world(world_jobs, 2, backend="gloo", device=on,
                    args=([dp, tp2, tm],), **run)
    log(f"parallel: world of 2 (gloo, both ranks on {on}) took "
        f"{time.perf_counter() - t0:.1f} s")
    check_dp("parallel dp gloo x2", [r[0] for r in two], dp_reference,
             f"both ranks on {on}, {card}")
    tp_launches = check_tp("parallel tp gloo x2 (model 2)",
                           [r[1] for r in two], tp_ref, heads // 2)
    check_time("parallel time gloo x2", [r[2] for r in two], time_ref)

    t0 = time.perf_counter()
    four = run_world(world_jobs, 4, backend="gloo", device=on,
                     args=([tp4],), **run)
    log(f"parallel: world of 4 (gloo, all ranks on {on}) took "
        f"{time.perf_counter() - t0:.1f} s")
    check_tp("parallel tp gloo x4 (data 2 x model 2)", [r[0] for r in four],
             tp_ref, heads // 2)

    t0 = time.perf_counter()
    three = run_world(world_jobs, 3, backend="gloo", device=on,
                      args=([tm],), **run)
    log(f"parallel: world of 3 (gloo, all ranks on {on}) took "
        f"{time.perf_counter() - t0:.1f} s")
    check_time("parallel time gloo x3", [r[0] for r in three], time_ref)

    if on != "cpu":
        t0 = time.perf_counter()
        one = run_world(world_jobs, 1, backend="nccl", args=([dp],), **run)
        log(f"parallel: world of 1 (nccl) took "
            f"{time.perf_counter() - t0:.1f} s")
        check_dp("parallel dp nccl x1", [r[0] for r in one], dp_reference,
                 f"{on}, {card}")
    return tp_launches


def probe_rank(device) -> dict:
    """This backend's `all_reduce` of CUDA tensors: each dtype the
    parallel layer reduces (every rank adds rank + 1), then the time of
    one 256 MB int32 reduction after a warm one."""
    import torch.distributed as dist

    from sam_pt_torch.parallel.comm import group_rank, group_size

    found = {}
    for dtype in (torch.int32, torch.float32, torch.uint8, torch.bfloat16):
        x = torch.full((1 << 20,), group_rank() + 1, dtype=dtype,
                       device=device)
        dist.all_reduce(x)
        want = group_size() * (group_size() + 1) // 2
        found[str(dtype)] = bool((x.float() == want).all())
    x = torch.ones(64 << 20, dtype=torch.int32, device=device)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(x)
    torch.cuda.synchronize()
    found["ms_256mb"] = (time.perf_counter() - t0) * 1e3
    return found


def nccl_rank(rank: int, init_method: str, results) -> None:
    """Rank `rank` of 2 joining NCCL on cuda:0 as a raw
    `init_process_group` would, with no check of ours: what NCCL says."""
    import datetime

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=init_method, rank=rank,
                                world_size=2,
                                timeout=datetime.timedelta(seconds=60))
        dist.all_reduce(torch.ones(1, device="cuda:0"))
        torch.cuda.synchronize()
        results.put((rank, "no error"))
    except Exception as exc:  # reported, not raised: the refusal is the point
        results.put((rank, str(exc).strip().splitlines()[-1]))


def probe_phase(card: str) -> None:
    """Why phase 21 shares the card over gloo: gloo's `all_reduce` of
    CUDA tensors for 2 ranks on cuda:0 (each dtype, and 256 MB of int32)
    and what NCCL says to 2 ranks on one card."""
    import multiprocessing
    import tempfile

    from sam_pt_torch.parallel.launch import run_world

    for r, found in enumerate(run_world(probe_rank, 2, backend="gloo",
                                        device="cuda:0", timeout=300)):
        log(f"probe gloo x2 on cuda:0, rank {r}: all_reduce correct for "
            f"{[k for k, v in found.items() if v is True]}, 256 MB of int32 "
            f"in {found['ms_256mb']:.1f} ms on {card}")
        if not all(v for k, v in found.items() if k != "ms_256mb"):
            raise SystemExit("gloo reduced a CUDA tensor wrong")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=nccl_rank, daemon=True, args=(
            r, f"file://{tmp}/rendezvous", results)) for r in range(2)]
        for p in procs:
            p.start()
        said = [results.get(timeout=120) for _ in procs]
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    for r, message in sorted(said):
        log(f"probe nccl x2 on cuda:0, rank {r}: {message}")


def parallel_only(card: str, cards_only: bool = False) -> None:
    """`--parallel`: the build, the two `_tp2` kernel cases, the main
    path unsharded (phase 4's first run, the reference phase 21 holds its
    data-parallel runs to), the probe and phase 21; with `cards_only`
    (`--cards`, a host of several cards), phase 21's world of one rank a
    card alone."""
    from sam_pt_torch.build import build_sam_pt
    from sam_pt_torch.ops import flash_attention as fa
    from sam_pt_torch.vos_eval.eval import device_fuse_index_masks

    build_phase()
    device = torch.device("cuda")
    cases = kernel_cases(fa, device)
    measure_cases({k: cases[k] for k in ("window_tp2", "global_tp2")})
    sam_pt = build_sam_pt(device, dtype=torch.bfloat16, seed=0)
    bias_for_a_live_run(sam_pt)
    videos = [make_video(t, m, seed=i) for i, (t, m) in enumerate(VIDEOS)]
    t0 = time.perf_counter()
    outs = [run_video(sam_pt, v, device_fuse_index_masks) for v in videos]
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for v in videos:
        run_video(sam_pt, v, device_fuse_index_masks)
    torch.cuda.synchronize()
    log(f"parallel: the main path unsharded, both videos in {first:.3f} s "
        f"(first pass) and {time.perf_counter() - t0:.3f} s (second pass) "
        f"on {card}")
    reference = [(m, o["scores"].float().cpu().numpy()) for o, m in outs]
    del sam_pt, outs
    torch.cuda.empty_cache()
    if not cards_only:
        probe_phase(card)
    parallel_phase(device, card, reference, videos,
                   shared_card=not cards_only)


# Phase 21's builders, by reference: each world's ranks call them, and a
# rehearsal puts small ones in their place.
PARALLEL_BUILDERS = {"dp": build_main_dp, "sam": build_vit_h_sam,
                     "haiku": build_haiku_models,
                     "schedule": launch_schedule, "tp_schedule": tp_schedule}


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


LN_SOURCE = ("sam_pt_torch/csrc/layer_norm.cu",
             "none (sam_pt_tpu/ops/fast_ln.py is a matrix-unit trick of the "
             "TPU's)")


# Rows of K1 and K2 at ViT-B's shapes, launched by the default model.
VIT_B_ROWS = ("window", "global")


def kernel_json(report: dict, launches: dict, route_launches: dict,
                default_launches: dict, crop_launches: dict,
                interactive_launches: dict, *, hq_launches: dict,
                vis_launches: dict, haiku_launches: dict,
                tp_launches: dict = None, ln_launches: int = None) -> list:
    """The kernel line's rows: per kernel its launches on the main path
    (K4: in the route phase), the worst error of its cases and each
    case's `TIMES`, the second case's with a suffix; then K1 and K2 at
    ViT-B's shapes (`_vit_b`) with the default model's launches (and, as
    `launches_tapir` and `launches_tapnet`, phase 19's, and as
    `launches_superglue` phase 20's); then K2
    on the cropped grid with the crop phase's launches and K3
    image->token at the interactive capacity with the interactive run's
    image->token launches (2 of the 5 K3 calls of a decoder pass); then
    K3 with the HQ token at the HQ phase's pairs and tokens
    (`cross_attention_hq`, token->image and, suffixed, image->token) with
    the HQ phase's K3 launches, one count for both directions (the
    wrapper counts K3 launches, not which kernel each took), as the row's
    `launches_of` says; then K3 of the VIS phase's generator at its batch
    of one-point prompts (`cross_attention_amg`, both directions as for
    HQ) with the K3 launches of the generator's decodes in that phase;
    then K3 at the VIS evaluate run's tracked prompts
    (`cross_attention_vis`, both directions) with SamPt's K3 launches in
    that run; then K3 at head dim 32 (`cross_attention_self`) with every
    K3 launch of the VIS capacity run, which takes it; then, with
    `tp_launches`, K1 and K2 at ViT-H's heads split over a model axis of
    2 (`_tp2`: 8 heads x 80) with a rank's launches in phase 21's TP
    encode over a world of 2; then, with `ln_launches`, K5 (`layer_norm`)
    at HQ-SAM's `embedding_maskfeature` and, suffixed, the upscaling's and
    `norm4`'s shapes, with the slice's K5 launches."""
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
            entry["max_abs_err"] = max(
                entry["max_abs_err"], report["cross_unmasked"]["max_abs_err"])
        if key == "relpos":
            entry["launches"] = route_launches["relpos"]
        kernels.append(entry)
    for key in VIT_B_ROWS:
        source, replaces = KERNEL_SOURCES[key]
        r = report[f"{key}_vit_b"]
        kernels.append({"name": f"{key}_attention_vit_b", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": default_launches[key],
                        **{f"launches_{name}": counts[key]
                           for name, counts in haiku_launches.items()},
                        "max_abs_err": r["max_abs_err"],
                        **{f: r[f] for f in TIMES}})
    for name, case, key, count in (
            ("global_attention_crop", "global_crop", "global",
             crop_launches["global"]),
            ("image_to_token_interactive", "cross_interactive", "cross",
             interactive_launches["cross"] * 2 // 5)):
        source, replaces = KERNEL_SOURCES[key]
        r = report[case]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": count,
                        "max_abs_err": r["max_abs_err"],
                        **{f: r[f] for f in TIMES}})
    source, replaces = KERNEL_SOURCES["cross"]
    both = "token_to_image + image_to_token"
    for name, cases, count, of in (
            ("cross_attention_hq", ("cross_hq", "cross_hq_masked"),
             hq_launches["cross"], both),
            ("cross_attention_amg", ("cross_amg", "cross_amg_masked"),
             vis_launches["amg"], both),
            ("cross_attention_vis", ("cross_vis", "cross_vis_masked"),
             vis_launches["sam_pt"], both),
            ("cross_attention_self", ("cross_self",),
             vis_launches["capacity"]["cross"],
             "every K3 launch of the VIS capacity run: token_to_image + "
             "image_to_token + the head-dim-32 self-attention")):
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": count, "launches_of": of,
               "max_abs_err": max(report[c]["max_abs_err"] for c in cases),
               **{f: report[cases[0]][f] for f in TIMES}}
        for c in cases[1:]:
            row.update({f + "_image_to_token": report[c][f] for f in TIMES})
        kernels.append(row)
    for key in ("window", "global") if tp_launches is not None else ():
        source, replaces = KERNEL_SOURCES[key]
        r = report[f"{key}_tp2"]
        kernels.append({"name": f"{key}_attention_tp2", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": tp_launches[key],
                        "launches_of": "one rank of phase 21's TP encode "
                                       "(world of 2, model axis 2)",
                        "max_abs_err": r["max_abs_err"],
                        **{f: r[f] for f in TIMES}})
    if ln_launches is not None:
        cases = list(LN_CASES)
        row = {"name": "layer_norm", "route": "cuda",
               "source": LN_SOURCE[0], "replaces": LN_SOURCE[1],
               "launches": ln_launches,
               "launches_of": "the slice: the neck's 2 an encode chunk, "
                              "10-12 a decoder pass",
               "max_abs_err": max(report[c]["max_abs_err"] for c in cases),
               **{f: report[cases[0]][f] for f in TIMES}}
        for c in cases[1:]:
            row.update({f + c[len("layer_norm"):]: report[c][f]
                        for f in TIMES})
        kernels.append(row)
    return kernels


GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
            "aten::matmul", "aten::linear", "aten::einsum")


def gemm_profile(card: str, tag: str, device: str = "cuda") -> dict:
    """The device time of the main path over the 35 x 3 video, of a
    24-frame encode (the crop phase's video) and of a RAFT pass over the
    same frames, each after a warm run, one run under torch.profiler with
    shapes recorded: the kernels with the most device time, and the
    matrix-product operators grouped by their input shapes (which call
    launched which product), beside the run's wall time with and without
    the profiler. Tables go to chiprun_out/gemm_<label>_<tag>.txt.
    Returns {label: device ms, label_wall_ms: wall ms without it}."""
    from torch.profiler import ProfilerActivity, profile

    from sam_pt_torch.build import build_sam_pt
    from sam_pt_torch.vos_eval.eval import device_fuse_index_masks

    sam_pt = build_sam_pt(device, dtype=torch.bfloat16, seed=0)
    bias_for_a_live_run(sam_pt)
    video = make_video(*VIDEOS[-1], seed=len(VIDEOS) - 1)
    images = torch.from_numpy(make_video(24, 1, seed=0)["image"]).to(
        sam_pt.device)
    # RAFT (the tracker phase's settings, 17 points) samples its
    # correlation pyramid by `separable_neighborhood_sample`.
    from sam_pt_torch.build import TRACKER_SETTINGS
    from sam_pt_torch.models.tracker import TRACKER_REGISTRY

    raft = TRACKER_REGISTRY["raft"](allow_random_init=True, seed=1,
                                    device=device, **TRACKER_SETTINGS["raft"])
    rng = np.random.default_rng(9)
    qp = np.concatenate([np.zeros((17, 1)), rng.uniform(
        [8, 8], [W - 8, H - 8], (17, 2))], 1)[None].astype(np.float32)
    runs = {"main_35x3": lambda: run_video(sam_pt, video,
                                           device_fuse_index_masks),
            "encode_24": lambda: sam_pt._encode_all_frames(images),
            "raft_24": lambda: raft.forward_device(images[None], qp)}
    found = {}
    os.makedirs("chiprun_out", exist_ok=True)
    for label, run in runs.items():
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        timed = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=40)
        total_ms = self_cuda_us(kernels) / 1e3
        by_shape = [e for e in prof.key_averages(group_by_input_shape=True)
                    if e.key in GEMM_OPS and e.self_device_time_total > 0]
        by_shape.sort(key=lambda e: e.self_device_time_total, reverse=True)
        log(f"gemm {tag} {label}: device {total_ms:.3f} ms, wall "
            f"{wall * 1e3:.3f} ms under the profiler, {timed * 1e3:.3f} ms "
            f"without it on {card}")
        for e in by_shape[:12]:
            log(f"  gemm {tag} {label}: {e.self_device_time_total / 1e3:9.3f}"
                f" ms x{e.count:<5d} {e.key} {e.input_shapes}")
        with open(f"chiprun_out/gemm_{label}_{tag}.txt", "w") as f:
            f.write(kernels)
            f.write("\n".join(
                f"{e.self_device_time_total / 1e3:.3f} ms x{e.count} "
                f"{e.key} {e.input_shapes}" for e in by_shape) + "\n")
        found[label] = total_ms
        found[f"{label}_wall_ms"] = timed * 1e3
    log(json.dumps({"gemm_profile": tag, **found}))
    return found


def main() -> int:
    t_start = time.perf_counter()
    profiling = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a GPU",
              file=sys.stderr)
        return 2
    card = card_line()
    log(card)
    if "--gemm-profile" in sys.argv[1:]:
        # F7's A/B: `--package DIR` profiles the sam_pt_torch package at
        # DIR (another version's copy) instead of this checkout's.
        args = sys.argv[1:]
        package = args[args.index("--package") + 1] if (
            "--package" in args) else os.path.dirname(
                os.path.realpath(__file__))
        sys.path.insert(0, os.path.realpath(package))
        import sam_pt_torch
        log(f"gemm profile of {sam_pt_torch.__file__}")
        gemm_profile(card, os.path.basename(os.path.realpath(package)))
        return 0
    if "--parallel" in sys.argv[1:]:
        parallel_only(card, cards_only="--cards" in sys.argv[1:])
        return 0
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    for name, without in (
            ("cv2", "the mixed negative sampler skips Shi-Tomasi, a "
                    "host-side sampling difference; frame resizing in the "
                    "CLI needs it"),
            ("yaml", "the port reads its configs with its own reader"),
            ("PIL", "the port reads PNG frames with its own codec; JPEG "
                    "frames and GIF visualisations need it"),
            ("pandas", "the port's scorers use plain tables and csv")):
        try:
            __import__(name)
            log(f"{name} importable: yes")
        except ImportError:
            log(f"{name} importable: no ({without})")

    # The port and its kernel sources must be this checkout's, beside the
    # script, not a copy found elsewhere on the path.
    import sam_pt_torch
    here = os.path.dirname(os.path.realpath(__file__))
    if os.path.dirname(os.path.dirname(os.path.realpath(
            sam_pt_torch.__file__))) != here:
        raise SystemExit(f"sam_pt_torch imported from {sam_pt_torch.__file__}"
                         f", not from this checkout ({here})")
    from sam_pt_torch.ops import flash_attention as fa
    from sam_pt_torch.ops import layer_norm as ln

    build_phase()
    device = torch.device("cuda")
    report = kernel_phase(fa, device, profiling)
    helpers_phase(device, card)

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
    ln.reset_launch_counts()
    outs = [run_video(sam_pt, v, device_fuse_index_masks) for v in videos]
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    ln_launches = ln.LAUNCHES["layer_norm"]
    expected = launch_schedule(sam_pt, [t for t, _ in VIDEOS],
                               [t * m for t, m in VIDEOS])
    ln_expected = layer_norm_schedule(sam_pt, [t for t, _ in VIDEOS],
                                      [t * m for t, m in VIDEOS])
    log(f"slice: launches {launches} expected {expected}; K5 {ln_launches} "
        f"expected {ln_expected}")
    if launches != expected or not all(
            launches[k] for k in ("window", "global", "cross")):
        raise SystemExit("launch counts differ from the schedule")
    if ln_launches != ln_expected:
        raise SystemExit("K5 launch counts differ from the schedule")
    for (t, m), (out, masks) in zip(VIDEOS, outs):
        log(f"slice: video {t} frames x {m} objects: "
            + check_outputs(out, masks, t, m, n_points))
    # Phase 21 holds the data-parallel main path to these.
    dp_reference = [(masks, out["scores"].float().cpu().numpy())
                    for out, masks in outs]

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
    patch_filter_phase(sam_pt, fa, device_fuse_index_masks, card)
    crop_launches = crop_phase(sam_pt, fa, device_fuse_index_masks, card,
                               profiling)
    del sam_pt
    torch.cuda.empty_cache()
    route_launches = route_phase(fa, device)
    reinit_phase(fa, device, device_fuse_index_masks, card, profiling)
    default_launches = default_model_phase(fa, device,
                                           device_fuse_index_masks, card,
                                           profiling)
    tracker_phase(device, card)
    cli_phase(fa, card)
    interactive_launches = interactive_phase(fa, card)
    hq_launches = hq_phase(fa, device_fuse_index_masks, card, profiling)
    mobile_phase(fa, device_fuse_index_masks, card, profiling)
    demo_phase(fa, card)
    vis_launches = vis_phase(fa, card, profiling=profiling)
    report.update(measure_cases(vis_kernel_cases(
        fa, device, vis_launches["pairs"], max(vis_launches["tracked"])),
        profiling))
    haiku_launches = haiku_tracker_phase(fa, device, device_fuse_index_masks,
                                         card, profiling)
    t0 = time.perf_counter()
    cli_phase(fa, card, model=TAPIR_CLI_MODEL, videos=1, label="cli tapir")
    tracker_demo_phase(card)
    log(f"cli tapir and tracker demos: {time.perf_counter() - t0:.1f} s")
    haiku_launches["superglue"] = superglue_phase(
        fa, device, device_fuse_index_masks, card, profiling)
    t0 = time.perf_counter()
    log("cli superglue: the CLI's random SuperGlue weights are not live "
        "(no match passes the threshold, so every point after frame 0 is "
        "invisible): this run shows only that the entry point composes "
        "and runs")
    cli_phase(fa, card, model=SUPERGLUE_CLI_MODEL, videos=1,
              label="cli superglue")
    match_pairs_phase(card)
    log(f"cli superglue and match_pairs: {time.perf_counter() - t0:.1f} s")
    tp_launches = parallel_phase(device, card, dp_reference, videos)

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the start "
        f"to the verdict")
    log(json.dumps({"kernels": kernel_json(
        report, launches, route_launches, default_launches, crop_launches,
        interactive_launches, hq_launches=hq_launches,
        vis_launches=vis_launches, haiku_launches=haiku_launches,
        tp_launches=tp_launches, ln_launches=ln_launches)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
