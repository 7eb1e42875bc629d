"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py            # full run (needs one CUDA card)
    python3 chip_smoke.py --profile  # full run + stage split and profile

Phases, in order; any failure exits non-zero before the verdict line:
  1. The card's name and power limit (nvidia-smi), torch/CUDA versions.
  2. Build the CUDA kernels from `sam_pt_torch/csrc` (nvcc, sm_90a).
  3. Kernel phase: K1/K2/K3 against their plain PyTorch versions at the
     main path's shapes in bf16 (seeded inputs), max abs error against a
     stated tolerance, and CUDA-event times (median of 5 runs).
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
Then one JSON line with the per-kernel numbers, and as the last line
{"ok": true, "device": {...}}.
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
# RTOL * |ref| everywhere. Both round the output to bf16 (one ulp is up to
# 2^-7 relative) and K2's online softmax rounds p before normalising, so
# two ulps, plus 1e-2 for values near 0.
ATOL, RTOL = 1e-2, 2 ** -6
VIDEOS = [(24, 1), (35, 3)]  # (frames, objects) at 480 x 854
H, W = 480, 854


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of `fn` in ms, after one warm-up call."""
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


def kernel_phase(fa, device) -> dict:
    g = torch.Generator(device=device).manual_seed(1)

    def randn(*shape, std=1.0):
        return (std * torch.randn(shape, generator=g, device=device)
                ).to(torch.bfloat16)

    results = {}
    # K1: 25 windows x 4 frames, 196 tokens, 16 heads x 80.
    qkv = randn(100, 196, 3 * 16 * 80)
    rh, rw = randn(14, 14, 80, std=0.2), randn(14, 14, 80, std=0.2)
    bias = fa.window_bias(qkv, rh, rw, 16)
    kw = dict(scale=80 ** -0.5, heads=16)
    results["window"] = (
        lambda: fa.window_attention_cuda(qkv, bias, **kw),
        lambda: fa.window_attention_plain(qkv, bias, **kw))
    # K2: 4 frames of 64 x 64 tokens, 16 heads x 80 (native).
    qkv_g = randn(4, 4096, 3 * 16 * 80)
    rgh, rgw = randn(64, 64, 80, std=0.2), randn(64, 64, 80, std=0.2)
    bias_g = fa.global_bias(qkv_g, rgh, rgw, 16, 64, 64)
    kg = dict(scale=80 ** -0.5, heads=16, kh=64, kw=64)
    results["global"] = (
        lambda: fa.global_attention_cuda(qkv_g, bias_g, **kg),
        lambda: fa.global_attention_plain(qkv_g, bias_g, **kg))
    # K3: 48 pairs, 8 heads x 16; 60 prompt + output tokens, 4096 image
    # tokens. Token -> image unmasked; image -> token with a key mask.
    tok = randn(48, 60, 128)
    img = randn(48, 4096, 128)
    valid = torch.rand((48, 60), generator=g, device=device) > 0.3
    valid[:, :5] = True
    valid_u8 = valid.to(torch.uint8)
    kc = dict(heads=8, divisor=4.0)
    results["cross"] = (
        lambda: fa.cross_attention_cuda(tok, img, img, **kc),
        lambda: fa.cross_attention_plain(tok, img, img, **kc))
    results["cross_masked"] = (
        lambda: fa.cross_attention_cuda(img, tok, tok, kv_valid=valid_u8,
                                        **kc),
        lambda: fa.cross_attention_plain(img, tok, tok, kv_valid=valid,
                                         **kc))

    report = {}
    for name, (kernel, plain) in results.items():
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        diff = (got.float() - ref.float()).abs()
        err = float(diff.max())
        ratio = float((diff / (ATOL + RTOL * ref.float().abs())).max())
        ok = bool(torch.isfinite(got.float()).all()) and ratio <= 1.0
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain)
        log(f"kernel {name}: {got.dtype} shape {tuple(got.shape)} "
            f"max_abs_err {err:.3e} (|err| <= {ATOL:g} + {RTOL:g}|ref|: "
            f"worst {ratio:.3f} of the bound) kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"kernel {name} disagrees with its plain version")
        report[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return report


def make_video(n_frames: int, n_masks: int, seed: int) -> dict:
    """DAVIS-shaped synthetic video: random frames, box query masks on
    frame 0 (the shapes of bench.py's schedule)."""
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
        "query_point_timestep": np.zeros((n_masks,), np.float32),
    }


def expected_launches(sam_pt) -> dict:
    enc = sum(-(-t // sam_pt.sam_encode_chunk) for t, _ in VIDEOS)
    passes = 2 + sam_pt.iterative_refinement_iterations
    dec = sum(-(-(t * m) // min(sam_pt.sam_decode_chunk, t * m))
              for t, m in VIDEOS)
    return {"window": 28 * enc, "global": 4 * enc, "cross": 5 * passes * dec}


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
    n_masks = video["query_masks"].shape[0]
    masks = fuse(out["logits"], video["query_masks"], [0] * n_masks)
    return out, masks


def check_outputs(out, masks, n_frames, n_masks, n_points):
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
    visible = ~torch.isneginf(spf)  # -inf marks pairs with no visible prompt
    if not bool(torch.isfinite(spf[visible]).all()) or not bool(visible.any()):
        raise SystemExit("IoU scores not finite where a prompt was visible")
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
            f"planes kept by the IoU gate, labels {sorted(np.unique(masks))}")


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


def profile_phase(sam_pt, video, fuse, card: str) -> None:
    """Serialized stage split of one video, then a torch.profiler pass:
    device time by kernel and the device busy share. The full table goes
    to chiprun_out/profile_<frames>x<objects>.txt."""
    from torch.profiler import ProfilerActivity, profile

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

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_video(sam_pt, video, fuse)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    table = events.table(sort_by="self_cuda_time_total", row_limit=60)
    # Operators and the kernels they launch both carry device time, so the
    # busy total is the profiler's own footer, not a sum over the rows.
    found = re.search(r"Self CUDA time total: ([0-9.]+)(us|ms|s)", table)
    device_us = float(found.group(1)) * {"us": 1, "ms": 1e3,
                                         "s": 1e6}[found.group(2)]
    log(f"profile {t}x{m}: wall {wall:.4f} s under the profiler, device "
        f"busy {device_us / 1e6:.4f} s = {100 * device_us / 1e6 / wall:.1f}% "
        f"on {card}")
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)
    for e in top[:12]:
        if e.self_device_time_total <= 0:
            break
        log(f"  device {e.self_device_time_total / 1e3:10.3f} ms "
            f"{100 * e.self_device_time_total / device_us:5.1f}% "
            f"x{e.count:<6d} {e.key[:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/profile_{t}x{m}.txt", "w") as f:
        f.write(table)


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
    from sam_pt_torch.ops import _cuda
    from sam_pt_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    _cuda.library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({'built' if _cuda.BUILD_INFO['built'] else 'cached'}) "
        f"{_cuda.BUILD_INFO['path']}")
    for line in _cuda.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    device = torch.device("cuda")
    report = kernel_phase(fa, device)

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
    expected = expected_launches(sam_pt)
    log(f"slice: launches {launches} expected {expected}")
    if launches != expected or not all(launches.values()):
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

    meta = {
        "window": ("sam_pt_torch/csrc/window_attention.cu",
                   "sam_pt_tpu/ops/flash_attention.py:542"),
        "global": ("sam_pt_torch/csrc/global_attention.cu",
                   "sam_pt_tpu/ops/flash_attention.py:219"),
        "cross": ("sam_pt_torch/csrc/cross_attention.cu",
                  "sam_pt_tpu/ops/flash_attention.py:381"),
    }
    kernels = []
    for key, (source, replaces) in meta.items():
        r = report[key]
        entry = {"name": f"{key}_attention", "route": "cuda",
                 "source": source, "replaces": replaces,
                 "launches": launches[key],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"]}
        if key == "cross":  # token->image above; image->token (masked) here
            m = report["cross_masked"]
            entry["max_abs_err"] = max(r["max_abs_err"], m["max_abs_err"])
            entry["ms_image_to_token"] = m["ms"]
            entry["plain_ms_image_to_token"] = m["plain_ms"]
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
