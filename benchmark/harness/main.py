"""One run of one cell: set-up, the measured window, the traced parts when
asked, and the comparison that decides `correct`.

The window drives the VOS harness's timed region over the cell's cycle of
videos, back to back from the cycle's first video, in one process with
one chip. It ends when the first video to finish after `seconds` has
finished with its masks resolved; `fps` is the frames of every video in
it over its whole time. The traced run (`trace`) spends the window on
three parts in turn: the first pass of the cycle with a span around each
layer (synchronised), the next pass under `torch.profiler` with the
kernels' launch shapes recorded, then plain videos until `seconds` is
reached (at least one pass), whose wall time `mfu` divides by.
"""
from __future__ import annotations

import gc
import sys
import time
from collections import defaultdict

import torch

from . import check, registry, traffic, weights
from .trace import Launches, Spans, reduce_profile

FORBIDDEN = ("jax", "jaxlib", "flax", "sam_pt_tpu")


class Record:
    """What the traced run measured, for the per-layer metric readers."""

    def __init__(self):
        self.spans = {}  # layer -> seconds
        self.work = {}  # frames, objects, pairs of the spanned videos
        self.profile = None  # reduce_profile's dict
        self.launches = {}  # kind -> launch tuples
        self.model = {}  # flops, wall of the plain part


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Window:
    """The VOS harness over the cycle, video by video, with the first
    pass's outputs kept for the comparison and each video's kernel
    launches held to the schedule of the configuration's `reference`."""

    def __init__(self, system, harness, reference, config, videos, device):
        self.system, self.harness = system, harness
        self.reference = reference
        self.config, self.videos = config, videos
        self.device = device
        self.index = 0
        self.kept = []
        self.frames = self.pairs = self.done = 0
        self.launch_faults = []
        self.video_seconds = defaultdict(list)
        self._capture = {}
        self._wrap_capture()

    def _wrap_capture(self):
        sam_pt = self.harness.sam_pt
        for name in ("extract_query_points", "_encode_all_frames"):
            fn = getattr(sam_pt, name)

            def call(*a, _fn=fn, _name=name, **kw):
                out = _fn(*a, **kw)
                if self._capture is not None:
                    self._capture[_name] = out
                return out

            setattr(sam_pt, name, call)

    def expected_launches(self, video) -> dict:
        if self.device.type != "cuda":
            return dict.fromkeys(("window", "global", "cross", "relpos"), 0)
        return self.reference.launch_schedule(self.config, video["frames"],
                                              video["objects"])

    def step(self) -> None:
        """The next video of the cycle."""
        video = self.videos[self.index % len(self.videos)]
        first_pass = self.index < len(self.videos)
        self._capture = {} if first_pass else None
        keep = None
        if first_pass:
            def keep(outputs, pending, _v=video):
                self.kept.append(dict(
                    _v, query_points=self._capture["extract_query_points"],
                    embeddings=self._capture["_encode_all_frames"],
                    trajectories=outputs["trajectories"],
                    visibilities=outputs["visibilities"],
                    logits=outputs["logits"],
                    scores_per_frame=outputs["scores_per_frame"]))
        self.system.reset_launch_counts()
        t0 = time.perf_counter()
        previous = self.harness.process(video, keep)
        launches = self.system.launch_counts()
        self.video_seconds[f"{video['frames']}x{video['objects']}"].append(
            time.perf_counter() - t0)
        self._store(previous)
        expected = self.expected_launches(video)
        if launches != expected:
            self.launch_faults.append((video["video_id"], launches, expected))
        self.frames += video["frames"]
        self.pairs += video["frames"] * video["objects"]
        self.index += 1
        self.done += 1

    def _store(self, masks) -> None:
        """Index masks of the previous video; the first pass's are kept."""
        if masks is None:
            return
        for k in self.kept:
            if "masks" not in k:
                k["masks"] = masks
                return

    def finish(self) -> None:
        self._store(self.harness.resolve())
        self._capture = None


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: torch.device, log=print, min_videos: int = 0,
        warm: bool = True) -> dict:
    """The result of one run of `cell` (a `registry.Cell` or its name);
    the window runs `min_videos` videos at least. Without `warm` (a run
    only for the comparison's readings) nothing is warmed up."""
    if isinstance(cell, str):
        cell = registry.Cell(cell)
    config, system = cell.config, cell.system()
    reference = cell.reference()
    steps = {"imports": time.perf_counter() - t0}

    def step(name):
        sync(device)
        steps[name] = time.perf_counter() - t0 - sum(steps.values())

    built = system.load_kernels() if device.type == "cuda" else {}
    step("kernels")
    ckpt = weights.checkpoints(config, reference.param_shapes(config), seed,
                               device)
    sam_pt = system.build(config, ckpt, device)
    step("weights")
    videos = traffic.cycle(cell.traffic, seed, device)
    step("traffic")
    harness = system.Harness(sam_pt)
    for v in (traffic.warm_videos(videos, cell.traffic["warm_frames"])
              if warm else []):
        harness.process(v)
        harness.resolve()
    step("warm")
    setup_s = time.perf_counter() - t0
    log(f"setup {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items()) + f" (kernels {built})")

    window = Window(system, harness, reference, config, videos, device)
    record = Record()
    start = time.perf_counter()
    if trace:
        traced_parts(window, system, record, device, log)
    plain_start, plain_done = time.perf_counter(), window.done
    while True:
        window.step()
        elapsed = time.perf_counter() - start
        if (elapsed >= seconds and window.done >= min_videos
                and (not trace or window.done - plain_done >= len(videos))):
            break
    window.finish()
    sync(device)
    end = time.perf_counter()
    wall = end - start
    fps = window.frames / wall
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    if trace:
        plain = [videos[i % len(videos)] for i in range(plain_done, window.done)]
        record.model = {
            "flops": sum(sum(reference.video_flops(config, v["frames"],
                                                   v["objects"],
                                                   v["target_hw"]).values())
                         for v in plain),
            "wall": end - plain_start}
    log(f"window {wall:.3f} s, {window.done} videos, {window.frames} frames, "
        f"{window.pairs} pairs; seconds a video by shape "
        + ", ".join(f"{k}: " + " ".join(f"{s:.3f}" for s in v)
                    for k, v in window.video_seconds.items())
        + f"; peak {peak} bytes; launch faults {window.launch_faults[:3]}")
    found = forbidden_modules()

    kept, attempted = window.kept, window.done
    scores = torch.cat([k["scores_per_frame"].flatten().float() for k in kept])
    scores = scores[torch.isfinite(scores)].cpu()
    gate = config["sam_pt"]["sam_iou_threshold"]
    iou = {"pairs": int(scores.numel()),
           "passed": float((scores >= gate).float().mean()),
           "near_gate": float(((scores - gate).abs()
                               <= config["check"]["gate_band"]).float().mean()),
           "quartiles": [float(q) for q in torch.quantile(
               scores, torch.tensor([0.25, 0.5, 0.75]))] if len(scores) else []}
    log(f"IoU of the first pass's pairs with a visible prompt: {iou}")
    launch_faults = len(window.launch_faults)
    del window, harness, sam_pt
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.compare(reference, config, ckpt, kept, seed, device)
    numbers["launch_faults"] = launch_faults
    log(f"check {time.perf_counter() - t_check:.1f} s")
    correct, rows = check.verdict(numbers, config["limits"])
    return {"fps": fps, "setup_s": setup_s, "peak": peak, "record": record,
            "numbers": numbers, "rows": rows, "correct": correct,
            "forbidden": found, "attempted": attempted, "iou": iou,
            "failed": int(not correct)}


def traced_parts(window, system, record, device, log) -> None:
    """The spanned pass, then the profiled pass (see the module's doc)."""
    n = len(window.videos)
    spans = Spans(sync=lambda: sync(device))
    for label, method in system.SPANS.items():
        spans.wrap(window.harness.sam_pt, method, label)
    spans.wrap(window.harness, "fuse", "fuse")
    spans.wrap(window.harness, "resolve", "fuse")
    frames0, pairs0 = window.frames, window.pairs
    objects0 = sum(v["objects"] for v in window.videos)
    for _ in range(n):
        window.step()
    window.finish()
    spans.restore()
    record.spans = dict(spans.seconds)
    record.work = {"frames": window.frames - frames0,
                   "pairs": window.pairs - pairs0, "objects": objects0}

    from torch.profiler import ProfilerActivity, profile

    ranges = Spans()
    for label, method in system.SPANS.items():
        ranges.wrap(window.harness.sam_pt, method, label)
    ranges.wrap(window.harness, "fuse", "fuse")
    ranges.wrap(window.harness, "resolve", "fuse")
    with Launches(system.kernel_module(), system.KERNELS) as launches:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("span:profiled"):
                for _ in range(n):
                    window.step()
                window.finish()
                sync(device)
    ranges.restore()
    t0 = time.perf_counter()
    record.profile = reduce_profile(prof, "profiled")
    record.launches = launches.shapes()
    log(f"traced: spans {record.spans}, profiled window "
        f"{record.profile['window_s']:.3f} s busy {record.profile['busy_s']:.3f} s "
        f"{record.profile['ops']} device ops, read in "
        f"{time.perf_counter() - t0:.1f} s")


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
