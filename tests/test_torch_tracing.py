"""The port's tracer (`sam_pt_torch/utils/tracing.py`) on the CPU: the tiny
SAM with the tiny CoTracker (`torch_port_helpers`) or the tiny PIPS
(`sam_pt_torch.utils.testing`), under each benchmark configuration's
SamPt settings (16 k-medoids positives, one mixed negative, 12 box
refinements) with decode chunks of 5, so that the last chunk is padded.

- Off: nothing is recorded, `span()` is the one shared null context, and
  a CPU `torch.profiler` run holds no `sam_pt:` range.
- On: one `video` root a forward, every child inside its parent, the
  counts of the video, of the chunks and of CoTracker's windows, and each
  span's start within 1 ms of its `sam_pt:` range's start.
- Tracing on and off give bitwise-equal outputs.
- HQ-SAM: the `hq` span and the `interm_bytes` and `hq_pairs` counts.
- Fusion's download keeps the video it was made for; K3 counts its
  launches, pairs and keys only while tracing is on; the VOS CLI's
  `trace_output` writes Chrome trace-event JSON.
"""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from sam_pt_torch.models.sam.predictor import SamPredictor
from sam_pt_torch.models.sam.sam_model import Sam
from sam_pt_torch.models.sam_pt import SamPt
from sam_pt_torch.models.tracker.cotracker.model import CoTracker
from sam_pt_torch.models.tracker.cotracker.tracker import (
    CoTrackerPointTracker,
)
from sam_pt_torch.ops import _cuda
from sam_pt_torch.ops import flash_attention as fa
from sam_pt_torch.utils import tracing
from sam_pt_torch.utils.checkpoint import randomize_
from sam_pt_torch.utils.testing import (
    TINY_VIT,
    build_tiny_sam,
    build_tiny_sam_pt,
)
from sam_pt_torch.vos_eval import eval as t_eval
from torch_port_helpers import (
    TINY_COTRACKER,
    TINY_TRACKER,
    random_cotracker_state_dict,
    torch_sd,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"cotracker": "sam_vit_h-cotracker", "pips": "sam_vit_b-pips"}
DECODE_CHUNK = 5
T, H, W = 6, 48, 64


def _settings(tracker):
    with open(os.path.join(ROOT, "benchmark", "configs",
                           CONFIGS[tracker] + ".json")) as f:
        settings = json.load(f)["sam_pt"]
    settings["sam_decode_chunk"] = DECODE_CHUNK
    return settings


def _sam_pt(tracker, hq=False):
    """With `hq`, the tiny ViT with HQ-SAM's decoder in place of the tiny
    SAM (CoTracker only)."""
    settings = _settings(tracker)
    if tracker == "pips":
        return build_tiny_sam_pt(device="cpu", **settings)
    sd = random_cotracker_state_dict(seed=18, flow_head_scale=0.05,
                                     **TINY_COTRACKER)
    sd["vis_predictor.0.bias"][:] = 2.0
    model = CoTracker(**TINY_COTRACKER)
    model.load_state_dict(torch_sd(sd))
    cotracker = CoTrackerPointTracker(
        model=model.eval().requires_grad_(False), **TINY_TRACKER)
    sam = build_tiny_sam(device="cpu")
    if hq:
        sam = randomize_(Sam(TINY_VIT, image_size=64, use_hq=True),
                         torch.Generator().manual_seed(19))
        sam.eval().requires_grad_(False)
    return SamPt(cotracker, SamPredictor(sam), **settings)


def _video(video_id=None):
    rng = np.random.default_rng(16)
    masks = np.zeros((2, H, W), np.float32)
    masks[0, 10:25, 8:30] = 1
    masks[1, 28:45, 35:60] = 1
    video = {"image": rng.integers(0, 255, (T, H, W, 3)).astype(np.uint8),
             "target_hw": (H, W), "query_masks": masks,
             "query_point_timestep": np.array([0, 3], np.float32)}
    if video_id is not None:
        video["video_id"] = video_id
    return video


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    return request.param, _sam_pt(request.param)


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    yield
    tracing.disable()


def _forward(sam_pt, video):
    sam_pt.rng = np.random.default_rng(72)  # the same points every call
    return sam_pt.forward(video)


def _program_ranges(prof):
    return sorted((e.start_ns(), e.name()[len("sam_pt:"):])
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("sam_pt:"))


def test_off_records_nothing(model):
    _, sam_pt = model
    assert tracing.span("encode", frames=3) is tracing.span("decode")
    assert tracing.video("v", None) is tracing.span("track")
    tracing.count("passes")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _forward(sam_pt, _video())
    assert _program_ranges(prof) == []
    assert tracing.export() == [] and tracing.current_video() is None


def _children(spans, parent):
    return [s for s in spans if s["parent"] == parent]


def _one(spans, name):
    found = [s for s in spans if s["name"] == name]
    assert len(found) == 1, (name, len(found))
    return found[0]


def test_spans_nest_count_and_share_the_profilers_clock(model):
    tracker, sam_pt = model
    settings = _settings(tracker)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _forward(sam_pt, _video("clip"))
    spans = tracing.export()
    names = {s["name"] for s in spans}
    assert names == {"video", "upload", "encode", "encode.chunk", "query",
                     "query.points", "track", "track.features",
                     "track.window", "decode", "decode.chunk"}

    root = _one(spans, "video")
    assert root["parent"] is None and root["video"] == "clip"
    objects = 2
    assert root["counts"] == {"frames": T, "objects": objects,
                              "pairs": T * objects}
    for i, s in enumerate(spans):
        assert s["video"] == "clip"
        assert s["device_ms"] is None  # the CPU has no timing events
        if s["parent"] is not None:
            parent = spans[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= parent["end_ns"], (s["name"], parent["name"])
            assert s["parent"] < i
    layers = {s["name"] for s in _children(spans, spans.index(root))}
    assert layers == {"upload", "encode", "query", "track", "decode"}
    assert _one(spans, "upload")["counts"] == {"bytes": T * H * W * 3}

    chunks = [s["counts"] for s in spans if s["name"] == "encode.chunk"]
    ec = settings["sam_encode_chunk"]
    assert sum(c["frames"] for c in chunks) == T
    assert sum(c["padded_frames"] for c in chunks) == len(chunks) * ec - T

    points = [s["counts"]["points"] for s in spans
              if s["name"] == "query.points"]
    # one span a mask's k-medoids positives, one for the mixed negatives
    assert points == [settings["positive_points_per_mask"]] * objects + [
        settings["negative_points_per_mask"] * objects]

    chunks = [s["counts"] for s in spans if s["name"] == "decode.chunk"]
    pairs = T * objects
    assert sum(c["pairs"] for c in chunks) == pairs
    assert sum(c["padded_pairs"] for c in chunks) == (
        len(chunks) * DECODE_CHUNK - pairs)
    # the positives-only pass, the all-points pass, 12 box refinements
    assert settings["iterative_refinement_iterations"] == 12
    assert all(c["passes"] == 2 + 12 for c in chunks)

    windows = [s["counts"] for s in spans if s["name"] == "track.window"]
    assert {c["direction"] for c in windows} == {"forward", "backward"}
    # the CPU copies nothing to the host
    assert all(set(c) == {"direction", "tracks"} for c in windows)
    if tracker == "cotracker":
        s = sam_pt.point_tracker.s
        batches = -(-objects // settings["point_tracker_mask_batch_size"])
        assert len(windows) == batches * 2 * len(range(0, T - s // 2, s // 2))
    _one(spans, "track.features")

    ranges = _program_ranges(prof)
    starts = sorted((s["start_ns"], s["name"]) for s in spans)
    assert [n for _, n in ranges] == [n for _, n in starts]
    gaps = [abs(a - b) for (a, _), (b, _) in zip(ranges, starts)]
    assert max(gaps) < 1_000_000, max(gaps)


def test_hq_span_counts_frames_features_and_pairs():
    """HQ-SAM: the `hq` span, under `video` between `encode` and `query`,
    counts the video's frames once and the bytes of the image-level
    features it holds; each `encode.chunk` counts the bytes of its early
    features (`interm_bytes`), each `decode.chunk` its pairs as
    `hq_pairs`."""
    sam_pt = _sam_pt("cotracker", hq=True)
    tracing.enable()
    _forward(sam_pt, _video("clip"))
    spans = tracing.export()
    root = spans.index(_one(spans, "video"))
    assert [s["name"] for s in _children(spans, root)] == [
        "upload", "encode", "hq", "query", "track", "decode"]
    # the tiny ViT: a 4 x 4 grid of 32 wide; features 16 x 16 x 32, float32
    assert _one(spans, "hq")["counts"] == {"frames": T,
                                           "bytes": T * 16 * 16 * 32 * 4}
    chunks = [s["counts"] for s in spans if s["name"] == "encode.chunk"]
    assert [c["interm_bytes"] for c in chunks] == [
        c["frames"] * 4 * 4 * 32 * 4 for c in chunks]
    chunks = [s["counts"] for s in spans if s["name"] == "decode.chunk"]
    assert all(c["hq_pairs"] == c["pairs"] for c in chunks)
    assert sum(c["hq_pairs"] for c in chunks) == T * 2


def test_outputs_equal_with_tracing_on_and_off(model):
    _, sam_pt = model
    off = _forward(sam_pt, _video())
    tracing.enable()
    on = _forward(sam_pt, _video())
    assert tracing.export()[0]["name"] == "video"
    for key in ("trajectories", "visibilities", "logits", "scores",
                "scores_per_frame"):
        assert torch.equal(on[key], off[key]), key


def test_download_keeps_the_video_it_was_made_for(model):
    _, sam_pt = model
    tracing.enable()
    out = _forward(sam_pt, _video("first"))
    masks = _video()["query_masks"]
    pending = t_eval.device_fuse_index_masks(out["logits"], masks, [0, 3],
                                             defer=True)
    _forward(sam_pt, _video())  # the next video has no id: a number
    pending.get()
    spans = tracing.export()
    assert [s["video"] for s in spans if s["name"] == "video"] == [
        "first", 1]
    fuse, download = _one(spans, "fuse"), _one(spans, "fuse.download")
    assert fuse["parent"] is None and fuse["video"] == "first"
    assert fuse["counts"] == {"frames": T}
    assert download["parent"] is None and download["video"] == "first"
    # one chunk of 16 frames, two pixels a byte
    assert download["counts"] == {"bytes": 16 * H * (W // 2)}


class _OnDevice:
    """A tensor on a device, as far as `to_host` looks."""

    def __init__(self, host):
        self.host = host
        self.device = torch.device("cuda", 0)

    def cpu(self):
        return self.host


def test_to_host_counts_each_copy_from_a_device():
    x = torch.arange(6, dtype=torch.float32)
    assert np.array_equal(tracing.to_host(_OnDevice(x)), x.numpy())  # off
    tracing.enable()
    with tracing.span("track.window"):
        tracing.to_host(_OnDevice(x))
        tracing.to_host(_OnDevice(x[:2]))
        tracing.to_host(x)  # already on the host: no copy
    assert tracing.export()[0]["counts"] == {"d2h_copies": 2,
                                             "d2h_bytes": 32}


def test_k3_counts_launches_pairs_and_keys_while_tracing(monkeypatch):
    """The K3 wrapper's counter, with its library call stubbed (the
    kernel runs only on a card)."""
    class Library:
        def sam_cross_attention(self, *args):
            return 0

    monkeypatch.setattr(_cuda, "library", Library)
    monkeypatch.setattr(_cuda, "check", lambda status, name: None)
    monkeypatch.setattr(fa, "_check_cuda", lambda name, tensors: None)
    monkeypatch.setattr(fa, "_stream", lambda: 0)
    monkeypatch.setattr(fa, "LAUNCHES", dict(fa.LAUNCHES))
    q = torch.zeros((3, 7, 32), dtype=torch.bfloat16)
    k = torch.zeros((3, 20, 32), dtype=torch.bfloat16)

    def launch():
        fa.cross_attention_cuda(q, k, k, heads=2, divisor=4.0)

    launch()  # off: no span, no count
    tracing.enable()
    with tracing.span("decode.chunk"):
        launch()
        launch()
    launch()  # no span open: nothing kept
    assert tracing.export()[0]["counts"] == {
        "k3.launches": 2, "k3.pairs": 6, "k3.keys": 120}
    assert fa.LAUNCHES["cross"] == 4
    assert set(fa.LAUNCHES) == {"window", "global", "cross", "relpos"}


def _png_tree(root):
    """A DAVIS-2017 val tree of one 4-frame PNG video with two objects."""
    rng = np.random.default_rng(6)
    palette = np.zeros((256, 3), np.uint8)
    palette[1:3] = [[128, 0, 0], [0, 128, 0]]
    frames = root / "trainval" / "JPEGImages" / "480p" / "v0"
    labels = root / "trainval" / "Annotations" / "480p" / "v0"
    frames.mkdir(parents=True)
    labels.mkdir(parents=True)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (H, W, 3)).astype(
            np.uint8)).save(frames / f"{i:05d}.png")
        mask = np.zeros((H, W), np.uint8)
        mask[5:20, 4 + i:30 + i] = 1
        mask[28:44, 34:60] = 2
        im = Image.fromarray(mask, mode="P")
        im.putpalette(palette.flatten().tolist())
        im.save(labels / f"{i:05d}.png")
    sets = root / "trainval" / "ImageSets" / "2017"
    sets.mkdir(parents=True)
    (sets / "val.txt").write_text("v0\n")


def test_vos_cli_writes_a_chrome_trace(tmp_path):
    _png_tree(tmp_path / "davis")
    out = tmp_path / "trace" / "spans.json"
    cfg = {"seed": 72, "dataset": "D17", "split": "val", "size": -1,
           "longest_size": None, "d17_path": str(tmp_path / "davis"),
           "output": str(tmp_path / "out"), "masks_batch_size": 100,
           "score": False, "make_zip": False, "visualize_results": False,
           "trace_output": str(out),
           "model": {"_target_": "sam_pt_torch.utils.testing."
                                 "build_tiny_sam_pt", "device": "cpu"}}
    assert t_eval.evaluate(cfg)["total_frames"] == 4
    assert not tracing.enabled()
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    by_name = {}
    for e in events:
        assert e["ph"] == "X" and e["dur"] >= 0
        by_name.setdefault(e["name"], []).append(e)
    assert set(by_name) >= {"video", "encode", "track", "decode", "fuse",
                            "fuse.download"}
    video = by_name["video"][0]
    assert video["args"]["video"] == "000--v0--mask-0"
    assert video["args"]["frames"] == 4 and video["args"]["pairs"] == 8
    assert by_name["fuse.download"][0]["args"]["video"] == "000--v0--mask-0"
    # the profiler's clock: Unix microseconds
    assert abs(video["ts"] / 1e6 - os.path.getmtime(out)) < 600
