"""The SAM encode chunk as a CUDA graph (`models/sam/encode_graphs.py`):
the constants it reads, built once per shape and cached, against the
per-call builds they replace; the replay's kernel launches announced to
the entry points (`ops/graph_launches.py`); and, on the card, the
replayed chunks against the eager ones.

The tests marked `cuda` import nothing of jax and run on the card with

    python -m pytest --noconftest -q -m cuda tests/test_torch_encode_graphs.py
"""
import re

import numpy as np
import pytest
import torch

from sam_pt_torch.models.sam import encode_graphs, image_encoder, tiny_vit
from sam_pt_torch.models.sam.predictor import SamPredictor
from sam_pt_torch.models.sam.sam_model import (
    PIXEL_MEAN,
    PIXEL_STD,
    Sam,
    pixel_stats,
)
from sam_pt_torch.ops import flash_attention as fa
from sam_pt_torch.ops import graph_launches
from sam_pt_torch.ops import layer_norm as ln
from sam_pt_torch.utils import tracing
from sam_pt_torch.utils.checkpoint import randomize_
from sam_pt_torch.utils.testing import TINY_VIT, build_tiny_sam_pt
from sam_pt_torch.utils.tree import leading_size, pad_last, tree_map

torch.set_num_threads(1)
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# The cached constants against the per-call builds they replace
# ---------------------------------------------------------------------------

def _rel_index_per_call(q_size, k_size):
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return torch.as_tensor(rel.astype(np.int64))


def _pad_mask_per_call(batch, hw, padded_hw, window, dtype):
    (h, w), (hp, wp) = hw, padded_hw
    real = np.zeros((hp, wp), np.float32)
    real[:h, :w] = 1.0
    m = real.reshape(hp // window, window, wp // window, window)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window * window, 1)
    return torch.as_tensor(np.tile(m, (batch, 1, 1)), dtype=dtype)


@pytest.mark.parametrize("q_size,k_size", [(14, 14), (64, 64), (36, 36),
                                           (7, 12), (12, 7)])
def test_rel_pos_index_is_the_per_call_build_once(q_size, k_size):
    idx = image_encoder.rel_pos_index(q_size, k_size, CPU)
    assert torch.equal(idx, _rel_index_per_call(q_size, k_size))
    assert image_encoder.rel_pos_index(q_size, k_size, CPU) is idx
    rel_pos = torch.randn(2 * max(q_size, k_size) - 1, 8)
    assert torch.equal(image_encoder.rel_pos_table(rel_pos, q_size, k_size),
                       rel_pos[_rel_index_per_call(q_size, k_size)])


def test_rel_pos_table_follows_its_parameter():
    """The index is cached, the gather is not: a table read after the
    parameter changes reads the new values."""
    rel_pos = torch.randn(27, 8)
    before = image_encoder.rel_pos_table(rel_pos, 14, 14)
    rel_pos.mul_(2)
    assert torch.equal(image_encoder.rel_pos_table(rel_pos, 14, 14),
                       2 * before)


@pytest.mark.parametrize("batch,hw,window,dtype", [
    (4, (64, 64), 14, torch.bfloat16),  # ViT-H/B at 1024: 64 -> 70
    (1, (36, 64), 14, torch.float32),   # a cropped grid: 36 x 64 -> 42 x 70
    (2, (5, 7), 2, torch.float32),
])
def test_window_pad_mask_is_the_per_call_build_once(batch, hw, window,
                                                    dtype):
    padded = tuple(-(-s // window) * window for s in hw)
    mask = image_encoder.window_pad_mask(batch, hw, padded, window, CPU,
                                         dtype)
    want = _pad_mask_per_call(batch, hw, padded, window, dtype)
    assert mask.dtype == dtype and torch.equal(mask, want)
    assert image_encoder.window_pad_mask(batch, hw, padded, window, CPU,
                                         dtype) is mask


def test_window_pad_mask_of_an_even_grid_is_none():
    assert image_encoder.window_pad_mask(4, (28, 28), (28, 28), 14, CPU,
                                         torch.float32) is None


def test_pixel_stats_are_the_per_call_build_once():
    mean, std = pixel_stats(CPU)
    assert torch.equal(mean, torch.tensor(PIXEL_MEAN))
    assert torch.equal(std, torch.tensor(PIXEL_STD))
    again = pixel_stats(CPU)
    assert again[0] is mean and again[1] is std


def test_preprocess_is_the_per_call_normalisation():
    sam = Sam(TINY_VIT, image_size=64)
    images = torch.rand(2, 48, 64, 3) * 255
    want = (images - torch.tensor(PIXEL_MEAN)) / torch.tensor(PIXEL_STD)
    want = torch.nn.functional.pad(want, (0, 0, 0, 0, 0, 16))
    assert torch.equal(sam.preprocess(images), want)


@pytest.mark.parametrize("window", [7, 14])
def test_tiny_vit_rel_bias_index_is_the_per_call_build_once(window):
    idx = tiny_vit._device_rel_bias_index(window, CPU)
    assert torch.equal(idx, torch.as_tensor(tiny_vit._rel_bias_index(window)))
    assert tiny_vit._device_rel_bias_index(window, CPU) is idx


# ---------------------------------------------------------------------------
# Launches announced after a replay
# ---------------------------------------------------------------------------

def _k1_call():
    heads, d, n = 2, 16, 196
    return (fa.window_attention_cuda,
            (torch.zeros(8, n, 3 * heads * d), torch.zeros(8, n, heads, 28)),
            dict(scale=0.25, heads=heads), fa.LAUNCHES, "window")


def _k2_call():
    heads, d = 2, 16
    return (fa.global_attention_cuda,
            (torch.zeros(2, 32 * 40, 3 * heads * d),
             torch.zeros(2, 32 * 40, heads, 72)),
            dict(scale=0.25, heads=heads, kh=32, kw=40), fa.LAUNCHES,
            "global")


def _k5_call():
    return (ln.layer_norm_cuda,
            (torch.zeros(2, 8, 8, 256), torch.ones(256), torch.zeros(256),
             1e-6, False), {}, ln.LAUNCHES, "layer_norm")


@pytest.mark.parametrize("make", [_k1_call, _k2_call, _k5_call],
                         ids=["K1", "K2", "K5"])
def test_announce_counts_each_recorded_launch_through_its_module(
        make, monkeypatch):
    """A call recorded during a capture keeps its arguments' shapes only
    (on the meta device); announcing it reaches whatever is installed at
    the entry point's name (a wrapper that records launches, as the
    benchmark's does), counts one launch there and launches nothing."""
    entry, args, kwargs, counter, kind = make()
    module = ln if entry is ln.layer_norm_cuda else fa
    seen = []

    def wrapper(*a, **kw):
        seen.append((tuple(a[0].shape), kw))
        return entry(*a, **kw)

    # Recorded while a wrapper is installed, announced through the name.
    monkeypatch.setattr(module, entry.__name__, wrapper)
    with graph_launches.recording() as calls:
        assert not graph_launches.announced(module.__name__, entry.__name__,
                                            *args, **kwargs)
    assert len(calls) == 1
    recorded = calls[0][2][0]
    assert recorded.device.type == "meta"
    assert (recorded.shape, recorded.stride()) == (args[0].shape,
                                                   args[0].stride())
    before = counter[kind]
    graph_launches.announce(calls)
    graph_launches.announce(calls)
    assert counter[kind] == before + 2
    assert [s for s, _ in seen] == [tuple(args[0].shape)] * 2
    assert all(set(kw) == set(kwargs) for _, kw in seen)
    assert not graph_launches.announced(module.__name__, entry.__name__,
                                        *args, **kwargs)


def test_announced_k5_counts_its_rows_in_the_open_span():
    _, args, kwargs, _, _ = _k5_call()
    with graph_launches.recording() as calls:
        graph_launches.announced(ln.__name__, "layer_norm_cuda", *args,
                                 **kwargs)
    tracing.enable()
    try:
        with tracing.span("encode.chunk"):
            graph_launches.announce(calls)
        (span,) = tracing.export()
    finally:
        tracing.disable()
    assert span["counts"]["ln.launches"] == 1
    assert span["counts"]["ln.rows"] == 2 * 8 * 8


def test_paused_tracer_records_nothing_inside():
    tracing.enable()
    try:
        with tracing.span("encode.chunk"):
            tracing.count("graph_replays")
            with tracing.paused():
                assert not tracing.enabled()
                tracing.count("ln.launches")
                with tracing.span("inner"):
                    tracing.count("ln.rows", 5)
            assert tracing.enabled()
            tracing.count("graph_replays")
        spans = tracing.export()
    finally:
        tracing.disable()
    assert [s["name"] for s in spans] == ["encode.chunk"]
    assert spans[0]["counts"] == {"graph_replays": 2}


# ---------------------------------------------------------------------------
# Off CUDA the runner is the eager call
# ---------------------------------------------------------------------------

def _eager_chunks(predictor, images, chunk):
    """The video's chunks encoded one by one and concatenated: the path
    before the graphs."""
    t, h, w, _ = images.shape
    out = []
    for i in range(0, t, chunk):
        part = images[i:i + chunk]
        emb = predictor.encode_frames(pad_last(part, chunk), (h, w))
        out.append(tree_map(lambda e: e[:len(part)], emb))
    return tree_map(lambda *c: torch.cat(c), *out)


@pytest.mark.parametrize("hq", [False, True], ids=["plain", "hq"])
def test_video_encode_off_cuda_is_the_eager_chunks(hq):
    """`_encode_all_frames` on the CPU: the chunks' results written into
    one [T, ...] result equal the concatenated eager chunks bit for bit,
    and the runner captures and replays nothing."""
    gen = torch.Generator().manual_seed(5)
    sam = randomize_(Sam(TINY_VIT, image_size=64, use_hq=hq), gen)
    predictor = SamPredictor(sam.eval().requires_grad_(False))
    sam_pt = build_tiny_sam_pt(device="cpu", sam_predictor=predictor)
    images = torch.randint(0, 255, (7, 48, 64, 3), dtype=torch.uint8,
                           generator=gen)
    got = sam_pt._encode_all_frames(images)
    want = _eager_chunks(predictor, images, sam_pt.sam_encode_chunk)
    tree_map(lambda g, w: torch.testing.assert_close(g, w, atol=0, rtol=0),
             got, want)
    runner = sam_pt.encode_graphs
    assert (runner.captures, runner.replays) == (0, 0)


def test_runner_off_cuda_calls_the_chunk():
    runner = encode_graphs.EncodeGraphs()
    images = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(runner(lambda x: x * 2, images, "key"), images * 2)
    assert (runner.captures, runner.replays) == (0, 0)


def test_interactive_encodes_through_the_graph_runner():
    """`SamPtInteractive` encodes a video's chunks as `SamPt` does: each
    chunk reaches its graph runner, one call a chunk."""
    interactive = build_tiny_sam_pt(device="cpu", interactive=True)
    runner = interactive.encode_graphs
    assert isinstance(runner, encode_graphs.EncodeGraphs)
    calls = []

    def recording(fn, images, key):
        calls.append(tuple(images.shape))
        return encode_graphs.EncodeGraphs.__call__(runner, fn, images, key)

    interactive.encode_graphs = recording
    size = interactive.sam_predictor.model.image_size
    images = torch.zeros(6, size, size, 3, dtype=torch.uint8)
    emb = interactive._encode_all_frames(images)
    ec = interactive.sam_encode_chunk
    assert calls == [(ec, size, size, 3)] * -(-6 // ec)
    assert leading_size(emb) == 6


def test_a_mesh_keeps_the_eager_call():
    class Refuses:
        def __call__(self, *a):
            raise AssertionError("a mesh predictor took the graph runner")

    predictor = build_tiny_sam_pt(device="cpu").sam_predictor
    predictor.mesh = object()  # any mesh: its batch axis is not wired
    images = torch.zeros(2, 64, 64, 3, dtype=torch.uint8)
    predictor.encode_frames(images, (64, 64), graphs=Refuses())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _card_sam(card, encoder="vit_h", hq=False, seed=0):
    torch.manual_seed(seed)
    with torch.device(card):
        sam = Sam(encoder, use_hq=hq)
    return sam.to(torch.bfloat16).eval().requires_grad_(False)


@pytest.fixture(scope="module")
def vit_h(card):
    return _card_sam(card)


@pytest.fixture(scope="module")
def vit_h_hq(card):
    return _card_sam(card, hq=True, seed=1)


def _video(card, t, h=480, w=854, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 255, (t, h, w, 3), dtype=torch.uint8,
                         generator=gen).to(card)


def _sam_pt(sam):
    return build_tiny_sam_pt(device="cpu", sam_predictor=SamPredictor(sam))


def _launch_counts():
    return dict(fa.LAUNCHES), dict(ln.LAUNCHES)


def _reset_counts():
    fa.reset_launch_counts()
    ln.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("hq", [False, True], ids=["plain", "hq"])
def test_replayed_video_equals_the_eager_one(card, vit_h, vit_h_hq, hq):
    """Ten distinct frames, three chunks (the last padded): every frame's
    embedding (HQ: and `interm`) from the replays equals the eager
    chunks' bit for bit, no chunk shows another's (aliased static
    outputs would), and the launches counted equal the eager run's."""
    sam_pt = _sam_pt(vit_h_hq if hq else vit_h)
    images = _video(card, 10)
    results, counts = [], []
    for graphs in (sam_pt.encode_graphs, None):
        sam_pt.encode_graphs = graphs
        _reset_counts()
        results.append(sam_pt._encode_all_frames(images))
        torch.cuda.synchronize()
        counts.append(_launch_counts())
    got, want = results
    tree_map(lambda g, w: torch.testing.assert_close(g, w, atol=0, rtol=0),
             got, want)
    emb = got["emb"] if hq else got
    assert not torch.equal(emb[0:4], emb[4:8])
    assert not torch.equal(emb[4:6], emb[8:10])
    assert counts[0] == counts[1]
    assert counts[0][0]["window"] == 28 * 3 and counts[0][0]["global"] == 4 * 3


@pytest.mark.cuda
def test_one_capture_a_shape_and_replays_counted_as_launches(card, vit_h,
                                                              monkeypatch):
    """The first video captures, the second of its shape replays only,
    a third of another frame size captures anew; a wrapper at K1's entry
    point (as the benchmark's launch recorder) sees a replay's launches
    as it sees the eager chunk's; the tracer's `encode.chunk` spans count
    a replay a chunk, the capture once, and K5's launches and rows as the
    eager chunks do."""
    sam_pt = _sam_pt(vit_h)
    runner = sam_pt.encode_graphs
    seen = []
    entry = fa.window_attention_cuda

    def recorder(qkv, bias, **kw):
        seen.append((tuple(qkv.shape), kw["heads"]))
        return entry(qkv, bias, **kw)

    monkeypatch.setattr(fa, "window_attention_cuda", recorder)

    def traced(images, graphs):
        sam_pt.encode_graphs = graphs
        tracing.enable()
        try:
            with tracing.span("encode"):
                sam_pt._encode_all_frames(images)
            return [s for s in tracing.export() if s["name"] == "encode.chunk"]
        finally:
            tracing.disable()

    video = _video(card, 12, seed=2)
    first = traced(video, runner)
    assert (runner.captures, runner.replays) == (1, 3)
    seen.clear()
    second = traced(_video(card, 9, seed=3), runner)
    replayed_shapes = list(seen)
    assert (runner.captures, runner.replays) == (1, 6)
    seen.clear()
    eager = traced(_video(card, 9, seed=3), None)
    assert replayed_shapes == seen and len(seen) == 28 * 3
    for spans in (first, second):
        assert sum(s["counts"].get("graph_replays", 0) for s in spans) == 3
    assert sum(s["counts"].get("graph_captures", 0) for s in first) == 1
    assert sum(s["counts"].get("graph_captures", 0) for s in second) == 0
    for key in ("ln.launches", "ln.rows"):
        assert ([s["counts"][key] for s in second]
                == [s["counts"][key] for s in eager]), key
    traced(_video(card, 4, h=360, w=640, seed=4), runner)
    assert (runner.captures, runner.replays) == (2, 7)


@pytest.mark.cuda
def test_tiny_vit_chunk_replays_as_its_eager_call(card):
    """MobileSAM's TinyViT takes the graph too (its bias index is
    cached): a replay equals the eager call bit for bit."""
    sam = _card_sam(card, encoder="vit_t", seed=3)
    predictor = SamPredictor(sam)
    runner = encode_graphs.EncodeGraphs()
    for seed in (5, 6):
        images = _video(card, 4, seed=seed)
        got = predictor.encode_frames(images, (480, 854), graphs=runner)
        got = got.clone()
        want = predictor.encode_frames(images, (480, 854))
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert (runner.captures, runner.replays) == (1, 2)


@pytest.mark.cuda
def test_warm_eager_chunk_makes_no_blocking_call(card, vit_h):
    """After one call has built the chunk's constants, an eager chunk
    (plain and cropped to the frame's tokens) runs with PyTorch's sync
    debug mode raising on any synchronising call, so that no blocking
    upload comes back unnoticed."""
    predictor = SamPredictor(vit_h)
    images = _video(card, 4, seed=7)
    for crop in (False, True):
        vit_h.crop_pad_tokens = crop
        try:
            predictor.encode_frames(images, (480, 854))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                predictor.encode_frames(images, (480, 854))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        finally:
            vit_h.crop_pad_tokens = False


# The kernel names of each counter's launches in a device trace (K5's
# is not PyTorch's `vectorized_layer_norm_kernel`).
_KERNELS = {"window": re.compile(r"\brelpos_window_kernel\b"),
            "global": re.compile(r"\brelpos_flash_kernel\b"),
            "layer_norm": re.compile(r"\blayer_norm_kernel\b")}


def _profiled_chunk(encode):
    """The launches `encode()` counts and the kernels the card runs for
    it, under `torch.profiler`, by `_KERNELS`' keys."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    _reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        encode()
        torch.cuda.synchronize()
    fa_counts, ln_counts = _launch_counts()
    counted = {**fa_counts, **ln_counts}
    ran = dict.fromkeys(_KERNELS, 0)
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            for key, kernel in _KERNELS.items():
                ran[key] += bool(kernel.search(e.name()))
    return counted, ran


@pytest.mark.cuda
def test_profiled_replay_runs_the_kernels_it_announces(card, vit_h):
    """A replayed chunk's announced K1, K2 and K5 launches are the
    kernels the card runs for it, counted by name in a device trace, and
    those the eager chunk runs: the counters follow the replay's work,
    not only the capture's log."""
    predictor = SamPredictor(vit_h)
    runner = encode_graphs.EncodeGraphs()
    images = _video(card, 4, seed=8)
    predictor.encode_frames(images, (480, 854), graphs=runner)
    replayed = _profiled_chunk(lambda: predictor.encode_frames(
        images, (480, 854), graphs=runner))
    eager = _profiled_chunk(lambda: predictor.encode_frames(
        images, (480, 854)))
    assert (runner.captures, runner.replays) == (1, 2)
    for counted, ran in (replayed, eager):
        assert counted["relpos"] == counted["cross"] == 0
        assert {k: counted[k] for k in _KERNELS} == ran
    assert replayed == eager
    assert replayed[1]["window"] == 28 and replayed[1]["global"] == 4
