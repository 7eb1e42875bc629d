"""`harness/program_trace.py::reduce_program` on hand-made nested ranges:
each idle gap of the device goes to the innermost program span the host
was in at its start (a gap between two children to their parent, one
outside every span to `harness`), each launch and wait to the innermost
span around it; `read_profile` on a CPU profiler run of the port's
tracer; and the five per-layer readers of these results on hand-made
records."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import registry
from benchmark.harness.main import Record
from benchmark.harness.program_trace import (
    innermost,
    is_launch,
    is_wait,
    read_profile,
    reduce_program,
)

READERS = ["track_idle_ms_per_frame", "encode_idle_ms_per_frame",
           "decode_idle_ms_per_pair", "track_launches_per_frame",
           "decode_launches_per_pass"]

NS = 1e-9
# video [10, 90) > track [20, 50) > two windows; decode [60, 85)
SPANS = [(10, 90, "video"), (20, 50, "track"), (25, 30, "track.window"),
         (35, 40, "track.window"), (60, 85, "decode")]
# idle: [5, 8) harness, [12, 26) video, [28, 33) the first window,
# [34, 45) track between its windows, [62, 70) and [71, 95) decode
DEVICE = [(0, 5, "k"), (8, 12, "k"), (26, 28, "k"), (33, 34, "k"),
          (45, 62, "k"), (70, 71, "k"), (95, 100, "k"), (96, 97, "k")]


def test_gaps_go_to_the_innermost_span_at_their_start():
    out = reduce_program((0, 100), SPANS, [], DEVICE)
    assert out["gaps"] == pytest.approx({
        "harness": 3 * NS, "video": 14 * NS, "track.window": 5 * NS,
        "track": 11 * NS, "decode": 32 * NS})
    assert out["launches"] == {} and out["waits"] == {}
    # the idle total is the window less the union of the device's work
    busy = 5 + 4 + 2 + 1 + 17 + 1 + 5
    assert sum(out["gaps"].values()) == pytest.approx((100 - busy) * NS)


def test_launches_and_waits_go_to_the_innermost_span_around_them():
    calls = [(15, 16, "cudaLaunchKernel"), (27, 28, "cuLaunchKernelEx"),
             (36, 37, "cudaMemcpyAsync"), (37, 38, "cudaLaunchKernel"),
             (42, 43, "cudaMemsetAsync"), (45, 46, "cudaStreamSynchronize"),
             (61, 62, "cudaLaunchKernel"), (92, 93, "cudaLaunchKernel"),
             (105, 106, "cudaLaunchKernel")]  # the last after the window
    out = reduce_program((0, 100), SPANS, calls, DEVICE)
    assert out["launches"] == {"video": 1, "track.window": 3, "track": 1,
                               "decode": 1, "harness": 1}
    assert out["waits"] == {"track": 1}


def test_a_child_that_starts_with_its_parent_is_the_innermost():
    spans = [(0, 10, "parent"), (0, 4, "child"), (4, 6, "sibling")]
    assert innermost(spans, [0, 3, 4, 7, 10, 11]) == [
        "child", "child", "sibling", "parent", "harness", "harness"]
    assert innermost(list(reversed(spans)), [0]) == ["child"]


def test_launch_and_wait_names():
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cudaMemcpyAsync", "cudaMemsetAsync", "cuMemsetD8Async"):
        assert is_launch(name) and not is_wait(name), name
    for name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaEventSynchronize"):
        assert is_wait(name) and not is_launch(name), name
    assert not is_launch("cudaMemcpy") and not is_launch("aten::add")


def test_read_profile_finds_the_programs_spans_on_the_cpu():
    from sam_pt_torch.utils import tracing

    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("span:profiled"):
                with tracing.video("v", torch.device("cpu")):
                    with tracing.span("decode"):
                        torch.ones(8).sum()
    finally:
        tracing.disable()
    got = read_profile(prof, "profiled")
    lo, hi = got["window"]
    assert [s[2] for s in sorted(got["spans"])] == ["video", "decode"]
    assert all(lo <= a <= b <= hi for a, b, _ in got["spans"])
    assert got["device"] == [] and got["calls"] == []
    out = reduce_program(got["window"], got["spans"], got["calls"],
                         got["device"])
    assert sum(out["gaps"].values()) == pytest.approx((hi - lo) * NS)


@pytest.mark.parametrize("metric", READERS)
def test_program_reader_reads_nothing_without_the_programs_fields(metric):
    reader = registry.metric_reader(metric)
    assert reader.read(Record()) is None
    record = Record()
    record.program = [{"name": "video", "counts": {"frames": 0,
                                                   "pairs": 0}}]
    record.program_profile = {"gaps": {"track": 1.0}, "launches": {}}
    assert reader.read(record) is None  # the pass counted no work


def test_program_readers_compute_from_a_record():
    record = Record()
    record.program = [
        {"name": "video", "counts": {"frames": 40, "objects": 2,
                                     "pairs": 80}},
        {"name": "decode.chunk", "counts": {"pairs": 64, "passes": 14}},
        {"name": "decode.chunk", "counts": {"pairs": 16, "passes": 14}},
        {"name": "video", "counts": {"frames": 60, "objects": 1,
                                     "pairs": 60}},
        {"name": "decode.chunk", "counts": {"pairs": 60, "passes": 14}},
        {"name": "track.window", "counts": {"passes": 99}},  # not a pass
    ]
    record.program_profile = {
        "gaps": {"track": 1.0, "track.window": 2.0, "track.features": 0.5,
                 "tracker": 9.0, "encode": 0.25, "encode.chunk": 0.75,
                 "decode": 0.7, "decode.chunk": 0.7, "video": 5.0,
                 "harness": 3.0},
        "launches": {"track": 100, "track.window": 9900, "decode": 42,
                     "decode.chunk": 8400, "video": 7}}

    def read(name):
        return registry.metric_reader(name).read(record)

    assert read("track_idle_ms_per_frame") == pytest.approx(1e3 * 3.5 / 100)
    assert read("encode_idle_ms_per_frame") == pytest.approx(1e3 * 1.0 / 100)
    assert read("decode_idle_ms_per_pair") == pytest.approx(1e3 * 1.4 / 140)
    assert read("track_launches_per_frame") == pytest.approx(10000 / 100)
    assert read("decode_launches_per_pass") == pytest.approx(8400 / 42)
