"""The port's tracer: spans and counters at the layer boundaries of
`SamPt` and at the loops beneath them, off by default.

    tracing.enable()                    # install a recorder
    with tracing.video(video_id, device, frames=t):
        with tracing.span("encode", frames=t):
            tracing.count("passes")     # the innermost open span's counter
    spans = tracing.export()            # or tracing.write("trace.json")
    tracing.disable()

The recorder is a `utils/logging.py::StageTimer` that keeps its stages as
spans (see there): name, start and end on the clock of `torch.profiler`
(Unix nanoseconds), parent, video id, counts; a `sam_pt:<name>` profiler
range while a profiler run is active; a pair of CUDA timing events on the
spans at depth 0 and 1, resolved in `export()`. The sites count only what
the host already holds (shapes, lengths, bytes of host arrays): nothing
synchronises or reads a device tensor to count. The copies to the host
that the program makes anyway (PIPS's windows, host prompts, the patch
filter) go through `to_host`, which counts each (`d2h_copies`,
`d2h_bytes`) where it makes it. How long the host waits for the device,
there and inside the layers, shows only in a profiler's trace.

Off, `span()` and `video()` return one shared null context after one
check of a module global, and `count()` returns at once.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Dict, List, Optional

from .logging import StageTimer

_timer: Optional[StageTimer] = None
_OFF = contextlib.nullcontext()


def enable() -> StageTimer:
    """Install a new recorder (replacing any) and return it."""
    global _timer
    _timer = StageTimer()
    return _timer


def disable() -> Optional[StageTimer]:
    """Remove the recorder; returns it (None if tracing was off)."""
    global _timer
    timer, _timer = _timer, None
    return timer


def enabled() -> bool:
    return _timer is not None


def span(name: str, *, video=None, device=None, **counts):
    """A context manager: the span `name` with its initial `counts`.
    `video` (the id of the video the work is for) and `device` (a
    `torch.device`) default to the enclosing span's; a root span without
    `video` takes the last video started."""
    if _timer is None:
        return _OFF
    return _timer.stage(name, video=video, device=device, **counts)


def video(video_id=None, device=None, **counts):
    """The root span `video` of one video's work on `device`: its id is
    `video_id`, or a running number where the video has none."""
    if _timer is None:
        return _OFF
    return _timer.stage("video", video=_timer.new_video(video_id),
                        device=device, **counts)


def count(name: str, n=1) -> None:
    """Add `n` to the counter `name` of the innermost open span."""
    if _timer is None:
        return
    _timer.count(name, n)


def to_host(x):
    """`x.cpu().numpy()`; a copy from a device counts one `d2h_copies` and
    its `d2h_bytes` in the innermost open span."""
    out = x.cpu().numpy()
    if _timer is not None and x.device.type != "cpu":
        _timer.count("d2h_copies")
        _timer.count("d2h_bytes", out.nbytes)
    return out


def current_video():
    """The id of the last video started (None when off or before one)."""
    return None if _timer is None else _timer.video


def export() -> List[Dict]:
    """The recorder's spans (`StageTimer.export`); [] when off."""
    return [] if _timer is None else _timer.export()


def write(path: str) -> List[Dict]:
    """The export as a Chrome trace-event JSON file at `path` (one
    complete event a closed span: `ts` and `dur` in microseconds on the
    profiler's clock, the video, the parent's index, the device time and
    the counts under `args`). Returns the export."""
    spans = export()
    pid, tid = os.getpid(), threading.get_native_id()
    events = [{"name": s["name"], "cat": "sam_pt", "ph": "X",
               "ts": s["start_ns"] / 1e3,
               "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
               "pid": pid, "tid": tid,
               "args": {"index": i, "video": s["video"],
                        "parent": s["parent"], "device_ms": s["device_ms"],
                        **s["counts"]}}
              for i, s in enumerate(spans) if s["end_ns"] is not None]
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                  default=str)
    return spans
