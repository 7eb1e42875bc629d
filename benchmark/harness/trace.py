"""What the traced run reads: spans around the program's layers (the
benchmark's own wrappers, each call between two synchronisations, so a
span's seconds are that layer's alone), the shapes of every kernel launch
(wrapping the kernels' entry points), and the reduction of a
`torch.profiler` trace to device busy time, kernel time by name, and the
idle gaps by the span the host was in.

The spans serialise the host and the device, which the untraced window
overlaps: they give each layer's cost, not the window's time.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch


class Spans:
    """Seconds of wrapped methods' calls; `wrap(owner, name, label)`
    replaces `owner.name` until `restore()`. With `sync` (a function that
    waits for the device), each call is timed between two calls of it;
    without, only a profiler range named `span:<label>` is opened around
    the call."""

    def __init__(self, sync=None):
        self.sync = sync
        self.seconds = defaultdict(float)
        self._saved = []

    def wrap(self, owner, name: str, label: str) -> None:
        fn = getattr(owner, name)
        self._saved.append((owner, name, vars(owner).get(name)))

        def call(*args, **kwargs):
            if self.sync is None:
                with torch.profiler.record_function("span:" + label):
                    return fn(*args, **kwargs)
            self.sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.sync()
            self.seconds[label] += time.perf_counter() - t0
            return out

        setattr(owner, name, call)

    def restore(self) -> None:
        for owner, name, old in reversed(self._saved):
            if old is None:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
        self._saved = []


class Launches:
    """The shapes of every launch of the wrapped kernel entry points, by
    kind: K1 (`window`) and K2 (`global`) take qkv [B, N, 3HD], K3
    (`cross`) q [B, nq, Hd] against k [B, nk, Hd] and an optional uint8
    key mask, kept (unreduced, so no synchronisation) until `shapes()`."""

    def __init__(self, module, kinds: dict):
        self.module = module
        self.kinds = kinds
        self.records = defaultdict(list)
        self._saved = {}

    def __enter__(self):
        for kind, name in self.kinds.items():
            fn = getattr(self.module, name)
            self._saved[name] = fn
            setattr(self.module, name, self._recorder(kind, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.module, name, fn)
        self._saved = {}

    def _recorder(self, kind, fn):
        def call(*args, **kwargs):
            if kind == "cross":
                q, k = args[0], args[1]
                mask = kwargs.get("kv_valid")
                self.records[kind].append(
                    (q.shape[0], q.shape[1], k.shape[1], kwargs["heads"],
                     q.shape[2] // kwargs["heads"], mask))
            else:
                qkv = args[0]
                heads = kwargs["heads"]
                d = qkv.shape[2] // (3 * heads)
                grid = ((kwargs["kh"], kwargs["kw"]) if kind == "global"
                        else (qkv.shape[1],))
                self.records[kind].append((qkv.shape[0], *grid, heads, d))
            return fn(*args, **kwargs)

        return call

    def shapes(self) -> dict:
        """{kind: [launch tuples]}, K3's key mask reduced to its count of
        valid keys over the batch (None without a mask)."""
        out = {}
        for kind, recs in self.records.items():
            if kind == "cross":
                out[kind] = [r[:5] + ((None if r[5] is None
                                       else int(r[5].sum())),) for r in recs]
            else:
                out[kind] = list(recs)
        return out


def _union(intervals) -> float:
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def _ns(e):
    """(start, end) of a raw profiler event in ns."""
    if hasattr(e, "start_ns"):
        start = e.start_ns()
        return start, start + e.duration_ns()
    start = e.start_us() * 1000
    return start, start + e.duration_us() * 1000


def reduce_profile(prof, label: str) -> dict:
    """Over the host range `span:<label>` of a finished `torch.profiler`
    run: device busy seconds (the union of the device's kernel, copy and
    set intervals; the device-side copies of the `span:` ranges are not
    work), device seconds by kernel name, and the gaps between device work
    summed by the span the host was in at each gap's start. Reads the
    profiler's raw events (no per-event Python objects)."""
    cuda = torch.autograd.DeviceType.CUDA
    device, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if not name.startswith("span:"):
                device.append((*_ns(e), name))
        elif name.startswith("span:"):
            if name == "span:" + label:
                window = _ns(e)
            else:
                spans.append((*_ns(e), name[5:]))
    lo, hi = window
    device = sorted(d for d in device if d[1] > lo and d[0] < hi)
    by_name = defaultdict(float)
    for a, b, name in device:
        by_name[name] += (b - a) * 1e-9
    busy = _union([(max(a, lo), min(b, hi)) for a, b, _ in device]) * 1e-9
    gaps, end = [], lo
    for a, b, _ in device:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    spans.sort()  # the layers' spans do not overlap
    starts = [s[0] for s in spans]
    gap_by_span = defaultdict(float)
    for a, b in gaps:
        i = bisect.bisect_right(starts, a) - 1
        name = spans[i][2] if i >= 0 and a < spans[i][1] else "harness"
        gap_by_span[name] += (b - a) * 1e-9
    return {"busy_s": busy, "window_s": (hi - lo) * 1e-9,
            "by_name": dict(by_name), "gaps": dict(gap_by_span),
            "ops": len(device)}
