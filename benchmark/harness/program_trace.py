"""The reduction of a `torch.profiler` run by the program's own spans: the
`sam_pt:<name>` ranges the port's tracer opens while it is on
(`sam_pt_torch/utils/tracing.py`). Each idle gap of the device, and each
host call of a `cuda*` or `cu*` entry point, is given to the innermost
program span the host was in when it began; the harness's
method-level `span:` ranges play no part.

`reading` is the arithmetic of the per-layer readers that take these
results from a `Record`'s `program` (the tracer's export of the profiled
pass) and `program_profile` (`reduce_program`'s result over it):
`benchmark/metrics/track_idle_ms_per_frame.py` and its four siblings.

Not wired into the traced run yet: a later change of `harness/main.py`
would turn the program's tracer on for the profiled pass and set those
two fields; until then the readers read nothing.
"""
from __future__ import annotations

from collections import defaultdict

import torch

from .trace import _ns

PREFIX = "sam_pt:"
OUTSIDE = "harness"  # a moment in no program span


def is_launch(name: str) -> bool:
    """A host call that puts work on the device: a kernel launch, an
    asynchronous copy or a memset (`cuda*` and `cu*` entry points)."""
    return ("LaunchKernel" in name
            or (("Memcpy" in name or "Memset" in name) and "Async" in name))


def is_wait(name: str) -> bool:
    """A host call that waits for the device."""
    return "Synchronize" in name


def read_profile(prof, label: str) -> dict:
    """The raw events of a finished profiler run over the host range
    `span:<label>`, as plain tuples: `window` (start, end) and, each a
    list of (start, end, name), the program's `spans` (prefix dropped),
    the host's launch and wait `calls`, and the `device`'s work."""
    cuda = torch.autograd.DeviceType.CUDA
    window, spans, calls, device = None, [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if not name.startswith(("span:", PREFIX)):
                device.append((*_ns(e), name))
        elif name.startswith(PREFIX):
            spans.append((*_ns(e), name[len(PREFIX):]))
        elif name == "span:" + label:
            window = _ns(e)
        elif is_launch(name) or is_wait(name):
            calls.append((*_ns(e), name))
    return {"window": window, "spans": spans, "calls": calls,
            "device": device}


def innermost(spans, points) -> list:
    """The name of the innermost of `spans` ((start, end, name), nested as
    one thread's calls are) open at each of the ascending `points`, or
    OUTSIDE. A span holds [start, end)."""
    # a parent before the children that start with it
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for x in points:
        while i < len(spans) and spans[i][0] <= x:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= x:
            stack.pop()
        out.append(stack[-1][2] if stack else OUTSIDE)
    return out


def reduce_program(window, spans, calls, device) -> dict:
    """Over `window` (start, end): the device's idle seconds, gap by gap
    between the union of its work's intervals (as `reduce_profile` cuts
    them), by the innermost program span the host was in at the gap's
    start (`gaps`); the host's launch calls (`launches`) and waiting calls
    (`waits`) by the innermost span at their start. Every argument is in
    ns; `spans`, `calls` and `device` are lists of (start, end, name)."""
    lo, hi = window
    work = sorted((a, b) for a, b, _ in device if b > lo and a < hi)
    gaps, end = [], lo
    for a, b in work:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    gap_by_span = defaultdict(float)
    for (a, b), name in zip(gaps, innermost(spans, [a for a, _ in gaps])):
        gap_by_span[name] += (b - a) * 1e-9
    calls = sorted(c for c in calls if lo <= c[0] < hi)
    launches, waits = defaultdict(int), defaultdict(int)
    for (_, _, call), name in zip(calls,
                                  innermost(spans, [c[0] for c in calls])):
        if is_launch(call):
            launches[name] += 1
        else:
            waits[name] += 1
    return {"gaps": dict(gap_by_span), "launches": dict(launches),
            "waits": dict(waits)}


# the program's span that counts each denominator
UNITS = {"frames": "video", "pairs": "video", "passes": "decode.chunk"}


def under(values: dict, layer: str) -> float:
    """The sum of `values` (by span name) of the span `layer` and of its
    children, which the program names `<layer>.<part>`."""
    return sum(v for k, v in values.items()
               if k == layer or k.startswith(layer + "."))


def reading(record, kind: str, layer: str, unit: str):
    """`kind` ("gaps" in seconds, or "launches") given to `layer` and its
    children, over the `unit` the program counted in the same pass
    (frames or pairs of its `video` spans, or the decoder passes of its
    `decode.chunk` spans); None where the record has no program readings
    or the pass counted none of `unit`."""
    program = getattr(record, "program", None)
    reduced = getattr(record, "program_profile", None)
    if not program or reduced is None:
        return None
    total = sum(s["counts"].get(unit, 0) for s in program
                if s["name"] == UNITS[unit])
    if not total:
        return None
    return under(reduced[kind], layer) / total
