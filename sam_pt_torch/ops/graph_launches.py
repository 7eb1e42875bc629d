"""Kernel launches inside a CUDA graph, counted as eager launches are.

A kernel's Python entry point is where its launch is counted (the
module's `LAUNCHES`, the tracer's counters) and where an observer wraps
the kernel to see each launch's shapes. A graph's replay runs the kernels
it captured without calling any entry point. So a graph runner records
the entry points' calls while it captures (`recording`) and, after every
replay, announces them again (`announce`): each is called through its
module, as an eager call reaches it, with tensors of the recorded shapes
on the `meta` device; the entry point sees the announcement
(`announced`), counts its launch and launches nothing.

The entry points that a captured region reaches take part: K1 and K2
(`flash_attention.py`) and K5 (`layer_norm.py`), the kernels of a SAM
encode chunk.
"""
from __future__ import annotations

import contextlib
import sys

import torch

_log = None  # the calls of the capture being recorded
_announcing = False


def _shape_of(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta")
    return x


def announced(module: str, name: str, *args, **kwargs) -> bool:
    """The first call of the kernel entry point `name` of `module`, with
    its own arguments: records the call while a capture is recorded, and
    says whether the call is a replay's announcement, which the entry
    point counts and does not launch."""
    if _log is not None:
        _log.append((module, name, tuple(map(_shape_of, args)),
                     {k: _shape_of(v) for k, v in kwargs.items()}))
    return _announcing


@contextlib.contextmanager
def recording():
    """The list of the entry-point calls made inside, for `announce`."""
    global _log
    outer, _log = _log, []
    try:
        yield _log
    finally:
        _log = outer


def announce(calls) -> None:
    """Announce `recording`'s calls once: each entry point is reached by
    its name in its module, so that a wrapper put there sees it."""
    global _announcing
    _announcing = True
    try:
        for module, name, args, kwargs in calls:
            getattr(sys.modules[module], name)(*args, **kwargs)
    finally:
        _announcing = False
