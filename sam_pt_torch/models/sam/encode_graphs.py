"""CUDA graphs of the SAM encoder's chunk.

One chunk of `SamPt._encode_all_frames` (the uint8 frames resized,
normalised and padded, the patch embedding, every ViT block and the neck)
is some 650 kernels at ViT-H. Dispatched one by one, the host is busy
until the chunk has nearly run, and the video's host work after the
encoder (k-medoids query sampling) starts with the device drained.
`EncodeGraphs` captures the chunk once per shape (`torch.cuda.CUDAGraph`)
and replays it: one launch a chunk, and the host moves on while the
device encodes.

A capture takes no synchronisation: the chunk's constants (the rel-pos
index, the window pad mask, the pixel mean and std, the resize bands) are
device tensors built once per shape and cached, and the eager warm-up
before the capture builds them. The kernels' launch counters and the
tracer's counters are left as they were by the warm-up and the capture;
each replay announces the capture's launches (`ops/graph_launches.py`),
so that they count as the eager chunk's do.

Off CUDA, the runner calls the chunk as it is. A graph reads the model's
parameters where they lay at its capture: a model moved or cast after its
first CUDA chunk needs a new runner.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from ...ops import flash_attention, graph_launches, layer_norm
from ...utils import tracing

MAX_GRAPHS = 4
# The kernel launch counters a warm-up and a capture leave as they were.
_COUNTERS = (flash_attention.LAUNCHES, layer_norm.LAUNCHES)


def _launches() -> int:
    return sum(sum(c.values()) for c in _COUNTERS)


class _Graph:
    """One captured chunk: its static input, its outputs (a tensor or a
    dict of tensors) and the kernel entry-point calls it made."""

    def __init__(self, fn, images: torch.Tensor):
        self.input = images.clone()
        self.graph = torch.cuda.CUDAGraph()
        saved = [dict(c) for c in _COUNTERS]
        # Warm up on the capture stream first: cuBLAS sets up its
        # workspace for a stream on first use and the chunk's constants are
        # uploaded, both of which a capture forbids.
        stream, current = torch.cuda.Stream(), torch.cuda.current_stream()
        stream.wait_stream(current)
        with tracing.paused(), torch.cuda.stream(stream):
            fn(self.input)
            before = _launches()
            with graph_launches.recording() as self.launches:
                self.graph.capture_begin()
                try:
                    self.output = fn(self.input)
                finally:
                    self.graph.capture_end()
            made = _launches() - before
        current.wait_stream(stream)
        for counter, old in zip(_COUNTERS, saved):
            counter.update(old)
        if made != len(self.launches):
            raise RuntimeError(
                f"the encode chunk launched {made} counted kernels, of which "
                f"{len(self.launches)} announce their replays")


class EncodeGraphs:
    """The encode chunks of one video path: eager off CUDA, on CUDA the
    replay of a graph per (the caller's key, input shape, dtype and
    device), the `MAX_GRAPHS` last used kept. `captures` and `replays`
    count what was done, as the tracer's `graph_captures` and
    `graph_replays` of the open span do."""

    def __init__(self):
        self._graphs: OrderedDict = OrderedDict()
        self.captures = 0
        self.replays = 0

    def __call__(self, fn, images: torch.Tensor, key):
        """`fn(images)`, a tensor or a dict of tensors. `key` names what
        else `fn` depends on (the model, its settings, the frames' size).
        On CUDA the results are the graph's static outputs, good until its
        next replay: the caller copies them out first, in stream order."""
        if images.device.type != "cuda":
            return fn(images)
        key = (key, tuple(images.shape), images.dtype, images.device)
        with torch.cuda.device(images.device):
            graph = self._graphs.pop(key, None)
            if graph is None:
                graph = _Graph(fn, images)
                self.captures += 1
                tracing.count("graph_captures")
            else:
                graph.input.copy_(images)
            self._graphs[key] = graph  # the last used last
            if len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
            graph.graph.replay()
        graph_launches.announce(graph.launches)
        self.replays += 1
        tracing.count("graph_replays")
        return graph.output
