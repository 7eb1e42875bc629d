"""CUDA graphs of the CoTracker window model.

One window of `CoTrackerPointTracker._track`, `CoTracker.forward` with its
refinement iterations, is some 2,400 small kernels. Dispatched one by one,
the device waits on the host for most of the window. `WindowGraphs`
captures the call once per shape (`torch.cuda.CUDAGraph`) and replays it:
one launch a window.

Shapes are bucketed by track count, so that videos of other lengths and
object counts share a graph: the tracks are padded up to a multiple of
`TRACK_BUCKET` (16 tracks x 8 window frames = 128 GEMM rows). A padded
track is inactive, so the space attention gives it an exact zero weight
(`MHA`'s -1e30 logit), as it does the tracks not yet started; its track
mask, features and coordinates are 0 and its outputs are dropped. Time
attention, the correlation and the LayerNorms act per track, so the real
tracks get what the unpadded call gives them.

Off CUDA, the runner calls the model as it is. A graph reads the model's
parameters where they lay at its capture: a model moved or cast after its
first CUDA window needs a new runner.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from ....utils import tracing

TRACK_BUCKET = 16
MAX_GRAPHS = 8


def bucket_tracks(n: int) -> int:
    """The padded track count: `n` up to a multiple of TRACK_BUCKET (at
    least one bucket)."""
    return max(1, -(-n // TRACK_BUCKET)) * TRACK_BUCKET


class WindowInputs:
    """The window model's inputs at one padded shape: the feature window
    [S, H/4, W/4, C], `coords` [S, Np, 2], `feats` [Np, C], `track_mask`
    [S, Np], `vis` [S, Np] (the initial visibility logits) and `active`
    [Np]. The padding tail is zero (inactive); `fill` writes one window's
    real tracks into `[:, :N]`, and clears what a window of more tracks
    left behind them."""

    def __init__(self, fmaps, frames, coords_init, feats, track_mask,
                 vis_init, active, n_padded: int):
        s = frames.shape[0]
        self.fmaps = fmaps.new_zeros((s, *fmaps.shape[1:]))
        self.coords = coords_init.new_zeros((s, n_padded, 2))
        self.feats = feats.new_zeros((n_padded, feats.shape[-1]))
        self.track_mask = track_mask.new_zeros((s, n_padded))
        self.vis = vis_init.new_zeros((s, n_padded))
        self.active = active.new_zeros(n_padded)
        self.n = 0  # the tracks written so far

    def fill(self, fmaps, frames, coords_init, feats, track_mask, vis_init,
             active) -> None:
        """Copy one window's inputs in: the frames of `fmaps` that `frames`
        names (the gather the eager call makes) and the N real tracks."""
        n = coords_init.shape[1]
        if n < self.n:
            for tail in (self.coords[:, n:self.n], self.feats[n:self.n],
                         self.track_mask[:, n:self.n], self.vis[:, n:self.n],
                         self.active[n:self.n]):
                tail.zero_()
        self.n = n
        torch.index_select(fmaps, 0, frames, out=self.fmaps)
        self.coords[:, :n].copy_(coords_init)
        self.feats[:n].copy_(feats)
        self.track_mask[:, :n].copy_(track_mask)
        self.vis[:, :n].copy_(vis_init)
        self.active[:n].copy_(active)

    def run(self, model, iters: int):
        """`model` over these inputs: (coords, vis_logits, feats)."""
        return model(self.fmaps, self.coords, self.feats, self.track_mask,
                     iters=iters, vis_init=self.vis, active=self.active)


class _Graph:
    """One captured window: its static inputs and outputs."""

    def __init__(self, model, iters: int, inputs: WindowInputs):
        self.inputs = inputs
        self.graph = torch.cuda.CUDAGraph()
        # Warm up on the capture stream first (cuBLAS sets up its
        # workspace for a stream on first use, which a capture forbids).
        stream, current = torch.cuda.Stream(), torch.cuda.current_stream()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            inputs.run(model, iters)
            self.graph.capture_begin()
            try:
                self.coords, self.vis, _ = inputs.run(model, iters)
            finally:
                self.graph.capture_end()
        current.wait_stream(stream)


class WindowGraphs:
    """The window model's calls of one tracker: eager off CUDA, on CUDA
    the replay of a graph per (padded N, S, H/4, W/4, C, dtype, iters,
    device, model), the `MAX_GRAPHS` last used kept. `captures` and
    `replays` count what was done, as the tracer's `graph_captures` and
    `graph_replays` of the open span do."""

    def __init__(self):
        self._graphs: OrderedDict = OrderedDict()
        self.captures = 0
        self.replays = 0

    def __call__(self, model, fmaps, frames, coords_init, feats, track_mask,
                 vis_init, active, iters: int):
        """`model(fmaps[frames], coords_init, feats, track_mask,
        iters=iters, vis_init=vis_init, active=active)`'s coords [S, N, 2]
        and visibility logits [S, N]. On CUDA these are views of the
        graph's static outputs, good until its next replay: the caller
        reads them in stream order first."""
        if fmaps.device.type != "cuda":
            coords, vis, _ = model(fmaps[frames], coords_init, feats,
                                   track_mask, iters=iters,
                                   vis_init=vis_init, active=active)
            return coords, vis
        with torch.cuda.device(fmaps.device):
            return self._replay(model, fmaps, frames, coords_init, feats,
                                track_mask, vis_init, active, iters)

    def _replay(self, model, fmaps, frames, coords_init, feats, track_mask,
                vis_init, active, iters: int):
        n = coords_init.shape[1]
        n_padded = bucket_tracks(n)
        key = (n_padded, frames.shape[0], *fmaps.shape[1:], fmaps.dtype,
               iters, fmaps.device, model)
        graph = self._graphs.pop(key, None)
        inputs = graph.inputs if graph is not None else WindowInputs(
            fmaps, frames, coords_init, feats, track_mask, vis_init, active,
            n_padded)
        inputs.fill(fmaps, frames, coords_init, feats, track_mask, vis_init,
                    active)
        if graph is None:
            graph = _Graph(model, iters, inputs)
            self.captures += 1
            tracing.count("graph_captures")
        self._graphs[key] = graph  # the last used last
        if len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
        graph.graph.replay()
        self.replays += 1
        tracing.count("graph_replays")
        return graph.coords[:, :n], graph.vis[:, :n]
