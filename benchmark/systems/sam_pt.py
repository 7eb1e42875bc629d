"""The system under test for SAM-PT configurations: the port's `SamPt`
built from a configuration file and the benchmark's state dicts, and the
VOS harness's per-video calls (`sam_pt_torch/vos_eval/eval.py`'s timed
region: the forward over every object, device fusion with a deferred
download, the previous video's masks resolved).

Everything the benchmark takes from the program goes through this file.
"""
from __future__ import annotations

import torch

# The SamPt methods whose calls the traced run's spans time, by the layer
# name the per-layer metrics read.
SPANS = {
    "query": "extract_query_points",
    "encode": "_encode_all_frames",
    "track": "_track_points_device",
    "decode": "_apply_sam_device",
}
# The kernel entry points whose launches the traced run records, by the
# launch counter's name (`ops/flash_attention.py::LAUNCHES`).
KERNELS = {"window": "window_attention_cuda",
           "global": "global_attention_cuda",
           "cross": "cross_attention_cuda"}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def kernel_module():
    from sam_pt_torch.ops import flash_attention

    return flash_attention


def load_kernels() -> dict:
    """Build (on a checkout's first run) or load the port's CUDA kernels."""
    from sam_pt_torch.ops import _cuda

    _cuda.library()
    return {"built": bool(_cuda.BUILD_INFO.get("built")),
            "seconds": float(_cuda.BUILD_INFO.get("seconds", 0.0))}


def _on_meta(make):
    with torch.device("meta"):
        return make()


def build_sam(config: dict, weights: dict):
    """The predictor of the configuration's SAM, holding `weights["sam"]`
    as it is."""
    from sam_pt_torch.models.sam.predictor import SamPredictor
    from sam_pt_torch.models.sam.sam_model import Sam

    sam_cfg = config["sam"]
    encoder = {k: sam_cfg[k] for k in ("embed_dim", "depth", "num_heads",
                                       "global_attn_indexes", "window_size",
                                       "mlp_ratio", "patch_size")}
    sam_model = _on_meta(lambda: Sam(encoder, image_size=sam_cfg["image_size"]))
    sam_model.load_state_dict(weights["sam"], strict=True, assign=True)
    sam_model.to(DTYPES[sam_cfg["dtype"]]).eval().requires_grad_(False)
    return SamPredictor(sam_model)


def build_tracker(config: dict, weights: dict, device: torch.device):
    """The configuration's point tracker, holding `weights["tracker"]` as
    it is."""
    tr = config["tracker"]
    if tr["name"] == "cotracker":
        from sam_pt_torch.models.tracker.cotracker.model import CoTracker
        from sam_pt_torch.models.tracker.cotracker.tracker import (
            CoTrackerPointTracker)

        model = _on_meta(lambda: CoTracker(s=tr["s"], stride=tr["stride"]))
        model.load_state_dict(weights["tracker"], strict=True, assign=True)
        model.to(DTYPES[tr["dtype"]]).eval().requires_grad_(False)
        return CoTrackerPointTracker(
            interp_shape=tuple(tr["interp_shape"]),
            visibility_threshold=tr["visibility_threshold"],
            support_grid_size=tr["support_grid_size"],
            support_grid_every_n_frames=tr["support_grid_every_n_frames"],
            iters=tr["iters"], model=model)
    if tr["name"] == "pips":
        from sam_pt_torch.models.tracker.pips.tracker import PipsPointTracker

        # The tracker builds its own model; the checkpoint then replaces
        # its weights, as a public checkpoint would.
        tracker = PipsPointTracker(
            stride=tr["stride"], s=tr["s"], iters=tr["iters"],
            initial_next_frame_visibility_threshold=tr[
                "initial_next_frame_visibility_threshold"],
            encode_chunk=tr["encode_chunk"], dtype=DTYPES[tr["dtype"]],
            allow_random_init=True, device=device)
        tracker.model.load_state_dict(weights["tracker"], strict=True)
        return tracker
    raise ValueError(f"no SAM-PT tracker {tr['name']!r}")


def assemble(config: dict, predictor, tracker, device: torch.device):
    """SamPt over `predictor` and `tracker` with the configuration's
    settings, checked to be on `device`."""
    from sam_pt_torch.models.sam_pt import SamPt

    sam_pt = SamPt(point_tracker=tracker, sam_predictor=predictor,
                   **config["sam_pt"])
    if sam_pt.device != device:
        raise RuntimeError(f"SamPt is on {sam_pt.device}, not {device}")
    return sam_pt


def build(config: dict, weights: dict, device: torch.device):
    """SamPt with the configuration's SAM and tracker, holding `weights`
    ({"sam": state dict, "tracker": state dict}) as they are. A system
    file for another SAM or tracker imports this one and replaces
    `build_sam` or `build_tracker` in its own `build`."""
    return assemble(config, build_sam(config, weights),
                    build_tracker(config, weights, device), device)


def launch_counts() -> dict:
    return dict(kernel_module().LAUNCHES)


def reset_launch_counts() -> None:
    kernel_module().reset_launch_counts()


class Harness:
    """The VOS harness's per-video work on one SamPt, as its timed region
    does it: `process` runs the forward and dispatches fusion with the
    download deferred, and resolves the previous video's masks."""

    def __init__(self, sam_pt):
        from sam_pt_torch.vos_eval.eval import device_fuse_index_masks
        from sam_pt_torch.vos_eval.evaluator import SamPtEvaluator

        self.sam_pt = sam_pt
        self.evaluator = SamPtEvaluator(cfg={}, model=sam_pt)
        self.fuse = device_fuse_index_masks
        self.pending = None

    def process(self, video: dict, keep=None):
        """One video: returns the previous video's masks (None for the
        first). `keep`, if given, receives the forward's outputs and the
        pending masks of this video."""
        outputs = self.evaluator.evaluate_video(video)
        pending = self.fuse(outputs["logits"], video["query_masks"],
                            [int(t) for t in video["query_point_timestep"]],
                            defer=True)
        previous = self.resolve()
        self.pending = pending
        if keep is not None:
            keep(outputs, pending)
        return previous

    def resolve(self):
        """The pending video's index masks [T, H, W] uint8, or None."""
        if self.pending is None:
            return None
        masks = self.pending.get()
        self.pending = None
        return masks
