"""The system under test for HQ-SAM configurations: `sam_pt.py`'s, with
SAM built with HQ-SAM's decoder (`Sam(use_hq=True)`), whose embeddings are
{'emb', 'interm'} dicts, and the traced run's span around the step that
computes the decoder's image-level features once a frame.
"""
from __future__ import annotations

from benchmark.systems import sam_pt
from benchmark.systems.sam_pt import (  # noqa: F401
    DTYPES, KERNELS, Harness, assemble, build_tracker, kernel_module,
    launch_counts, load_kernels, reset_launch_counts)


def _spans() -> dict:
    """`sam_pt.py`'s spans, and `hq` where the program has the step (a
    program that computes the features inside each decoder pass has no
    such method, and its traced run reads no `hq_ms_per_frame`)."""
    from sam_pt_torch.models.sam_pt import SamPt

    spans = dict(sam_pt.SPANS)
    if hasattr(SamPt, "_hq_features_device"):
        spans["hq"] = "_hq_features_device"
    return spans


SPANS = _spans()


def build_sam(config: dict, weights: dict):
    """The predictor of the configuration's HQ-SAM, holding
    `weights["sam"]` as it is."""
    from sam_pt_torch.models.sam.predictor import SamPredictor
    from sam_pt_torch.models.sam.sam_model import Sam

    sam_cfg = config["sam"]
    encoder = {k: sam_cfg[k] for k in ("embed_dim", "depth", "num_heads",
                                       "global_attn_indexes", "window_size",
                                       "mlp_ratio", "patch_size")}
    sam_model = sam_pt._on_meta(lambda: Sam(
        encoder, image_size=sam_cfg["image_size"], use_hq=True,
        hq_token_only=sam_cfg["hq_token_only"]))
    sam_model.load_state_dict(weights["sam"], strict=True, assign=True)
    sam_model.to(DTYPES[sam_cfg["dtype"]]).eval().requires_grad_(False)
    return SamPredictor(sam_model)


def build(config: dict, weights: dict, device):
    """SamPt with the configuration's HQ-SAM and tracker, holding
    `weights` as they are."""
    return assemble(config, build_sam(config, weights),
                    build_tracker(config, weights, device), device)
