"""The port's `SamPt` constructor and input contract against the JAX one's.

- Every key of `configs/model/sam_pt.yaml` (bar `defaults` and `_target_`)
  is a keyword of the port's `SamPt`, as of the JAX one; data parallelism
  raises until the multi-device layer is ported.
- `forward` takes frames as [T, H, W, 3] or [T, 3, H, W], as the JAX
  `forward` does: one tiny video given both ways gives identical outputs
  (the query-point sampler is reseeded between the two calls).
"""
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from torch_port_helpers import tiny_sam_pt_pair

torch.set_num_threads(1)

CONFIG = (Path(__file__).resolve().parents[1] / "configs" / "model"
          / "sam_pt.yaml")


@pytest.fixture(scope="module")
def port_sam_pt():
    return tiny_sam_pt_pair()[1]


def _config_keys():
    cfg = yaml.safe_load(CONFIG.read_text())
    cfg.pop("defaults")
    cfg.pop("_target_")
    return cfg


def test_sam_pt_from_model_config(port_sam_pt):
    from sam_pt_torch.models.sam_pt import SamPt

    cfg = _config_keys()
    assert {"patch_size", "patch_similarity_threshold",
            "data_parallel"} <= set(cfg)
    sam_pt = SamPt(port_sam_pt.point_tracker, port_sam_pt.sam_predictor,
                   **cfg)
    for key, value in cfg.items():
        assert getattr(sam_pt, key) == value, key
    assert sam_pt.upload_chunk is None


@pytest.mark.parametrize("parallel", [dict(data_parallel=True),
                                      dict(mesh=object())])
def test_data_parallel_raises(port_sam_pt, parallel):
    from sam_pt_torch.models.sam_pt import SamPt

    with pytest.raises(NotImplementedError):
        SamPt(port_sam_pt.point_tracker, port_sam_pt.sam_predictor,
              **parallel)


def test_nchw_frames_match_nhwc(port_sam_pt):
    rng = np.random.default_rng(21)
    t, h, w = 5, 48, 64
    masks = np.zeros((1, h, w), np.float32)
    masks[0, 12:30, 10:40] = 1
    video = {"image": rng.integers(0, 255, (t, h, w, 3)).astype(np.uint8),
             "target_hw": (h, w), "query_masks": masks,
             "query_point_timestep": np.zeros(1, np.float32)}
    outs = []
    for image in (video["image"], video["image"].transpose(0, 3, 1, 2)):
        port_sam_pt.rng = np.random.default_rng(72)
        outs.append(port_sam_pt.forward(dict(video, image=image)))
    nhwc, nchw = outs
    assert nchw["logits"].shape == (1, t, h, w)
    for key, value in nhwc.items():
        assert torch.equal(nchw[key], value), key
