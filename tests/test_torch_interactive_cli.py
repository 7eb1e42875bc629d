"""The port's VOS CLI with `simulate_interactive_point_correction` and
with `input_only_one_gt_mask_point`, against the JAX CLI, float32 on the
CPU, over the JAX tests' synthetic DAVIS tree (one video of 4 JPEG frames,
two objects, every frame annotated).

Each side gets its own model on the same weights (`torch_port_helpers`:
the tiny SamPt pair, as `SamPtInteractive` for the interactive option).
The port's `evaluate` runs in a subprocess where scikit-learn,
matplotlib, jax, flax, the JAX package and PyYAML cannot be imported
(stub packages first on its path), its model unpickled there. The
one-point option draws its point from a generator that is not seeded, on
both sides; here both are given the same seeded one.

Checks: the written index masks equal on at least 99.9% of the video's
pixels and J&F within 1e-3 (as test_torch_vos_eval.py), the interaction
histories' decisions equal, one history a object.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from sam_pt_tpu.utils import query_points as j_query_points
from sam_pt_tpu.vos_eval import eval as j_eval
from test_vos_eval import fabricate_davis
from torch_port_helpers import tiny_interactive_pair, tiny_sam_pt_pair

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ["sklearn", "matplotlib", "jax", "flax", "sam_pt_tpu", "yaml"]
AGREEMENT = 0.999
JF_ATOL = 1e-3
DECISIONS = ("action", "type", "frame_idx", "point_idx", "interaction_idx",
             "current_iou_threshold")

PORT_RUN = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import sam_pt_torch.utils.query_points as query_points
from sam_pt_torch.vos_eval.eval import evaluate

kmedoid_points = query_points.extract_kmedoid_points


def seeded(mask, n, rng=None, **kw):
    return kmedoid_points(mask, n, rng=rng or np.random.default_rng(0), **kw)


query_points.extract_kmedoid_points = seeded
with open(sys.argv[1]) as f:
    cfg = json.load(f)
cfg["model"] = torch.load(sys.argv[2], weights_only=False)
results = evaluate(cfg)
blocked = [m for m in sys.modules if m.split(".")[0] in {blocked!r}]
with open(sys.argv[3], "w") as f:
    json.dump({{"jf": results["J&F-Mean"],
               "frames": results["total_frames"], "imported": blocked}}, f)
"""


def _cfg(model, root, out, **kw):
    cfg = {"seed": 72, "dataset": "D17", "split": "val", "size": -1,
           "longest_size": None, "d17_path": str(root), "output": str(out),
           "save_all": False, "masks_batch_size": 100, "max_videos": None,
           "max_frames": None, "vid_ids": None, "score": True,
           "visualize_results": False, "model": model}
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def davis(tmp_path_factory):
    root = tmp_path_factory.mktemp("davis")
    return root, fabricate_davis(str(root), n_videos=1, t=4)


def _run_port(model, cfg, tmp_path):
    stubs = tmp_path / "stubs"
    for name in BLOCKED:
        os.makedirs(stubs / name, exist_ok=True)
        (stubs / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked')\n")
    torch.save(model, tmp_path / "model.pt")
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump({k: v for k, v in cfg.items() if k != "model"}, f)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(stubs), ROOT]))
    proc = subprocess.run(
        [sys.executable, "-c", PORT_RUN.format(blocked=BLOCKED),
         str(tmp_path / "cfg.json"), str(tmp_path / "model.pt"),
         str(tmp_path / "result.json")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "result.json") as f:
        result = json.load(f)
    assert result["imported"] == []
    return result


def _agree(out_j, out_t, name):
    files = sorted(os.listdir(out_j / name))
    assert sorted(os.listdir(out_t / name)) == files and len(files) == 4
    same = np.mean([np.mean(np.array(Image.open(out_j / name / f))
                            == np.array(Image.open(out_t / name / f)))
                    for f in files])
    assert same >= AGREEMENT


def test_interactive_cli_matches_jax(davis, tmp_path):
    root, (name,) = davis
    jmodel, tmodel = tiny_interactive_pair(
        interactions_max=20, interactions_max_per_frame=2, online=True,
        online_interactive_iou_threshold=0.8)
    jmodel.output_root = str(tmp_path / "j_history")
    tmodel.output_root = str(tmp_path / "t_history")
    options = dict(simulate_interactive_point_correction=True)
    ref = j_eval.evaluate(_cfg(jmodel, root, tmp_path / "j", **options))
    got = _run_port(tmodel, _cfg(None, root, tmp_path / "t", **options),
                    tmp_path)
    assert got["frames"] == ref["total_frames"] == 4
    _agree(tmp_path / "j", tmp_path / "t", name)
    assert 0.0 <= got["jf"] <= 1.0
    assert got["jf"] == pytest.approx(ref["J&F-Mean"], abs=JF_ATOL)
    videos = sorted(os.listdir(tmp_path / "j_history"))
    assert videos == [f"000--{name}--mask-{i}" for i in range(2)]
    assert sorted(os.listdir(tmp_path / "t_history")) == videos
    for video in videos:
        histories = []
        for side in ("j_history", "t_history"):
            with open(tmp_path / side / video / "history.json") as f:
                histories.append([[e[k] for k in DECISIONS]
                                  for e in json.load(f)])
        assert histories[0] == histories[1] and histories[0]


def test_one_point_cli_matches_jax(davis, tmp_path, monkeypatch):
    root, (name,) = davis
    kmedoid_points = j_query_points.extract_kmedoid_points

    def seeded(mask, n, rng=None, **kw):
        return kmedoid_points(mask, n, rng=rng or np.random.default_rng(0),
                              **kw)

    monkeypatch.setattr(j_query_points, "extract_kmedoid_points", seeded)
    jmodel, tmodel = tiny_sam_pt_pair()
    options = dict(input_only_one_gt_mask_point=True)
    ref = j_eval.evaluate(_cfg(jmodel, root, tmp_path / "j", **options))
    got = _run_port(tmodel, _cfg(None, root, tmp_path / "t", **options),
                    tmp_path)
    assert got["frames"] == ref["total_frames"] == 4
    _agree(tmp_path / "j", tmp_path / "t", name)
    assert got["jf"] == pytest.approx(ref["J&F-Mean"], abs=JF_ATOL)


def test_interactive_command_composes_like_jax():
    """The reference's SAM-PT-interactive command (the JAX test's
    overrides, tests/test_config.py:230-246) with the port's target
    composes through `sam_pt_torch/config/` as through the JAX composer,
    and the model it names builds as a SamPtInteractive with those
    settings; `+model.sam_predictor.crop_pad_tokens=true` reaches SAM."""
    from sam_pt_torch.config import compose, instantiate
    from sam_pt_torch.config import resolve_interpolations
    from sam_pt_torch.models.sam_pt_interactive import SamPtInteractive
    from sam_pt_torch.vos_eval.eval import CONFIG_DIR

    overrides = [
        "model=sam_pt", "simulate_interactive_point_correction=true",
        "masks_batch_size=1", "vid_ids=[4,12]",
        "model._target_=sam_pt_torch.models.sam_pt_interactive."
        "SamPtInteractive",
        "model.iterative_refinement_iterations=0",
        "model.positive_points_per_mask=1",
        "model.negative_points_per_mask=0",
        "+model.interactions_max=300",
        "+model.interactions_max_per_frame=4", "+model.online=true",
        "+model.online_interactive_iou_threshold=0.95",
        "+model.sam_predictor.crop_pad_tokens=true", "device=cpu",
        "model.sam_predictor.allow_random_init=true",
        "model.point_tracker.allow_random_init=true"]
    cfg = resolve_interpolations(compose(CONFIG_DIR, "vos_eval_root",
                                         overrides))
    assert cfg["vid_ids"] == [4, 12] and cfg["model"]["online"] is True
    with pytest.warns(UserWarning, match="random"):
        model = instantiate(cfg["model"])
    assert type(model) is SamPtInteractive
    assert (model.online, model.interactions_max,
            model.interactions_max_per_frame,
            model.online_interactive_iou_threshold,
            model.positive_points_per_mask,
            model.iterative_refinement_iterations) == (True, 300, 4, 0.95,
                                                       1, 0)
    assert model.sam_predictor.model.crop_pad_tokens
    assert model.device.type == "cpu"
