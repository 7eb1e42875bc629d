"""The port's VIS path (`sam_pt_torch/vis_eval/`) against the JAX
package's, float32 on the CPU, on the tiny SamPt pair of
`tests/torch_port_helpers.py::tiny_sam_pt_pair` (tiny SAM + tiny
CoTracker, the same random weights on both sides) and the generator
settings of `test_torch_auto_mask_generator.py`.

- `SamBasedVisToVosAdapter` over a 3-frame video: the same proposals, the
  same tracks (masks equal except at pixels whose logit lies within 1e-4
  of 0; scores within 1e-4; trajectories within 1e-3 px), device logits
  left on the device.
- `evaluate` over a tiny synthetic UVO-format tree of PNG frames
  (registered with `register_dataset`): `results.json` and the 12 AP/AR
  stats equal JAX's.
- `python -m sam_pt_torch.vis_eval.eval` on the CPU with the tiny models
  from the port's configs, with jax, the JAX package, scikit-learn,
  Pillow and PyYAML blocked: it exits 0, writes and scores the results.
- The composed port config builds one predictor shared by the generator
  and SamPt.
- `eval_sharding` is the identity in one process (worlds of several
  processes: tests/test_torch_parallel.py); `evaluate` in a gloo world
  of 2 CPU ranks gives each rank its strided slice of the videos, and
  rank 0 alone writes `results.json` and scores: its records are, video
  for video, those of one process evaluating that video from a fresh
  start.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sam_pt_tpu.vis_eval.datasets as jdatasets
from sam_pt_torch.config import compose, instantiate, resolve_interpolations
from sam_pt_torch.models.sam import auto_mask_generator as tamg
from sam_pt_torch.vis_eval import datasets as tdatasets
from sam_pt_torch.vis_eval.adapter import SamBasedVisToVosAdapter as TAdapter
from sam_pt_torch.vis_eval.eval import CONFIG_DIR
from sam_pt_torch.vis_eval.eval import evaluate as tevaluate
from sam_pt_torch.vis_eval.rle import decode_mask, encode_mask
from sam_pt_torch.vos_eval.data.image_io import write_png
from sam_pt_tpu.models.sam import auto_mask_generator as jamg
from sam_pt_tpu.vis_eval.adapter import SamBasedVisToVosAdapter as JAdapter
from sam_pt_tpu.vis_eval.eval import evaluate as jevaluate
from torch_port_helpers import smooth_video, tiny_sam_pt_pair

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, H, W = 3, 48, 64
GEN = dict(points_per_side=8, points_per_batch=24, pred_iou_thresh=-0.3,
           stability_score_thresh=0.2, box_nms_thresh=0.99)
LOGIT_BAND = 1e-4
STATS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR@1", "AR@10",
         "AR@100", "ARs", "ARm", "ARl")


def _adapters(**kw):
    jsampt, tsampt = tiny_sam_pt_pair()
    settings = dict(max_num_masks=4, masks_batch_size=2, **kw)
    return (JAdapter(jsampt, jamg.SamAutomaticMaskGenerator(
                jsampt.sam_predictor, **GEN), **settings),
            TAdapter(tsampt, tamg.SamAutomaticMaskGenerator(
                tsampt.sam_predictor, **GEN), **settings))


def _video(seed=16):
    return {"video_id": 1, "image": smooth_video(T, H, W, seed=seed),
            "height": H, "width": W}


def _assert_masks_equal(got, want, want_logits):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == bool
    differ = got != want
    if differ.any():
        assert np.abs(np.asarray(want_logits, np.float32)[differ]).max() \
            < LOGIT_BAND


def test_adapter_equals_jax():
    jadapter, tadapter = _adapters()
    video = _video()
    want = jadapter([video])
    got = tadapter([video])
    n = len(want["pred_masks"])
    assert 2 <= n <= 4 and len(got["pred_masks"]) == n
    assert got["image_size"] == want["image_size"] == (H, W)
    assert got["pred_labels"] == want["pred_labels"] == [0] * n
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"],
                               rtol=0, atol=1e-4)
    for g, w, wl in zip(got["pred_masks"], want["pred_masks"],
                        want["pred_logits"]):
        assert g.shape == (T, H, W)
        _assert_masks_equal(g, w, wl)
    np.testing.assert_allclose(got["trajectories"], want["trajectories"],
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got["visibilities"], want["visibilities"])
    # The logits stay on the model's device, float16, not downloaded.
    assert all(isinstance(x, torch.Tensor) and x.dtype == torch.float16
               for x in got["pred_logits"])
    for g, gl in zip(got["pred_masks"], got["pred_logits"]):
        np.testing.assert_array_equal(g, gl.numpy() > 0)


def _write_tree(root, n_videos=2, tracks=None):
    """A UVO-format tree: PNG frames and a class-agnostic YTVIS JSON whose
    ground-truth tracks are RLE: one moving box a video, or the bool
    tracks [T, H, W] of `tracks` (one a video)."""
    videos, anns = [], []
    for v in range(n_videos):
        frames = smooth_video(T, H, W, seed=16 + v)
        os.makedirs(root / "frames" / f"v{v}")
        names = []
        for t in range(T):
            names.append(f"v{v}/{t:05d}.png")
            write_png(str(root / "frames" / names[-1]), frames[t])
        segs = []
        for t in range(T):
            m = np.zeros((H, W), bool)
            m[8 + 2 * t:30 + 2 * t, 10 + 4 * v:40 + 4 * v] = True
            if tracks is not None:
                m = tracks[v][t]
            segs.append(encode_mask(m))
        videos.append({"id": v + 1, "height": H, "width": W, "length": T,
                       "file_names": names})
        anns.append({"id": v + 1, "video_id": v + 1, "category_id": 1,
                     "segmentations": segs, "iscrowd": 0})
    gt = {"videos": videos, "annotations": anns,
          "categories": [{"id": 1, "name": "object"}]}
    with open(root / "gt.json", "w") as f:
        json.dump(gt, f)
    return gt


def test_evaluate_equals_jax(tmp_path):
    # The ground truth of the first video is a track the model finds (a
    # port adapter of its own), so that the stats are not all 0.
    _, gt_adapter = _adapters()
    found = gt_adapter([_video(16)])["pred_masks"][0]
    _write_tree(tmp_path, tracks=[found, found[:, ::-1, ::-1]])
    args = (str(tmp_path / "gt.json"), str(tmp_path / "frames"), True)
    jdatasets.register_dataset("synthetic_uvo", *args)
    tdatasets.register_dataset("synthetic_uvo", *args)
    jadapter, tadapter = _adapters()
    results = {}
    for side, adapter, evaluate in (("jax", jadapter, jevaluate),
                                    ("port", tadapter, tevaluate)):
        cfg = {"seed": 72, "dataset": "synthetic_uvo",
               "output": str(tmp_path / side), "score": True,
               "max_videos": None, "model": adapter}
        results[side] = evaluate(cfg)
    got, want = results["port"], results["jax"]
    assert got["n_records"] == want["n_records"] >= 4
    for k in STATS:
        assert got[k] == want[k], k
    assert any(got[k] > 0 for k in STATS)
    with open(tmp_path / "port" / "results.json") as f:
        got_records = json.load(f)
    with open(tmp_path / "jax" / "results.json") as f:
        want_records = json.load(f)
    assert len(got_records) == len(want_records)
    for g, w in zip(got_records, want_records):
        assert (g["video_id"], g["category_id"]) == (w["video_id"],
                                                     w["category_id"])
        assert abs(g["score"] - w["score"]) < 1e-4
        assert g["segmentations"] == w["segmentations"]
        for seg in g["segmentations"]:
            assert seg is None or decode_mask(seg).shape == (H, W)


BLOCKED = ["jax", "flax", "sam_pt_tpu", "sklearn", "PIL", "yaml"]


def test_cli_runs_without_jax_sklearn_pillow_or_yaml(tmp_path):
    """`python -m sam_pt_torch.vis_eval.eval device=cpu` over the tree as
    `uvo_v1_val_tiny` under `data_root`, with the tiny models of the
    port's configs and every module of BLOCKED raising ImportError."""
    stubs = tmp_path / "stubs"
    for name in BLOCKED:
        os.makedirs(stubs / name)
        (stubs / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked')\n")
    tree = tmp_path / "data"
    os.makedirs(tree / "UVOv1.0" / "VideoDenseSet")
    _write_tree(tree)
    os.replace(tree / "gt.json", tree / "UVOv1.0" / "VideoDenseSet" /
               "UVO_video_val_dense_tiny.json")
    os.replace(tree / "frames", tree / "UVOv1.0" / "uvo_videos_dense_frames")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(stubs), ROOT]))
    proc = subprocess.run(
        [sys.executable, "-m", "sam_pt_torch.vis_eval.eval", "device=cpu",
         "dataset=uvo_v1_val_tiny", f"data_root={tree}",
         f"output={tmp_path / 'out'}", "model/sam@sam_shared=sam_tiny_test",
         "model@vos_model=sam_pt_tiny_test",
         "model.sam_generator.points_per_side=4",
         "model.sam_generator.pred_iou_thresh=-1000.0",
         "model.sam_generator.stability_score_thresh=0.0"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Model on cpu" in proc.stdout and "FPS: " in proc.stdout
    assert "'AR@100'" in proc.stdout
    with open(tmp_path / "out" / "results.json") as f:
        records = json.load(f)
    assert {r["video_id"] for r in records} == {1, 2}
    proc = subprocess.run([sys.executable, "-c", "import PIL"],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode != 0 and "blocked" in proc.stderr


@pytest.mark.parametrize("name", ["vis_eval_root", "vis_eval_sam_pt"])
def test_composed_config_shares_one_predictor(name):
    cfg = resolve_interpolations(compose(CONFIG_DIR, name, [
        "device=cpu", "model/sam@sam_shared=sam_tiny_test",
        "model@vos_model=sam_pt_tiny_test"]), runtime_cwd=ROOT)
    adapter = instantiate(cfg["model"])
    assert isinstance(adapter, TAdapter)
    assert adapter.sam_generator.predictor is adapter.model.sam_predictor
    assert adapter.model.device == torch.device("cpu")
    batch = 100 if name == "vis_eval_sam_pt" else 5
    assert adapter.model.point_tracker_mask_batch_size == batch
    # The full-size config: SAM ViT-H on the card, one node for both.
    full = resolve_interpolations(compose(CONFIG_DIR, name),
                                  runtime_cwd=ROOT)
    assert full["device"] == "cuda"
    assert full["model"]["_target_"].startswith("sam_pt_torch.")
    generator = full["model"]["sam_generator"]
    assert generator["_target_"].startswith("sam_pt_torch.")
    assert generator["model"] == full["vos_model"]["sam_predictor"]
    assert generator["model"]["variant"] == "vit_h"
    assert generator["model"]["_shared_"] == "sam_predictor"
    assert (generator["points_per_side"], generator["points_per_batch"],
            generator["pred_iou_thresh"], generator["crop_n_layers"]) == (
                32, 64, 0.88, 0)
    assert full["vos_model"]["point_tracker"]["_target_"].endswith(
        "PipsPointTracker")


def test_evaluate_over_two_processes(tmp_path):
    from torch_parallel_worlds import cpu_world, vis_evaluate_rank

    gt = _write_tree(tmp_path)
    only_second = dict(gt, videos=gt["videos"][1:],
                       annotations=gt["annotations"][1:])
    with open(tmp_path / "second.json", "w") as f:
        json.dump(only_second, f)
    frames = str(tmp_path / "frames")
    cfg = {"seed": 72, "score": True, "max_videos": None}
    _, adapter = _adapters()
    ranks = cpu_world(2, vis_evaluate_rank, adapter,
                      ("two_uvo", str(tmp_path / "gt.json"), frames, True),
                      dict(cfg, dataset="two_uvo",
                           output=str(tmp_path / "world")))
    assert "AP" in ranks[0] and "AP" not in ranks[1]
    with open(tmp_path / "world" / "results.json") as f:
        got = json.load(f)
    want = []
    for name, json_file in (("first_uvo", "gt.json"),
                            ("second_uvo", "second.json")):
        tdatasets.register_dataset(name, str(tmp_path / json_file), frames,
                                   True)
        _, adapter = _adapters()
        out = str(tmp_path / name)
        tevaluate(dict(cfg, dataset=name, output=out, model=adapter,
                       max_videos=1))
        with open(os.path.join(out, "results.json")) as f:
            want.extend(json.load(f))
    assert ranks[0]["n_records"] == ranks[1]["n_records"] == len(got)
    assert got == want and {r["video_id"] for r in got} == {1, 2}


def test_eval_sharding_is_the_identity_in_one_process():
    from sam_pt_torch.parallel import eval_sharding

    items = [{"id": 1}, {"id": 2}]
    assert eval_sharding.shard_videos_across_hosts(items) == items
    assert eval_sharding.gather_host_results(items) == items
    assert (eval_sharding.rank(), eval_sharding.world_size()) == (0, 1)


def test_decoder_self_attention_of_100_masks_takes_k3(monkeypatch):
    """100 masks' prompts give the decoder 1609 tokens: from 1024 its token
    self-attention (8 heads x 32) goes through `fa.cross_attention`, K3's
    wrapper (the kernel at head dim 32 on the card, its plain version
    here), and equals the attention written out, float32, to 1e-5."""
    from sam_pt_torch.models.sam.mask_decoder import Attention
    from sam_pt_torch.ops import flash_attention as fa
    from sam_pt_torch.utils.checkpoint import randomize_

    attn = randomize_(Attention(256, 8), torch.Generator().manual_seed(3),
                      std=0.1)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 1100, 256), generator=gen)
    valid = torch.rand((2, 1100), generator=gen) > 0.3
    valid[:, 0] = True
    calls = []
    cross = fa.cross_attention

    def recorded(q, k, v, **kw):
        calls.append((q.shape[-1] // kw["heads"], k.shape[1]))
        return cross(q, k, v, **kw)

    monkeypatch.setattr(fa, "cross_attention", recorded)
    got = attn(x, x, x, valid)
    assert calls == [(32, 1100)]

    def split(y):
        return y.reshape(2, 1100, 8, 32).transpose(1, 2)

    logits = split(attn.q_proj(x)) @ split(attn.k_proj(x)).transpose(-1, -2)
    logits = torch.where(valid[:, None, None], logits / 32 ** 0.5,
                         torch.tensor(-1e9))
    want = attn.out_proj((logits.softmax(-1) @ split(attn.v_proj(x)))
                         .transpose(1, 2).reshape(2, 1100, 256))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
