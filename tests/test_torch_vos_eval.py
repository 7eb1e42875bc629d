"""The port's VOS evaluation (`sam_pt_torch/vos_eval/`) against the JAX
package's, on synthetic DAVIS, YouTube-VOS, MOSE and BDD100K trees.

- `evaluate`: the tiny float32 SamPt pair with PIPS
  (`torch_port_helpers.tiny_sam_pt_pair("pips")`), each side given its own
  SamPt object, over the JAX tests' DAVIS tree (2 videos of 6 frames): the
  same frame count, the written index masks equal on at least 99.9% of a
  video's pixels (labels may differ only where the two sides' float16
  logits are within their tolerance of a decision boundary, as in
  test_torch_default_model.py), J&F within 1e-3. The same for the host
  branch (`save_scores`: probabilities within 2/255, `backward.json`
  equal) and for `flip`.
- The scorers on one fixed result tree: values equal to 1e-12, and CSVs
  with the same header and values.
- MaskMapper, the dataset factories and the video reader: equal outputs.
- The harness's options on the port alone, with its tiny SamPt:
  overlapping-mask dump, zip, resume-by-skip, `max_videos`/`vid_ids`,
  the visualisations, and the two options of `SamPtInteractive`'s slice
  (held to the JAX CLI in test_torch_interactive_cli.py); the printed
  tables against pandas'.
- The CLI under `torchrun` (2 gloo ranks on the CPU) with the tiny SAM,
  TapNet, `model.data_parallel=true` and
  `model.point_tracker.time_parallel=true`: both ranks exit 0 and write
  the same masks (rank 1 under `<output>_rank1`), which agree with one
  process's run on at least 99.9% of a video's pixels.
"""
import csv
import json
import os
import shutil
import zipfile
from os import path

import numpy as np
import pytest
import torch
from PIL import Image

from sam_pt_torch.vos_eval import bdd100keval as t_bdd
from sam_pt_torch.vos_eval import davis2017eval as t_davis
from sam_pt_torch.vos_eval import eval as t_eval
from sam_pt_torch.vos_eval.data import mask_mapper as t_mapper
from sam_pt_tpu.vos_eval import bdd100keval as j_bdd
from sam_pt_tpu.vos_eval import davis2017eval as j_davis
from sam_pt_tpu.vos_eval import eval as j_eval
from sam_pt_tpu.vos_eval.data import mask_mapper as j_mapper
from test_vos_eval import DAVIS_PALETTE, fabricate_bdd, fabricate_davis
from torch_port_helpers import tiny_sam_pt_pair

torch.set_num_threads(1)

AGREEMENT = 0.999
JF_ATOL = 1e-3
TINY_MODEL = {"_target_": "sam_pt_torch.utils.testing.build_tiny_sam_pt",
              "device": "cpu"}


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
    names = fabricate_davis(str(root), n_videos=2, t=6)
    return root, names


@pytest.fixture(scope="module")
def pair():
    return tiny_sam_pt_pair("pips")


def _index_masks(folder):
    return {f: np.array(Image.open(path.join(folder, f)))
            for f in sorted(os.listdir(folder))}


def _agree(out_j, out_t, names):
    for name in names:
        ref, got = _index_masks(out_j / name), _index_masks(out_t / name)
        assert list(got) == list(ref) and len(got) == 6
        same = np.mean([np.mean(got[f] == ref[f]) for f in ref])
        assert same >= AGREEMENT, (name, same)


@pytest.mark.parametrize("flip", [False, True], ids=["plain", "flip"])
def test_evaluate_matches_jax(davis, pair, tmp_path, flip):
    root, names = davis
    jmodel, tmodel = pair
    ref = j_eval.evaluate(_cfg(jmodel, root, tmp_path / "j", flip=flip))
    got = t_eval.evaluate(_cfg(tmodel, root, tmp_path / "t", flip=flip))
    assert got["total_frames"] == ref["total_frames"] == 12
    _agree(tmp_path / "j", tmp_path / "t", names)
    assert 0.0 <= got["J&F-Mean"] <= 1.0
    assert got["J&F-Mean"] == pytest.approx(ref["J&F-Mean"], abs=JF_ATOL)
    assert path.exists(tmp_path / "t.zip")


def test_save_scores_host_branch_matches_jax(davis, pair, tmp_path):
    root, names = davis
    jmodel, tmodel = pair
    ref = j_eval.evaluate(_cfg(jmodel, root, tmp_path / "j", save_scores=True,
                               vid_ids=[0]))
    got = t_eval.evaluate(_cfg(tmodel, root, tmp_path / "t", save_scores=True,
                               vid_ids=[0]))
    assert got["total_frames"] == ref["total_frames"] == 6
    _agree(tmp_path / "j" / "Annotations", tmp_path / "t" / "Annotations",
           names[:1])
    assert got["J&F-Mean"] == pytest.approx(ref["J&F-Mean"], abs=JF_ATOL)
    scores_j, scores_t = (tmp_path / s / "Scores" / names[0]
                          for s in ("j", "t"))
    assert sorted(os.listdir(scores_t)) == sorted(os.listdir(scores_j))
    with open(scores_t / "backward.json") as f, \
            open(scores_j / "backward.json") as g:
        assert json.load(f) == json.load(g) == {"1": 1, "2": 2}
    for name in os.listdir(scores_j):
        if name.endswith(".npz"):
            a = np.load(scores_t / name)["probs"].astype(int)
            b = np.load(scores_j / name)["probs"].astype(int)
            assert a.shape == b.shape == (3, 48, 64)
            assert np.mean(np.abs(a - b) <= 2) >= AGREEMENT
    # Scores are not zipped (the reference's rule).
    assert not path.exists(tmp_path / "t.zip")


def _result_tree(gt_root, out, seed):
    """The annotations of `gt_root` with one object shifted and noise
    pixels relabelled: a fixed result tree that is neither perfect nor
    empty."""
    rng = np.random.default_rng(seed)
    for seq in sorted(os.listdir(gt_root)):
        os.makedirs(out / seq)
        for frame in sorted(os.listdir(gt_root / seq)):
            mask = np.array(Image.open(gt_root / seq / frame))
            mask = np.where(np.roll(mask, 2, axis=1) == 1, 1,
                            np.where(mask == 1, 0, mask)).astype(np.uint8)
            noise = rng.uniform(size=mask.shape) < 0.03
            mask[noise] = rng.integers(0, 3, int(noise.sum()))
            im = Image.fromarray(mask, mode="P")
            im.putpalette(DAVIS_PALETTE)
            im.save(out / seq / frame)


def _table(df):
    return {c: df[c].tolist() for c in df.columns}


def _assert_tables_equal(got, ref):
    assert list(got) == list(ref)
    for name in ref:
        assert len(got[name]) == len(ref[name]), name
        for a, b in zip(got[name], ref[name]):
            if isinstance(b, str):
                assert a == b
            elif np.isnan(b):
                assert np.isnan(a), name
            else:
                assert a == pytest.approx(b, abs=1e-12, rel=0), name


def test_davis_scorer_matches_jax(tmp_path):
    root = tmp_path / "davis"
    fabricate_davis(str(root), n_videos=2, t=6)
    gt = root / "trainval" / "Annotations" / "480p"
    _result_tree(gt, tmp_path / "res_j", seed=3)
    shutil.copytree(tmp_path / "res_j", tmp_path / "res_t")
    g_ref, s_ref = j_davis.Davis2017Evaluator(
        str(tmp_path / "res_j"), str(root / "trainval")).evaluate()
    g_got, s_got = t_davis.Davis2017Evaluator(
        str(tmp_path / "res_t"), str(root / "trainval")).evaluate()
    _assert_tables_equal(g_got, _table(g_ref))
    _assert_tables_equal(s_got, _table(s_ref))
    assert 0.2 < g_got["J&F-Mean"][0] < 0.99
    for got, ref in ((g_got, g_ref), (s_got, s_ref)):  # the printed tables
        assert t_davis.format_table(got) == ref.to_string(index=False)
    for name in ("global_results-val.csv", "per-sequence_results-val.csv"):
        with open(tmp_path / "res_t" / name) as f, \
                open(tmp_path / "res_j" / name) as g:
            got, ref = list(csv.reader(f)), list(csv.reader(g))
        assert got[0] == ref[0] and len(got) == len(ref)
        _assert_tables_equal(
            {i: [t_davis._parse_cell(x) for x in col]
             for i, col in enumerate(zip(*got[1:]))},
            {i: [t_davis._parse_cell(x) for x in col]
             for i, col in enumerate(zip(*ref[1:]))})
    # A second call reads the CSVs back, as the JAX scorer does.
    g_again, s_again = t_davis.Davis2017Evaluator(
        str(tmp_path / "res_t"), str(root / "trainval")).evaluate()
    _assert_tables_equal(g_again, g_got)
    _assert_tables_equal(s_again, s_got)


def test_bdd_scorer_matches_jax(tmp_path):
    data = tmp_path / "bdd"
    fabricate_bdd(str(data), t=5)
    _result_tree(data / "val" / "Annotations", tmp_path / "res", seed=4)
    g_ref, s_ref = j_bdd.BDD100KEvaluator(
        str(tmp_path / "res"), str(data / "val"),
        use_process_pool=False).evaluate()
    g_got, s_got = t_bdd.BDD100KEvaluator(
        str(tmp_path / "res"), str(data / "val"),
        use_process_pool=False).evaluate()
    _assert_tables_equal(g_got, _table(g_ref))
    _assert_tables_equal(s_got, _table(s_ref))
    assert len(s_got["Sequence"]) == 2
    for got, ref in ((g_got, g_ref), (s_got, s_ref)):
        assert t_davis.format_table(got) == ref.to_string(index=False)


@pytest.mark.parametrize("table", [
    {"A": ["x", "y"], "LongHeader": [1.5, 2.0], "B": [-2.25, 0.0]},
    {"a": [2e6, 0.5], "b": [123456.789, float("nan")], "n": [3, 12]},
    {"a": [1e-7, 0.5], "b": [2e6 + 0.123457, 0.25]},
], ids=["names", "wide", "scientific"])
def test_table_printout_matches_pandas(table):
    import pandas as pd

    assert t_davis.format_table(table) == pd.DataFrame(table).to_string(
        index=False)


def test_mask_mapper_matches_jax():
    rng = np.random.default_rng(5)
    jm, tm = j_mapper.MaskMapper(), t_mapper.MaskMapper()
    for labels in ([3, 7], [7, 9], [12]):
        mask = np.zeros((8, 10), np.uint8)
        for i, value in enumerate(labels):
            mask[rng.uniform(size=mask.shape) < 0.3] = value
        ref = jm.convert_mask(mask, old_labels_allowed=True)
        got = tm.convert_mask(mask, old_labels_allowed=True)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]
    assert tm.remappings == jm.remappings and not tm.coherent
    idx = rng.integers(0, 5, (8, 10)).astype(np.uint8)
    np.testing.assert_array_equal(tm.remap_index_mask(idx),
                                  jm.remap_index_mask(idx))


def _frames(folder, names, seed, ext=".jpg", h=24, w=32):
    rng = np.random.default_rng(seed)
    os.makedirs(folder)
    for name in names:
        Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(
            np.uint8)).save(path.join(folder, name + ext))


def _masks(folder, names, labels, h=24, w=32):
    os.makedirs(folder)
    for i, name in enumerate(names):
        mask = np.zeros((h, w), np.uint8)
        for j, value in enumerate(labels):
            mask[2 + 5 * j:6 + 5 * j, 3 + i:12 + i] = value
        im = Image.fromarray(mask, mode="P")
        im.putpalette(DAVIS_PALETTE)
        im.save(path.join(folder, name + ".png"))


def _layouts(root):
    """One tree of each layout, with the factories' arguments."""
    frames = ["00000", "00001", "00002"]
    # YouTube-VOS: all frames as inputs, sparse annotations, meta.json
    yt = root / "yt"
    for vid in ("a", "b"):
        _frames(yt / "all_frames" / "valid_all_frames" / "JPEGImages" / vid,
                frames, 1)
        _masks(yt / "valid" / "Annotations" / vid, frames[:1], [1, 2])
    with open(yt / "valid" / "meta.json", "w") as f:
        json.dump({"videos": {v: {"objects": {"1": {"frames": frames[1:]}}}
                              for v in ("a", "b")}}, f)
    # MOSE and BDD100K: split/{JPEGImages,Annotations}
    for name in ("mose", "bdd"):
        _frames(root / name / "val" / "JPEGImages" / "s0", frames, 2)
        _masks(root / name / "val" / "Annotations" / "s0", frames, [1, 2])
    # Long videos: sparse annotations name the frames to save
    _frames(root / "long" / "JPEGImages" / "v0", frames, 3)
    _masks(root / "long" / "Annotations" / "v0", frames[::2], [1])
    fabricate_davis(str(root / "davis"), n_videos=2, t=3)
    return [
        ("Y18", dict(dataset="Y18", y18_path=str(yt), size=-1)),
        ("MOSE", dict(dataset="MOSE", mose_path=str(root / "mose"))),
        ("BDD100K", dict(dataset="BDD100K",
                         bdd100k_path=str(root / "bdd"))),
        ("G", dict(dataset="G", generic_path=str(root / "long"), size=-1)),
        ("D17", dict(dataset="D17", d17_path=str(root / "davis"), size=480)),
        ("D17 longest", dict(dataset="D17", d17_path=str(root / "davis"),
                             size=-1, longest_size=32)),
    ]


def test_dataset_factories_and_readers_match_jax(tmp_path):
    for label, cfg in _layouts(tmp_path):
        cfg = dict({"split": "val", "size": -1, "longest_size": None}, **cfg)
        ref, got = j_eval.build_dataset(cfg), t_eval.build_dataset(cfg)
        assert len(got) == len(ref) and got.vid_list == ref.vid_list, label
        for rj, rt in zip(ref.get_datasets(), got.get_datasets()):
            assert (rt.vid_name, rt.frames, rt.to_save) == (
                rj.vid_name, rj.frames, rj.to_save), label
            assert rt.get_palette() == rj.get_palette(), label
            for a, b in zip(rt, rj):
                np.testing.assert_array_equal(a["rgb"], b["rgb"])
                assert a["info"] == b["info"], label
                assert ("mask" in a) == ("mask" in b), label
                if "mask" in a:
                    assert a["mask"].dtype == b["mask"].dtype, label
                    np.testing.assert_array_equal(a["mask"], b["mask"])
                    onehot = np.stack([a["mask"] == v for v in (1, 2)])
                    np.testing.assert_array_equal(rt.resize_mask(onehot),
                                                  rj.resize_mask(onehot))


def test_png_frames_and_remapped_labels(tmp_path):
    """PNG frames, labels 2 and 5 (remapped on the way in and out), the
    overlapping-logits dump and the zip."""
    root = tmp_path / "davis"
    frames = [f"{i:05d}" for i in range(4)]
    _frames(root / "trainval" / "JPEGImages" / "480p" / "v0", frames, 6,
            ext=".png", h=48, w=64)
    _masks(root / "trainval" / "Annotations" / "480p" / "v0", frames, [2, 5],
           h=48, w=64)
    os.makedirs(root / "trainval" / "ImageSets" / "2017")
    (root / "trainval" / "ImageSets" / "2017" / "val.txt").write_text("v0\n")
    res = t_eval.evaluate(_cfg(TINY_MODEL, root, tmp_path / "out" / "o",
                               size=-1, save_overlapping_masks=True))
    assert res["total_frames"] == 4 and 0 <= res["J&F-Mean"] <= 1
    written = _index_masks(tmp_path / "out" / "o" / "v0")
    assert list(written) == [f + ".png" for f in frames]
    assert set(np.unique(np.stack(list(written.values())))) <= {0, 2, 5}
    np.testing.assert_array_equal(  # the ground truth at its query frame
        written["00000.png"],
        np.array(Image.open(root / "trainval" / "Annotations" / "480p" / "v0"
                            / "00000.png")))
    logits = np.load(tmp_path / "out" / "overlapping" / "v0" /
                     "logits.npz")["logits"]
    assert logits.shape == (4, 3, 48, 64)
    assert (logits[:, 0] == 0).all()
    with zipfile.ZipFile(tmp_path / "out" / "o.zip") as z:
        assert "v0/00003.png" in z.namelist()


def test_subsets_and_resume_by_skip(davis, tmp_path):
    root, names = davis
    out = tmp_path / "out"
    first = t_eval.evaluate(_cfg(TINY_MODEL, root, out, vid_ids=[1],
                                 visualize_results=True,
                                 verbose_visualisations=True))
    assert first["total_frames"] == 6
    for name in (f"{names[1]}.gif", f"{names[1]}_input.gif"):
        with Image.open(out / "viz" / name) as gif:
            assert (gif.size, gif.n_frames) == ((64, 48), 6)
    assert not path.exists(out / names[0]) and path.isdir(out / names[1])
    assert first["df_per_seq"]["Sequence"] == [f"{names[1]}_1",
                                               f"{names[1]}_2"]
    again = t_eval.evaluate(_cfg(TINY_MODEL, root, out, max_videos=2,
                                 make_zip=False))
    assert again["total_frames"] == 6  # names[1] is skipped
    assert sorted(os.listdir(out / names[0])) == sorted(
        os.listdir(out / names[1]))
    # The scores come from the first run's CSVs, as in the JAX harness.
    assert again["df_per_seq"]["Sequence"] == first["df_per_seq"]["Sequence"]
    one = t_eval.evaluate(_cfg(TINY_MODEL, root, tmp_path / "one",
                               max_videos=1, max_frames=3, score=False))
    assert one["total_frames"] == 3 and "J&F-Mean" not in one
    assert len(os.listdir(tmp_path / "one" / names[0])) == 3


@pytest.mark.parametrize("option", ["input_only_one_gt_mask_point",
                                    "simulate_interactive_point_correction"])
def test_options_that_need_sam_pt_interactive_raise(davis, tmp_path, option):
    """The two options raised NotImplementedError until the predictor's
    `predict` and `SamPtInteractive` were ported; they now run on the
    tiny SamPt (the interactive option on its SamPtInteractive) and score
    both videos. test_torch_interactive_cli.py holds them to the JAX
    CLI."""
    root, names = davis
    model = dict(TINY_MODEL)
    if option == "simulate_interactive_point_correction":
        model.update(interactive=True, online=True, interactions_max=8,
                     output_root=str(tmp_path / "history"))
    got = t_eval.evaluate(_cfg(model, root, tmp_path / "o",
                               **{option: True}))
    assert got["total_frames"] == 12 and 0.0 <= got["J&F-Mean"] <= 1.0
    assert sorted(os.listdir(tmp_path / "o" / names[0])) == [
        f"{t:05d}.png" for t in range(6)]
    if option == "simulate_interactive_point_correction":
        assert len(os.listdir(tmp_path / "history")) == 4  # 2 x 2 objects


def test_softmax_fuse_matches_jax():
    x = np.random.default_rng(7).standard_normal((3, 4, 5, 6)) * 5
    np.testing.assert_allclose(t_eval.softmax_fuse(x), j_eval.softmax_fuse(x),
                               rtol=0, atol=0)


def test_cli_under_torchrun_with_data_and_time_parallel(davis, tmp_path):
    import socket
    import subprocess
    import sys

    root, names = davis
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    args = ["-m", "sam_pt_torch.vos_eval.eval", "dataset=D17",
            f"d17_path={root}", "device=cpu", "size=-1",
            "model/sam@model.sam_predictor=sam_tiny_test",
            "model/point_tracker=tapnet",
            "model.point_tracker.allow_random_init=true",
            "visualize_results=false", "make_zip=false", "score=false"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=path.dirname(path.dirname(path.abspath(__file__))))
    runs = {"world": [sys.executable, "-m", "torch.distributed.run",
                      "--nproc-per-node", "2", "--master-port", str(port),
                      *args, "+dist_backend=gloo",
                      "model.data_parallel=true",
                      "model.point_tracker.time_parallel=true",
                      f"output={tmp_path / 'world'}",
                      f"trace_output={tmp_path / 'trace.json'}"],
            "one": [sys.executable, *args, f"output={tmp_path / 'one'}"]}
    for name, cmd in runs.items():
        proc = subprocess.run(cmd, cwd=str(tmp_path), env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, (name, proc.stderr[-3000:])
    for trace in ("trace.json", "trace_rank1.json"):  # a file a rank
        with open(tmp_path / trace) as f:
            videos = [e["args"]["video"] for e in json.load(f)["traceEvents"]
                      if e["name"] == "video"]
        assert len(videos) == len(names), (trace, videos)
    for name in names:
        world = _index_masks(tmp_path / "world" / name)
        assert world and all(np.array_equal(world[f], m) for f, m in
                             _index_masks(tmp_path / "world_rank1" / name)
                             .items())
        one = _index_masks(tmp_path / "one" / name)
        assert list(world) == list(one)
        same = np.mean([np.mean(world[f] == one[f]) for f in one])
        assert same >= AGREEMENT, (name, same)
