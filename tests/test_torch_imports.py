"""The port imports torch and never jax (nor the JAX package, nor
scikit-learn, nor transformers, nor, at import, PyYAML or Pillow); its
kernel modules build nothing at
import; `chip_smoke.py` refuses to run without a CUDA device. The port's
CLI and its demo run where jax, the JAX package, PyYAML, Pillow, pandas,
cv2, scikit-learn and matplotlib cannot be imported (as on a machine that
has only torch, numpy and scipy). CoTracker's tracker takes the keys of
its YAML."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "sam_pt_torch.build",
    "sam_pt_torch.ops.flash_attention",
    "sam_pt_torch.ops.graph_launches",
    "sam_pt_torch.ops._cuda",
    "sam_pt_torch.ops.posemb",
    "sam_pt_torch.ops.resize",
    "sam_pt_torch.ops.sampling",
    "sam_pt_torch.ops.color",
    "sam_pt_torch.models.batch_norm",
    "sam_pt_torch.models.sam.image_encoder",
    "sam_pt_torch.models.sam.prompt_encoder",
    "sam_pt_torch.models.sam.mask_decoder",
    "sam_pt_torch.models.sam.mask_decoder_hq",
    "sam_pt_torch.models.sam.tiny_vit",
    "sam_pt_torch.models.sam.sam_model",
    "sam_pt_torch.models.sam.predictor",
    "sam_pt_torch.models.sam.encode_graphs",
    "sam_pt_torch.models.sam.factory",
    "sam_pt_torch.models.tracker",
    "sam_pt_torch.models.tracker.api",
    "sam_pt_torch.models.tracker.pips.model",
    "sam_pt_torch.models.tracker.pips.tracker",
    "sam_pt_torch.models.tracker.pips2.model",
    "sam_pt_torch.models.tracker.pips2.tracker",
    "sam_pt_torch.models.tracker.raft.model",
    "sam_pt_torch.models.tracker.raft.tracker",
    "sam_pt_torch.models.tracker.cotracker.model",
    "sam_pt_torch.models.tracker.cotracker.tracker",
    "sam_pt_torch.models.tracker.tapir",
    "sam_pt_torch.models.tracker.tapir.model",
    "sam_pt_torch.models.tracker.tapir.tracker",
    "sam_pt_torch.models.tracker.tapir.demo",
    "sam_pt_torch.models.tracker.tapnet",
    "sam_pt_torch.models.tracker.tapnet.model",
    "sam_pt_torch.models.tracker.tapnet.tracker",
    "sam_pt_torch.models.tracker.tapnet.demo",
    "sam_pt_torch.models.tracker.standalone_demo",
    "sam_pt_torch.models.tracker.superglue",
    "sam_pt_torch.models.tracker.superglue.superpoint",
    "sam_pt_torch.models.tracker.superglue.superglue",
    "sam_pt_torch.models.tracker.superglue.tracker",
    "sam_pt_torch.models.tracker.superglue.match_pairs",
    "sam_pt_torch.ops.basic",
    "sam_pt_torch.ops.label_propagation",
    "sam_pt_torch.models.sam_pt",
    "sam_pt_torch.models.sam_pt_interactive",
    "sam_pt_torch.utils.dbscan",
    "sam_pt_torch.utils.checkpoint",
    "sam_pt_torch.utils.query_points",
    "sam_pt_torch.utils.util",
    "sam_pt_torch.utils.tree",
    "sam_pt_torch.vos_eval.eval",
    "sam_pt_torch.config",
    "sam_pt_torch.config.core",
    "sam_pt_torch.config.miniyaml",
    "sam_pt_torch.utils.logging",
    "sam_pt_torch.utils.testing",
    "sam_pt_torch.utils.viz",
    "sam_pt_torch.vos_eval.evaluator",
    "sam_pt_torch.vos_eval.metrics",
    "sam_pt_torch.vos_eval.davis2017eval",
    "sam_pt_torch.vos_eval.bdd100keval",
    "sam_pt_torch.vos_eval.data.image_io",
    "sam_pt_torch.vos_eval.data.mask_mapper",
    "sam_pt_torch.vos_eval.data.video_reader",
    "sam_pt_torch.vos_eval.data.test_datasets",
    "sam_pt_torch.demo",
    "sam_pt_torch.models.sam.auto_mask_generator",
    "sam_pt_torch.parallel",
    "sam_pt_torch.parallel.comm",
    "sam_pt_torch.parallel.mesh",
    "sam_pt_torch.parallel.launch",
    "sam_pt_torch.parallel.tensor_parallel",
    "sam_pt_torch.parallel.temporal",
    "sam_pt_torch.parallel.eval_sharding",
    "sam_pt_torch.vis_eval.rle",
    "sam_pt_torch.vis_eval.ytvos_eval",
    "sam_pt_torch.vis_eval.datasets",
    "sam_pt_torch.vis_eval.adapter",
    "sam_pt_torch.vis_eval.eval",
    "sam_pt_torch.ops",
    "sam_pt_torch.tools",
    "sam_pt_torch.tools.annotation_comparison_gif",
    "sam_pt_torch.tools.visualize_point_sampling_methods",
]
# Importable here but not on every machine the port runs on.
BLOCKED = ["jax", "flax", "sam_pt_tpu", "yaml", "PIL", "pandas", "cv2",
           "sklearn", "matplotlib"]


def _run(code: str, cwd: str = ROOT):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_never_imports_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert 'flax' not in sys.modules, 'flax was imported'\n"
            "assert 'sam_pt_tpu' not in sys.modules, 'JAX package imported'\n"
            "assert 'sklearn' not in sys.modules, 'scikit-learn imported'\n"
            "assert 'transformers' not in sys.modules, "
            "'transformers imported'\n"
            "for m in ('yaml', 'PIL'):\n"
            "    assert m not in sys.modules, m + ' imported'\n"
            "import sam_pt_torch.ops._cuda as c\n"
            "assert c._LIB is None, 'kernels built at import'\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_calls_no_library_attention():
    """`scaled_dot_product_attention` is only `chip_smoke.py`'s yardstick:
    no source of the port names it."""
    pkg = os.path.join(ROOT, "sam_pt_torch")
    found = []
    for folder, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(folder, name)
                with open(path, encoding="utf-8") as f:
                    if "scaled_dot_product_attention" in f.read():
                        found.append(os.path.relpath(path, ROOT))
    assert found == []


def test_chip_smoke_needs_a_card():
    proc = _run("import runpy; runpy.run_path('chip_smoke.py', "
                "run_name='__main__')")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _blocking_stubs(root) -> str:
    """A directory of packages named as BLOCKED that raise ImportError."""
    stubs = root / "stubs"
    for name in BLOCKED:
        os.makedirs(stubs / name)
        (stubs / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked')\n")
    return str(stubs)


def test_demo_runs_without_cv2_pillow_or_jax(tmp_path):
    """`python -m sam_pt_torch.demo` on the CPU over a PNG frame directory
    with the tiny SamPt, every module of BLOCKED raising ImportError: the
    longest-side resize without cv2, the overlays written as PNGs."""
    from sam_pt_torch.vos_eval.data.image_io import read_rgb, write_png

    stubs = _blocking_stubs(tmp_path)
    rng = np.random.default_rng(1)
    frames = tmp_path / "frames"
    os.makedirs(frames)
    for t in range(3):
        write_png(str(frames / f"{t:05d}.png"),
                  rng.integers(0, 255, (30, 40, 3)).astype(np.uint8))
    points = tmp_path / "points.txt"
    points.write_text("1\n0 ; 10,10 30,20\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([stubs, ROOT]))
    proc = subprocess.run(
        [sys.executable, "-m", "sam_pt_torch.demo", "device=cpu",
         "model=sam_pt_tiny_test", f"frames_path={frames}",
         f"query_points_path={points}", "longest_side_length=64",
         f"output_dir={tmp_path / 'out'}"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Inference: 3 frames" in proc.stdout
    written = sorted(os.listdir(tmp_path / "out" / "frames"))
    assert written == [f"{t:05d}.png" for t in range(3)]
    assert read_rgb(str(tmp_path / "out" / "frames" / written[0])).shape == (
        48, 64, 3)


@pytest.mark.parametrize("name", ["tapir", "tapnet"])
def test_tracker_demo_runs_without_jax_cv2_or_matplotlib(name, tmp_path):
    """`python -m sam_pt_torch.models.tracker.<name>.demo` on the CPU over
    PNG frames, every module of BLOCKED raising ImportError: it times the
    two forwards and skips the plot."""
    from sam_pt_torch.vos_eval.data.image_io import write_png

    stubs = _blocking_stubs(tmp_path)
    rng = np.random.default_rng(3)
    frames = tmp_path / "frames"
    os.makedirs(frames)
    for t in range(3):
        write_png(str(frames / f"{t:05d}.png"),
                  rng.integers(0, 255, (30, 40, 3)).astype(np.uint8))
    points = tmp_path / "points.txt"
    points.write_text("1\n0 ; 10,10 30,20\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([stubs, ROOT]))
    proc = subprocess.run(
        [sys.executable, "-m", f"sam_pt_torch.models.tracker.{name}.demo",
         "--frames", str(frames), "--query-points", str(points),
         "--frame-stride", "1", "--out", str(tmp_path / "out"),
         "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "frames/s" in proc.stdout and "plot skipped" in proc.stdout


def test_cli_runs_without_jax_yaml_pillow_or_pandas(tmp_path):
    """`python -m sam_pt_torch.vos_eval.eval` on the CPU over a tiny
    PNG-framed DAVIS tree (labels 2 and 5), with the tiny SamPt, where
    every module of BLOCKED raises ImportError: it exits 0, scores the
    run and writes the masks."""
    from sam_pt_torch.vos_eval.data.image_io import read_png, write_png

    stubs = _blocking_stubs(tmp_path)
    rng = np.random.default_rng(0)
    tree = tmp_path / "DAVIS"
    frames = tree / "trainval" / "JPEGImages" / "480p" / "v"
    annotations = tree / "trainval" / "Annotations" / "480p" / "v"
    os.makedirs(frames)
    os.makedirs(annotations)
    palette = [0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0, 0, 0, 128,
               128, 0, 128]
    for t in range(4):
        write_png(str(frames / f"{t:05d}.png"),
                  rng.integers(0, 255, (48, 64, 3)).astype(np.uint8))
        mask = np.zeros((48, 64), np.uint8)
        mask[10 + t:22 + t, 8:24] = 2
        mask[30:42, 40:60] = 5
        write_png(str(annotations / f"{t:05d}.png"), mask, palette)
    os.makedirs(tree / "trainval" / "ImageSets" / "2017")
    (tree / "trainval" / "ImageSets" / "2017" / "val.txt").write_text("v\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([stubs, ROOT]))
    proc = subprocess.run(
        [sys.executable, "-m", "sam_pt_torch.vos_eval.eval", "device=cpu",
         "size=-1", "model=sam_pt_tiny_test", f"d17_path={tree}",
         f"output={tmp_path / 'out'}", "visualize_results=false"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Model on cpu" in proc.stdout and "FPS: " in proc.stdout
    assert "J&F-Mean" in proc.stdout
    written = sorted(os.listdir(tmp_path / "out" / "v"))
    assert written == [f"{t:05d}.png" for t in range(4)]
    first, palette_out = read_png(str(tmp_path / "out" / "v" / written[0]))
    assert set(np.unique(first)) == {0, 2, 5}  # the query frame's labels
    assert palette_out[:len(palette)] == palette
    assert (tmp_path / "out.zip").exists()
    # The stubs do block: the JAX package's CLI cannot start there.
    proc = subprocess.run([sys.executable, "-c", "import yaml"],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode != 0 and "blocked" in proc.stderr


def test_cotracker_takes_its_yaml_keys(tmp_path):
    """The keys of configs/model/point_tracker/cotracker.yaml build the
    tracker with the values they hold; a state dict in the
    public namespace loads as it is; a missing file raises unless
    `allow_random_init`; a built module comes in by `model=`."""
    from sam_pt_torch.config import load_yaml
    from sam_pt_torch.models.tracker.cotracker.model import CoTracker
    from sam_pt_torch.models.tracker.cotracker.tracker import (
        CoTrackerPointTracker,
    )
    from torch_port_helpers import random_cotracker_state_dict, torch_sd

    keys = load_yaml(os.path.join(
        ROOT, "sam_pt_torch", "configs", "model", "point_tracker",
        "cotracker.yaml"))
    assert keys.pop("_target_").endswith("tracker.CoTrackerPointTracker")
    assert keys.pop("device") == "${device}"
    file = tmp_path / "cotracker_stride_4_wind_8.pth"
    sd = random_cotracker_state_dict(seed=3)
    torch.save(torch_sd(sd), file)
    keys["checkpoint_path"] = str(file)
    tracker = CoTrackerPointTracker(**keys, device="cpu")
    assert (tracker.interp_shape, tracker.visibility_threshold,
            tracker.support_grid_size, tracker.support_grid_every_n_frames,
            tracker.s, tracker.stride, tracker.iters) == (
                (384, 512), 0.7, 2, 12, 8, 4, 6)
    got = tracker.model.state_dict()
    assert set(got) == set(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    assert tracker.model.dtype == torch.float32  # the JAX default
    keys["checkpoint_path"] = str(tmp_path / "absent.pth")
    with pytest.raises(FileNotFoundError):
        CoTrackerPointTracker(**keys, device="cpu")
    keys["allow_random_init"] = True
    with pytest.warns(UserWarning, match="random"):
        tracker = CoTrackerPointTracker(**keys, seed=1, device="cpu",
                                        dtype=torch.bfloat16)
    assert tracker.model.dtype == torch.bfloat16
    model = CoTracker(s=4, stride=4)
    tracker = CoTrackerPointTracker(interp_shape=(32, 40), model=model)
    assert tracker.model is model and (tracker.s, tracker.stride) == (4, 4)


def test_match_pairs_runs_without_cv2_matplotlib_or_jax(tmp_path):
    """`python -m sam_pt_torch.models.tracker.superglue.match_pairs` on the
    CPU over two colour PNGs (grey conversion and resize in numpy), random
    weights, every module of BLOCKED raising ImportError: it exits 0 and
    writes the matches file."""
    from sam_pt_torch.vos_eval.data.image_io import write_png

    stubs = _blocking_stubs(tmp_path)
    rng = np.random.default_rng(4)
    images = tmp_path / "imgs"
    os.makedirs(images)
    for name in ("a.png", "b.png"):
        write_png(str(images / name),
                  rng.integers(0, 255, (60, 90, 3)).astype(np.uint8))
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("a.png b.png\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([stubs, ROOT]))
    proc = subprocess.run(
        [sys.executable, "-m",
         "sam_pt_torch.models.tracker.superglue.match_pairs",
         "--input_pairs", str(pairs), "--input_dir", str(images),
         "--output_dir", str(tmp_path / "out"), "--resize", "80", "56",
         "--max_keypoints", "32", "--sinkhorn_iterations", "5",
         "--allow_random_init", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "a.png b.png:" in proc.stdout
    out = np.load(tmp_path / "out" / "a_b_matches.npz")
    assert set(out) == {"keypoints0", "keypoints1", "matches",
                        "match_confidence"}
    assert out["keypoints0"].shape[1] == 2


def test_superglue_composes_from_the_cli_config():
    """`model/point_tracker=superglue` composes the port's tracker with
    SamPt's points per mask, on the config's device; without checkpoints
    it refuses unless `allow_random_init`."""
    from sam_pt_torch.config import compose, instantiate
    from sam_pt_torch.config import resolve_interpolations
    from sam_pt_torch.models.tracker.superglue.tracker import (
        SuperGluePointTracker,
    )
    from sam_pt_torch.vos_eval.eval import CONFIG_DIR

    cfg = resolve_interpolations(compose(CONFIG_DIR, "vos_eval_root", [
        "model/point_tracker=superglue", "device=cpu"]))
    keys = dict(cfg["model"]["point_tracker"])
    assert keys["_target_"].endswith("superglue.tracker."
                                     "SuperGluePointTracker")
    assert (keys["positive_points_per_mask"],
            keys["negative_points_per_mask"]) == (
        cfg["model"]["positive_points_per_mask"],
        cfg["model"]["negative_points_per_mask"])
    assert (keys["max_keypoints"], keys["sinkhorn_iterations"],
            keys["match_threshold"], keys["device"]) == (1024, 100, 0.2,
                                                         "cpu")
    with pytest.raises(FileNotFoundError):
        instantiate(keys)
    keys["allow_random_init"] = True
    tracker = instantiate(keys)
    assert isinstance(tracker, SuperGluePointTracker)
    assert tracker.superpoint.max_keypoints == 1024
    assert tracker.positive_points_per_mask == 16
