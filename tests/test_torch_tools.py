"""The port's user tools (`sam_pt_torch/tools/`) against the repo's JAX-era
scripts (`scripts/annotation_comparison_gif.py`,
`scripts/visualize_point_sampling_methods.py`) on a small synthetic tree
(JPEG frames, palette and grey PNG masks): the same GIF, byte for byte
and frame by frame, and the same PNG panel, pixel for pixel. Where jax,
the JAX package, Pillow and cv2 cannot be imported, `--help` runs and
each tool names the package that its input needs."""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from sam_pt_torch.tools import annotation_comparison_gif as gif_tool
from sam_pt_torch.tools import visualize_point_sampling_methods as points_tool
from sam_pt_torch.vos_eval.data.image_io import write_png
from test_torch_imports import _blocking_stubs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALETTE = [0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0]
H, W = 48, 64


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_script(name, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    _script(name).main()


def _frame(rng) -> np.ndarray:
    """A textured RGB frame: gradients plus noise (corners to find)."""
    yy, xx = np.mgrid[:H, :W]
    base = np.stack([xx * 4, yy * 5, (xx + yy) * 2], -1) % 256
    return (base + rng.integers(0, 40, (H, W, 3))).clip(0, 255).astype(
        np.uint8)


def _masks(rng, objects: int) -> np.ndarray:
    """[H, W] uint8 ids: `objects` rectangles."""
    mask = np.zeros((H, W), np.uint8)
    for oid in range(1, objects + 1):
        y0, x0 = rng.integers(0, H - 16), rng.integers(0, W - 20)
        mask[y0:y0 + 16, x0:x0 + 20] = oid
    return mask


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """frames/<name>.jpg, left/<name>.png (palette), right/<name>.png
    (grey) for 3 names, plus a PNG frame."""
    root = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(11)
    for sub in ("frames", "left", "right"):
        os.makedirs(root / sub)
    for i in range(3):
        name = f"{i:05d}"
        frame = _frame(rng)
        Image.fromarray(frame).save(root / "frames" / f"{name}.jpg",
                                    quality=90)
        write_png(str(root / "left" / f"{name}.png"), _masks(rng, 3),
                  PALETTE)
        write_png(str(root / "right" / f"{name}.png"), _masks(rng, 2))
    write_png(str(root / "frame.png"), _frame(rng))
    return root


def _gif_frames(path) -> list:
    with Image.open(path) as gif:
        frames = []
        for i in range(gif.n_frames):
            gif.seek(i)
            frames.append(np.array(gif.convert("RGB")))
    return frames


@pytest.mark.parametrize("fps", [8, 5])
def test_annotation_comparison_gif_matches_the_script(tree, tmp_path,
                                                      monkeypatch, fps):
    args = ["--frames", str(tree / "frames"), "--left", str(tree / "left"),
            "--right", str(tree / "right"), "--fps", str(fps)]
    ref, got = tmp_path / "script.gif", tmp_path / "port.gif"
    _run_script("annotation_comparison_gif", monkeypatch,
                args + ["--out", str(ref)])
    gif_tool.main(args + ["--out", str(got)])
    assert got.read_bytes() == ref.read_bytes()
    ref_frames, got_frames = _gif_frames(ref), _gif_frames(got)
    assert len(got_frames) == 3 and got_frames[0].shape == (H, 2 * W, 3)
    for a, b in zip(got_frames, ref_frames):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("image, mask, seed", [
    ("frames/00001.jpg", "left/00001.png", 72),
    ("frame.png", "right/00002.png", 3)])
def test_point_sampling_panel_matches_the_script(tree, tmp_path, monkeypatch,
                                                 image, mask, seed):
    args = ["--image", str(tree / image), "--mask", str(tree / mask),
            "--n_points", "6", "--seed", str(seed)]
    ref, got = tmp_path / "script.png", tmp_path / "port.png"
    _run_script("visualize_point_sampling_methods", monkeypatch,
                args + ["--out", str(ref)])
    points_tool.main(args + ["--out", str(got)])
    ref_px, got_px = np.array(Image.open(ref)), np.array(Image.open(got))
    assert got_px.shape == (2 * H, 2 * W, 3)
    np.testing.assert_array_equal(got_px, ref_px)


def test_tools_without_jax_pillow_or_cv2(tree, tmp_path):
    """`--help` of each tool exits 0 where jax, the JAX package, Pillow and
    cv2 raise ImportError; the GIF tool over JPEG frames names Pillow,
    the point-sampling tool names cv2."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_blocking_stubs(tmp_path), ROOT]))
    runs = {
        "annotation_comparison_gif": [
            "--frames", str(tree / "frames"), "--left", str(tree / "left"),
            "--right", str(tree / "right"), "--out", str(tmp_path / "a.gif")],
        "visualize_point_sampling_methods": [
            "--image", str(tree / "frame.png"), "--mask",
            str(tree / "left/00000.png"), "--out", str(tmp_path / "a.png")],
    }
    named = {"annotation_comparison_gif": "needs Pillow",
             "visualize_point_sampling_methods": "needs OpenCV (cv2)"}
    for tool, args in runs.items():
        module = f"sam_pt_torch.tools.{tool}"
        proc = subprocess.run([sys.executable, "-m", module, "--help"],
                              env=env, cwd=tmp_path, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert "usage:" in proc.stdout
        proc = subprocess.run([sys.executable, "-m", module, *args], env=env,
                              cwd=tmp_path, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0 and named[tool] in proc.stderr, (
            proc.stderr)
