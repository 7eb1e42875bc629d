"""The port's demo (`python -m sam_pt_torch.demo`) against the JAX demo
(`demo/demo.py`): the query-points parser on several files, the frame
loader, the numpy copy of cv2's INTER_AREA against cv2 itself (within one
grey level: cv2 rounds its fixed-point taps), and `main` end to end on
the tiny model over synthetic PNG frames on the CPU.
"""
import os

import numpy as np
import pytest
import torch

import cv2
from demo import demo as jdemo
from sam_pt_torch import demo as tdemo
from sam_pt_torch.config import compose, resolve_interpolations
from sam_pt_torch.vos_eval.data.image_io import read_rgb, write_png

torch.set_num_threads(1)

QUERY_FILES = {
    "one_mask": "3\n0 ; 10,20 30.5,40 50,60 70,8\n",
    "two_masks": "2\n\n0 ; 1,2 3,4 5,6\n4 ; 7,8 9,10.25 11,12\n",
    "strided": "1\n6 ; 100,50 120,60\n3 ; 5,5 6,6\n",
}


@pytest.mark.parametrize("name", list(QUERY_FILES))
@pytest.mark.parametrize("scale,stride", [(1.0, 1), (0.5, 1), (1.25, 3)])
def test_load_query_points(tmp_path, name, scale, stride):
    path = tmp_path / f"{name}.txt"
    path.write_text(QUERY_FILES[name])
    if name == "two_masks" and stride == 3:  # 4 is no multiple of 3
        with pytest.raises(AssertionError):
            jdemo.load_query_points(str(path), scale, stride)
        with pytest.raises(ValueError, match="frame_stride"):
            tdemo.load_query_points(str(path), scale, stride)
        return
    want = jdemo.load_query_points(str(path), scale, stride)
    got = tdemo.load_query_points(str(path), scale, stride)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.float32 and got[1] == want[1]


def test_ragged_query_points_raise(tmp_path):
    path = tmp_path / "ragged.txt"
    path.write_text("1\n0 ; 1,2 3,4\n0 ; 5,6\n")
    with pytest.raises(AssertionError):
        jdemo.load_query_points(str(path))
    with pytest.raises(ValueError, match="different numbers"):
        tdemo.load_query_points(str(path))


@pytest.mark.parametrize("in_hw,out_hw", [
    ((48, 86), (24, 43)),      # shrinking by 2 (cv2's fast path)
    ((60, 107), (26, 45)),     # shrinking by a non-integer factor
    ((480, 854), (188, 334)),  # a DAVIS frame to half its size and less
    ((30, 53), (58, 103)),     # enlarging (cv2's bilinear rule)
    ((480, 854), (576, 1024)),  # a DAVIS frame to SAM's 1024
    ((40, 40), (40, 71)),      # one axis kept, one enlarged
])
def test_resize_area_is_cv2_inter_area(in_hw, out_hw):
    rng = np.random.default_rng(61)
    img = rng.integers(0, 256, (*in_hw, 3)).astype(np.uint8)
    want = cv2.resize(img, out_hw[::-1], interpolation=cv2.INTER_AREA)
    got = tdemo.resize_area(img, out_hw)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()


def _frames_dir(root, n=6, h=48, w=80):
    rng = np.random.default_rng(62)
    os.makedirs(root, exist_ok=True)
    for t in range(n):
        frame = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        frame[10 + t:30 + t, 20:50] = (220, 40, 40)  # a box moving down
        write_png(os.path.join(root, f"{t:05d}.png"), frame)
    return root


@pytest.mark.parametrize("without_cv2", [False, True])
def test_load_frames_like_the_jax_demo(tmp_path, monkeypatch, without_cv2):
    """Stride, `max_frames` and the longest-side resize on a PNG
    directory: equal to the JAX demo's frames (cv2 throughout), or within
    one grey level where the port runs without cv2."""
    root = _frames_dir(str(tmp_path / "frames"), n=7)
    want, want_scale = jdemo.load_frames(root, 2, 3, 64)
    if without_cv2:
        monkeypatch.setattr(tdemo, "cv2", None)
    got, scale = tdemo.load_frames(root, 2, 3, 64)
    assert scale == want_scale and got.shape == want.shape == (3, 38, 64, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= (1 if without_cv2 else 0)


def _cfg(tmp_path, *overrides):
    return resolve_interpolations(compose(tdemo.CONFIG_DIR, "demo", [
        "device=cpu", "model=sam_pt_tiny_test", *overrides]))


def test_main_on_the_tiny_model(tmp_path, capsys):
    """`main` over 6 synthetic PNG frames with two masks of 3 points (2
    positives): it writes 6 overlay frames and reports its frames/s."""
    root = _frames_dir(str(tmp_path / "frames"))
    qp = tmp_path / "points.txt"
    qp.write_text("2\n0 ; 30,15 40,25 5,45\n0 ; 60,35 70,40 10,5\n")
    out_dir = tmp_path / "out"
    cfg = _cfg(tmp_path, f"frames_path={root}", f"query_points_path={qp}",
               f"output_dir={out_dir}", "longest_side_length=null")
    outputs = tdemo.main(cfg)
    printed = capsys.readouterr().out
    assert "Inference: 6 frames in" in printed and "fps" in printed
    assert "Demo wrote 6 frames" in printed
    written = sorted(os.listdir(out_dir / "frames"))
    assert written == [f"{t:05d}.png" for t in range(6)]
    assert read_rgb(str(out_dir / "frames" / written[0])).shape == (48, 80, 3)
    assert outputs["logits"].shape == (2, 6, 48, 80)
    assert outputs["trajectories"].shape == (6, 2, 3, 2)


def test_main_names_the_missing_query_points(tmp_path):
    root = _frames_dir(str(tmp_path / "frames"), n=2)
    cfg = _cfg(tmp_path, f"frames_path={root}", "query_points_path=null")
    with pytest.raises(ValueError, match="query_points_path"):
        tdemo.main(cfg)
