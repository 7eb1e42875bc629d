"""The port's `match_pairs` CLI (`sam_pt_torch/models/tracker/superglue/
match_pairs.py`) against the JAX package's, on the CPU.

Image reading without cv2: colour PNGs to grey equal cv2's
`imread(..., IMREAD_GRAYSCALE)` pixel for pixel; the uint8 bilinear resize
within one grey level of `cv2.resize` (INTER_LINEAR; the float path within
2e-3 of 255), where cv2 is present.

The two CLIs on two grey 96 x 128 PNGs (read as they are, no resize), one
random magicleap checkpoint pair (the port reads the .pth files as they
are, the JAX CLI a SuperGlue file with the heads in its layout, F9), the
matcher at its published widths, 64 keypoints, 20 Sinkhorn iterations:
keypoints and matches equal, confidences within 1e-3 (the exp of the
transport plan, test_torch_superglue.py), and with `--eval` the same
evaluation (pose errors within 1e-3 degrees). `--eval` and `--viz` name
cv2 and matplotlib where those cannot be imported.
"""
import sys

import numpy as np
import pytest
import torch

from sam_pt_torch.models.tracker.superglue import match_pairs as tmp
from sam_pt_torch.vos_eval.data.image_io import write_png
from torch_port_helpers import (jax_head_layout, random_superglue_state_dict,
                                random_superpoint_state_dict, save_pth,
                                textured_video)

torch.set_num_threads(1)


def test_grey_and_resize_match_cv2(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    path = str(tmp_path / "a.png")
    write_png(path, rng.integers(0, 256, (120, 170, 3)).astype(np.uint8))
    grey = tmp.read_gray(path)
    np.testing.assert_array_equal(grey, cv2.imread(path,
                                                   cv2.IMREAD_GRAYSCALE))
    for w, h in ((80, 60), (85, 60), (640, 480), (100, 97)):
        got = tmp.resize_linear(grey, w, h).astype(int)
        assert np.abs(got - cv2.resize(grey, (w, h))).max() <= 1
        f = grey.astype(np.float32)
        np.testing.assert_allclose(tmp.resize_linear(f, w, h),
                                   cv2.resize(f, (w, h)), atol=2e-3, rtol=0)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("match_pairs")
    images = root / "imgs"
    images.mkdir()
    video = textured_video(2, 96, 128, seed=4)
    for name, frame in zip(("a.png", "b.png"), video):
        write_png(str(images / name), frame.mean(-1).astype(np.uint8))
    K = [100.0, 0, 64, 0, 100, 48, 0, 0, 1]
    T = list(np.eye(4).ravel())
    pairs = root / "pairs.txt"
    pairs.write_text(" ".join(["a.png", "b.png", "0", "0"]
                              + [str(x) for x in K + K + T]) + "\n")
    sp = random_superpoint_state_dict(seed=41)
    sg = random_superglue_state_dict(seed=42)
    return {"root": root, "images": images, "pairs": pairs,
            "sp": save_pth(root / "sp.pth", sp),
            "sg": save_pth(root / "sg.pth", sg, counters=True),
            "sg_jax": save_pth(root / "sg_jax.pth", jax_head_layout(sg))}


def _args(inputs, out, superglue, *extra):
    return ["--input_pairs", str(inputs["pairs"]), "--input_dir",
            str(inputs["images"]), "--output_dir", str(out), "--resize",
            "-1", "--max_keypoints", "64", "--sinkhorn_iterations", "20",
            "--superpoint_checkpoint", inputs["sp"],
            "--superglue_checkpoint", superglue, *extra]


def test_cli_matches_the_jax_cli(inputs):
    pytest.importorskip("cv2")  # both CLIs' --eval
    from sam_pt_tpu.models.tracker.superglue import match_pairs as jmp

    out_t, out_j = inputs["root"] / "port", inputs["root"] / "jax"
    tmp.main(_args(inputs, out_t, inputs["sg"], "--device", "cpu", "--eval"))
    jmp.main(_args(inputs, out_j, inputs["sg_jax"], "--eval"))
    got = np.load(out_t / "a_b_matches.npz")
    ref = np.load(out_j / "a_b_matches.npz")
    assert set(got) == set(ref) == {"keypoints0", "keypoints1", "matches",
                                    "match_confidence"}
    for key in ("keypoints0", "keypoints1", "matches"):
        np.testing.assert_array_equal(got[key], ref[key])
    np.testing.assert_allclose(got["match_confidence"],
                               ref["match_confidence"], atol=1e-3, rtol=0)
    assert (got["matches"] > -1).sum() >= 5
    ev_t = np.load(out_t / "a_b_evaluation.npz")
    ev_j = np.load(out_j / "a_b_evaluation.npz")
    assert set(ev_t) == set(ev_j)
    for key in ("precision", "matching_score", "num_correct"):
        assert ev_t[key] == ev_j[key]
    for key in ("error_R", "error_t"):
        np.testing.assert_allclose(ev_t[key], ev_j[key], atol=1e-3)

    # --cache reads the file back instead of matching again
    stamp = (out_t / "a_b_matches.npz").stat().st_mtime_ns
    tmp.main(_args(inputs, out_t, inputs["sg"], "--device", "cpu",
                   "--cache"))
    assert (out_t / "a_b_matches.npz").stat().st_mtime_ns == stamp


@pytest.mark.parametrize("option,module", [("--eval", "cv2"),
                                           ("--viz", "matplotlib")])
def test_options_name_the_package_they_need(inputs, monkeypatch, option,
                                            module):
    monkeypatch.setitem(sys.modules, module, None)  # cannot be imported
    with pytest.raises(ImportError, match=f"{option} needs {module}"):
        tmp.main(_args(inputs, inputs["root"] / "none", inputs["sg"],
                       "--device", "cpu", option))


def test_viz_writes_the_plot(inputs):
    pytest.importorskip("matplotlib")
    out = inputs["root"] / "viz"
    tmp.main(_args(inputs, out, inputs["sg"], "--device", "cpu", "--viz"))
    assert (out / "a_b_matches.png").stat().st_size > 0
