"""Standalone SuperPoint + SuperGlue image-pair matching (counterpart of
`sam_pt_tpu/models/tracker/superglue/match_pairs.py`, magicleap's
`match_pairs.py`).

Reads an `input_pairs` list ("name0 name1 [rot0 rot1 [K0(9) K1(9)
T_0to1(16)]]" a line), matches each pair on the device, and writes
`{stem0}_{stem1}_matches.npz` (keypoints0, keypoints1, matches,
match_confidence); `--cache` reuses such a file. `--viz` plots the matches
(needs matplotlib); `--eval` evaluates the relative pose of 38-entry rows
(epipolar precision, matching score, pose errors by
`cv2.findEssentialMat` / `recoverPose`, AUC at 5, 10 and 20 degrees; needs
cv2) into `{stem0}_{stem1}_evaluation.npz`. Images are read and resized
without cv2: PNGs by the port's codec (other formats through Pillow), the
grey conversion and the bilinear resize in numpy as
`cv2.imread(..., IMREAD_GRAYSCALE)` and `cv2.resize` (INTER_LINEAR) do.

    python -m sam_pt_torch.models.tracker.superglue.match_pairs \\
        --input_pairs pairs.txt --input_dir imgs/ --output_dir out/ \\
        [--device cuda] [--allow_random_init]
"""
from __future__ import annotations

import argparse
import importlib
import random
from pathlib import Path

import numpy as np
import torch

from ....vos_eval.data.image_io import read_png, read_rgb


def require(module: str, option: str):
    """Import `module` for `option`, or raise an ImportError naming it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{option} needs {module}, which cannot be "
                          f"imported here") from e


def read_gray(path: str) -> np.ndarray:
    """A file as [H, W] uint8 grey: a grey PNG as it is, colour as cv2's
    PNG reader asks libpng for it, 0.299 R + 0.587 G + 0.114 B in 15-bit
    fixed point, truncated."""
    if str(path).lower().endswith(".png"):
        pixels, palette = read_png(str(path))
        if pixels.ndim == 2 and palette is None:
            return pixels
    rgb = read_rgb(str(path)).astype(np.int64)
    gray = (9797 * rgb[..., 0] + 19234 * rgb[..., 1]
            + 3737 * rgb[..., 2]) >> 15
    return gray.astype(np.uint8)


def _linear_taps(n_src: int, n_dst: int):
    """cv2's INTER_LINEAR taps along one axis: source index and weight of
    the first tap, half-pixel centres, clamped to the edges."""
    scale = n_src / n_dst
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0
    frac[i0 < 0] = 0.0
    i0 = np.maximum(i0, 0)
    last = i0 >= n_src - 1
    frac[last] = 0.0
    i0[last] = n_src - 1
    return i0, np.minimum(i0 + 1, n_src - 1), frac


def resize_linear(image: np.ndarray, w_new: int, h_new: int) -> np.ndarray:
    """cv2.resize(image, (w_new, h_new)) with INTER_LINEAR on [H, W]: uint8
    in cv2's fixed point (weights in 1/2048; rows of 2^11-scaled sums, cut
    by 4 bits, weighted by the high 16 bits of their products, then
    rounded), float32 in floating point."""
    h, w = image.shape
    x0, x1, fx = _linear_taps(w, w_new)
    y0, y1, fy = _linear_taps(h, h_new)
    if image.dtype == np.uint8:
        ax = np.round((1.0 - fx) * 2048).astype(np.int64)
        ay = np.round((1.0 - fy) * 2048).astype(np.int64)
        src = image.astype(np.int64)
        rows = src[:, x0] * ax + src[:, x1] * (2048 - ax)
        out = (((rows[y0] >> 4) * ay[:, None]) >> 16) + (
            ((rows[y1] >> 4) * (2048 - ay)[:, None]) >> 16)
        return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    src = image.astype(np.float32)
    rows = src[:, x0] * (1.0 - fx) + src[:, x1] * fx
    return (rows[y0] * (1.0 - fy)[:, None]
            + rows[y1] * fy[:, None]).astype(np.float32)


def read_image(path: Path, resize, rotation: int, resize_float: bool):
    """Grey load, resize (to W x H, or the longer side to one size) and
    rotation -> (image float32 [H, W] in [0, 1], scales (sx, sy)), or
    (None, None) where the file is missing."""
    if not Path(path).exists():
        return None, None
    image = read_gray(str(path))
    h, w = image.shape
    if len(resize) == 2:
        w_new, h_new = resize
    elif len(resize) == 1 and resize[0] > 0:
        scale = resize[0] / max(h, w)
        w_new, h_new = int(round(w * scale)), int(round(h * scale))
    else:
        w_new, h_new = w, h
    scales = (float(w) / float(w_new), float(h) / float(h_new))
    if resize_float:
        image = resize_linear(image.astype(np.float32), w_new, h_new)
    else:
        image = resize_linear(image, w_new, h_new).astype(np.float32)
    if rotation:
        image = np.rot90(image, k=rotation)
        if rotation % 2:
            scales = scales[::-1]
    return image / 255.0, scales


def rotate_intrinsics(K, image_shape, rot: int):
    """Intrinsics for a k * 90 degree rotation; `image_shape` is the
    rotated image's."""
    h, w = image_shape[:2][::-1] if rot % 2 else image_shape[:2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    rot = rot % 4
    if rot == 1:
        return np.array([[fy, 0, cy], [0, fx, w - 1 - cx], [0, 0, 1]], K.dtype)
    if rot == 2:
        return np.array([[fx, 0, w - 1 - cx], [0, fy, h - 1 - cy], [0, 0, 1]],
                        K.dtype)
    if rot == 3:
        return np.array([[fy, 0, h - 1 - cy], [0, fx, cx], [0, 0, 1]], K.dtype)
    return K


def scale_intrinsics(K, scales):
    sx, sy = scales
    return np.diag([1.0 / sx, 1.0 / sy, 1.0]) @ K


def epipolar_error(kpts0, kpts1, T_0to1, K0, K1):
    """Symmetric epipolar distance of matched points under the true pose."""

    def to_homog(pts):
        return np.concatenate([pts, np.ones((len(pts), 1))], axis=1)

    kpts0n = (kpts0 - K0[[0, 1], [2, 2]][None]) / K0[[0, 1], [0, 1]][None]
    kpts1n = (kpts1 - K1[[0, 1], [2, 2]][None]) / K1[[0, 1], [0, 1]][None]
    t, R = T_0to1[:3, 3], T_0to1[:3, :3]
    t_skew = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = t_skew @ R
    p0, p1 = to_homog(kpts0n), to_homog(kpts1n)
    Ep0 = p0 @ E.T
    d = (p1 * Ep0).sum(-1)
    return d ** 2 * (
        1.0 / np.maximum(Ep0[:, 0] ** 2 + Ep0[:, 1] ** 2, 1e-15)
        + 1.0 / np.maximum((p1 @ E)[:, 0] ** 2 + (p1 @ E)[:, 1] ** 2, 1e-15)
    )


def estimate_pose(kpts0, kpts1, K0, K1, thresh=1.0, conf=0.99999):
    cv2 = require("cv2", "--eval")
    if len(kpts0) < 5:
        return None
    f_mean = np.mean([K0[0, 0], K1[1, 1], K0[1, 1], K1[0, 0]])
    norm_thresh = thresh / f_mean
    k0 = (kpts0 - K0[[0, 1], [2, 2]][None]) / K0[[0, 1], [0, 1]][None]
    k1 = (kpts1 - K1[[0, 1], [2, 2]][None]) / K1[[0, 1], [0, 1]][None]
    E, mask = cv2.findEssentialMat(
        k0, k1, np.eye(3), threshold=norm_thresh, prob=conf,
        method=cv2.RANSAC)
    if E is None:
        return None
    best = None
    for e in np.split(E, len(E) / 3):
        n, R, t, _ = cv2.recoverPose(e, k0, k1, np.eye(3), 1e9,
                                     mask=mask.copy())
        if best is None or n > best[0]:
            best = (n, R, t[:, 0], mask.ravel() > 0)
    return best[1:]


def pose_errors(R_est, t_est, T_0to1):
    R_gt, t_gt = T_0to1[:3, :3], T_0to1[:3, 3]
    cos_r = (np.trace(R_est.T @ R_gt) - 1) / 2
    err_R = float(np.rad2deg(np.arccos(np.clip(cos_r, -1.0, 1.0))))
    n = np.linalg.norm(t_est) * np.linalg.norm(t_gt)
    cos_t = np.dot(t_est, t_gt) / max(n, 1e-15)
    err_t = float(np.rad2deg(np.arccos(np.clip(np.abs(cos_t), 0.0, 1.0))))
    return err_R, err_t


def pose_auc(errors, thresholds=(5, 10, 20)):
    errors = np.sort(np.array([e if np.isfinite(e) else 180.0
                               for e in errors]))
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.concatenate([[0.0], errors])
    recall = np.concatenate([[0.0], recall])
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    aucs = []
    for thr in thresholds:
        last = np.searchsorted(errors, thr)
        r = np.concatenate([recall[:last], [recall[last - 1]]])
        e = np.concatenate([errors[:last], [thr]])
        aucs.append(float(trapezoid(r, x=e) / thr))
    return aucs


def build_matcher(opt):
    """`match(img0, img1)` on the device of `opt.device`: both images'
    keypoints (the valid ones, in order of falling score), frame 0's
    matches into image 1's keypoints (-1: none) and their confidences."""
    from .tracker import SuperGluePointTracker, match_data

    tracker = SuperGluePointTracker(
        checkpoint_path=opt.superglue_checkpoint,
        superpoint_checkpoint_path=opt.superpoint_checkpoint,
        max_keypoints=opt.max_keypoints if opt.max_keypoints > 0 else 1024,
        sinkhorn_iterations=opt.sinkhorn_iterations,
        match_threshold=opt.match_threshold,
        nms_radius=opt.nms_radius,
        keypoint_threshold=opt.keypoint_threshold,
        allow_random_init=opt.allow_random_init,
        device=opt.device,
    )
    device = torch.device(opt.device)

    @torch.no_grad()
    def match(img0: np.ndarray, img1: np.ndarray):
        det0, det1 = (tracker.superpoint(torch.from_numpy(
            np.ascontiguousarray(img, np.float32))[None].to(device))
            for img in (img0, img1))
        pred = tracker.superglue(match_data(det0, det1, img0.shape))
        det0, det1 = ({k: v[0].cpu().numpy() for k, v in det.items()}
                      for det in (det0, det1))
        matches = pred["matches0"][0].cpu().numpy()
        conf = pred["matching_scores0"][0].cpu().numpy()
        # Only the valid keypoint slots; matches re-indexed to image 1's.
        v0, v1 = det0["valid"], det1["valid"]
        remap = -np.ones(len(v1), np.int64)
        remap[v1] = np.arange(int(v1.sum()))
        matches = matches[v0]
        matches = np.where(matches > -1, remap[np.clip(matches, 0, None)], -1)
        return (det0["keypoints"][v0], det1["keypoints"][v1], matches,
                conf[v0])

    return match


def viz_matches(image0, image1, mkpts0, mkpts1, mconf, out_path):
    matplotlib = require("matplotlib", "--viz")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h0, w0 = image0.shape
    h1, w1 = image1.shape
    canvas = np.ones((max(h0, h1), w0 + w1))
    canvas[:h0, :w0] = image0
    canvas[:h1, w0:] = image1
    fig, ax = plt.subplots(figsize=(12, 6))
    ax.imshow(canvas, cmap="gray")
    cmap = plt.cm.RdYlGn
    for (x0, y0), (x1, y1), c in zip(mkpts0, mkpts1, mconf):
        ax.plot([x0, x1 + w0], [y0, y1], color=cmap(float(c)), lw=0.8)
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="SuperPoint + SuperGlue matching of image pairs.")
    p.add_argument("--input_pairs", required=True)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--max_length", type=int, default=-1)
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--resize", type=int, nargs="+", default=[640, 480])
    p.add_argument("--resize_float", action="store_true")
    p.add_argument("--superglue_checkpoint", default=None)
    p.add_argument("--superpoint_checkpoint", default=None)
    p.add_argument("--allow_random_init", action="store_true")
    p.add_argument("--max_keypoints", type=int, default=1024)
    p.add_argument("--keypoint_threshold", type=float, default=0.005)
    p.add_argument("--nms_radius", type=int, default=4)
    p.add_argument("--sinkhorn_iterations", type=int, default=20)
    p.add_argument("--match_threshold", type=float, default=0.2)
    p.add_argument("--viz", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--cache", action="store_true")
    p.add_argument("--device", default="cuda")
    opt = p.parse_args(argv)

    if len(opt.resize) == 2 and opt.resize[1] == -1:
        opt.resize = opt.resize[0:1]
    if opt.eval:
        require("cv2", "--eval")
    if opt.viz:
        require("matplotlib", "--viz")

    with open(opt.input_pairs) as f:
        pairs = [line.split() for line in f if line.strip()]
    if opt.max_length > -1:
        pairs = pairs[: opt.max_length]
    if opt.shuffle:
        random.Random(0).shuffle(pairs)
    if opt.eval and not all(len(pr) == 38 for pr in pairs):
        raise ValueError(
            "--eval needs 38 entries per row (names, rotations, K0, K1, "
            "T_0to1)")

    matcher = build_matcher(opt)
    input_dir, output_dir = Path(opt.input_dir), Path(opt.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    pose_errs = []
    precisions = []
    for i, pair in enumerate(pairs):
        name0, name1 = pair[:2]
        stem0, stem1 = Path(name0).stem, Path(name1).stem
        matches_path = output_dir / f"{stem0}_{stem1}_matches.npz"
        eval_path = output_dir / f"{stem0}_{stem1}_evaluation.npz"
        rot0, rot1 = (int(pair[2]), int(pair[3])) if len(pair) >= 5 else (0, 0)

        image0, scales0 = read_image(
            input_dir / name0, opt.resize, rot0, opt.resize_float)
        image1, scales1 = read_image(
            input_dir / name1, opt.resize, rot1, opt.resize_float)
        if image0 is None or image1 is None:
            raise IOError(f"cannot read pair {name0} {name1}")

        if opt.cache and matches_path.exists():
            r = np.load(matches_path)
            kpts0, kpts1 = r["keypoints0"], r["keypoints1"]
            matches, conf = r["matches"], r["match_confidence"]
        else:
            kpts0, kpts1, matches, conf = matcher(image0, image1)
            np.savez(str(matches_path), keypoints0=kpts0, keypoints1=kpts1,
                     matches=matches, match_confidence=conf)

        valid = matches > -1
        mkpts0 = kpts0[valid]
        mkpts1 = kpts1[matches[valid]]
        mconf = conf[valid]
        print(f"[{i + 1}/{len(pairs)}] {name0} {name1}: "
              f"{len(mkpts0)} matches")

        if opt.viz:
            viz_matches(image0, image1, mkpts0, mkpts1, mconf,
                        output_dir / f"{stem0}_{stem1}_matches.png")

        if opt.eval:
            # Scaled to the resized raster first, then rotated: the
            # (w - 1 - cx) offsets do not commute with scaling.
            K0 = rotate_intrinsics(scale_intrinsics(
                np.array(pair[4:13], float).reshape(3, 3), scales0),
                image0.shape, rot0)
            K1 = rotate_intrinsics(scale_intrinsics(
                np.array(pair[13:22], float).reshape(3, 3), scales1),
                image1.shape, rot1)
            T_0to1 = np.array(pair[22:38], float).reshape(4, 4)
            errs = (epipolar_error(mkpts0, mkpts1, T_0to1, K0, K1)
                    if len(mkpts0) else np.zeros(0))
            correct = errs < 5e-4
            precision = float(correct.mean()) if len(correct) else 0.0
            pose = estimate_pose(mkpts0, mkpts1, K0, K1)
            if pose is None:
                err_R = err_t = np.inf
            else:
                err_R, err_t = pose_errors(pose[0], pose[1], T_0to1)
            np.savez(str(eval_path), error_R=err_R, error_t=err_t,
                     precision=precision,
                     matching_score=(len(mkpts0) / max(len(kpts0), 1)),
                     num_correct=int(correct.sum()), epipolar_errors=errs)
            pose_errs.append(max(err_R, err_t))
            precisions.append(precision)

    if opt.eval and pose_errs:
        aucs = pose_auc(pose_errs)
        print(f"AUC@5 {aucs[0] * 100:.2f} AUC@10 {aucs[1] * 100:.2f} "
              f"AUC@20 {aucs[2] * 100:.2f} "
              f"Prec {np.mean(precisions) * 100:.2f}")


if __name__ == "__main__":
    main()
