"""The query-point sampling methods side by side on one mask (counterpart
of `scripts/visualize_point_sampling_methods.py`, with its arguments and
its output):

    python -m sam_pt_torch.tools.visualize_point_sampling_methods \
        --image <frame> --mask <PNG mask> [--out point_sampling_methods.png]
        [--n_points 8] [--seed 72]

A 2 x 2 panel of the frame with the mask tinted and `--n_points` points
of each method drawn (random, k-medoids, Shi-Tomasi corners, mixed), from
one generator seeded `--seed` in that order, written as an RGB PNG. The
frame is read as RGB (a PNG by the port's own codec, another format
through Pillow), the mask is a palette or grey PNG whose nonzero indices
are the object. Host code only. Corners and drawing need OpenCV (`cv2`),
a JPEG frame Pillow; where either is missing, the tool raises an
ImportError that names it.
"""
import argparse

import numpy as np

from ..utils import query_points as qp
from ..vos_eval.data.image_io import read_index_mask, read_rgb, write_png


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", required=True)
    ap.add_argument("--mask", required=True)
    ap.add_argument("--out", default="point_sampling_methods.png")
    ap.add_argument("--n_points", type=int, default=8)
    ap.add_argument("--seed", type=int, default=72)
    args = ap.parse_args(argv)
    cv2 = qp.cv2
    if cv2 is None:
        raise ImportError("the point-sampling panel needs OpenCV (cv2) for "
                          "Shi-Tomasi corners and drawing; it is not "
                          "installed")

    image = read_rgb(args.image)
    mask = (read_index_mask(args.mask)[0] > 0).astype(np.float32)
    rng = np.random.default_rng(args.seed)

    panels = []
    methods = {
        "random": lambda: qp.extract_random_mask_points(
            mask, args.n_points, rng=rng),
        "kmedoids": lambda: qp.extract_kmedoid_points(
            mask, args.n_points, rng=rng),
        "shi-tomasi": lambda: qp.extract_corner_points(
            image, mask, args.n_points, rng=rng),
        "mixed": lambda: qp.extract_mixed_points(
            [mask], np.zeros(1), image[None], args.n_points, rng=rng)[0],
    }
    for name, fn in methods.items():
        panel = image.copy()
        panel[mask > 0] = 0.6 * panel[mask > 0] + 0.4 * np.array([0, 160, 255])
        for x, y in fn():
            cv2.circle(panel, (int(x), int(y)), 4, (255, 0, 0), -1)
        cv2.putText(panel, name, (8, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.8,
                    (255, 255, 255), 2)
        panels.append(panel)
    grid = np.concatenate(
        [np.concatenate(panels[:2], axis=1),
         np.concatenate(panels[2:], axis=1)], axis=0)
    write_png(args.out, grid.astype(np.uint8))
    print(f"Wrote {args.out}")


if __name__ == "__main__":
    main()
