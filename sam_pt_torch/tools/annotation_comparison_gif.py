"""A side-by-side GIF of two annotation (or result) directories over the
same frames (counterpart of `scripts/annotation_comparison_gif.py`, with
its arguments and its output):

    python -m sam_pt_torch.tools.annotation_comparison_gif \
        --frames <dir of <name>.jpg> --left <dir of <name>.png> \
        --right <dir of <name>.png> [--out comparison.gif] [--fps 8]

For each `<name>.png` of `--left`, in sorted order, the frame
`<name>.jpg` with the left and then the right mask's objects overlaid
(each object id in its `MASK_COLORS` colour), side by side, as one frame
of the GIF. Masks are palette or grey PNGs, read by the port's own codec
(`vos_eval/data/image_io.py`): their indices are the object ids. Host
code only. Reading a JPEG frame and writing the GIF need Pillow; where it
is missing, the tool raises an ImportError that names it.
"""
import argparse
import os

import numpy as np

from ..utils.viz import MASK_COLORS, add_mask_to_frame, save_video
from ..vos_eval.data.image_io import read_index_mask, read_rgb


def overlay(frame: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """`frame` with each nonzero id of `mask` blended in its colour."""
    out = frame
    for oid in np.unique(mask):
        if oid == 0:
            continue
        out = add_mask_to_frame(
            out, mask == oid, MASK_COLORS[(int(oid) - 1) % len(MASK_COLORS)])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", required=True)
    ap.add_argument("--left", required=True)
    ap.add_argument("--right", required=True)
    ap.add_argument("--out", default="comparison.gif")
    ap.add_argument("--fps", type=int, default=8)
    args = ap.parse_args(argv)

    names = sorted(f for f in os.listdir(args.left) if f.endswith(".png"))
    rows = []
    for name in names:
        frame = read_rgb(os.path.join(args.frames, name[:-4] + ".jpg"))
        left, _ = read_index_mask(os.path.join(args.left, name))
        right, _ = read_index_mask(os.path.join(args.right, name))
        rows.append(np.concatenate(
            [overlay(frame.copy(), left), overlay(frame.copy(), right)],
            axis=1))
    save_video(np.stack(rows), args.out, fps=args.fps)
    print(f"Wrote {args.out}")


if __name__ == "__main__":
    main()
