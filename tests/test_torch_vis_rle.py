"""The port's COCO RLE codec (`sam_pt_torch/vis_eval/rle.py`, a copy of
`sam_pt_tpu/vis_eval/rle.py`) against the JAX package's: the same
uncompressed and compressed counts (the `counts` strings equal, character
for character), round trips, areas and polygon masks; without cv2, a
polygon segmentation raises an ImportError that names it."""
import builtins

import numpy as np
import pytest

import sam_pt_tpu.vis_eval.rle as jrle
from sam_pt_torch.vis_eval import rle as trle


def _masks():
    rng = np.random.default_rng(3)
    out = [rng.uniform(size=(23, 31)) > 0.6,   # speckle: many short runs
           np.zeros((7, 5), bool),             # empty
           np.ones((6, 9), bool)]              # full: counts start at 0
    blob = np.zeros((48, 64), bool)
    blob[10:30, 5:50] = True
    blob[40:, 60:] = True                      # ends on a run of ones
    out.append(blob)
    big = np.zeros((480, 854), bool)           # runs past 2^5 and 2^10
    big[100:300, 200:700] = True
    big[::7, ::11] ^= True
    out.append(big)
    return out


@pytest.mark.parametrize("case", range(5))
def test_counts_and_strings_equal_jax(case):
    mask = _masks()[case]
    counts = trle.mask_to_rle_counts(mask)
    assert counts == jrle.mask_to_rle_counts(mask)
    rle = trle.encode_mask(mask)
    assert rle == jrle.encode_mask(mask)
    assert isinstance(rle["counts"], str)
    np.testing.assert_array_equal(trle.decode_mask(rle), mask)
    np.testing.assert_array_equal(jrle.decode_mask(rle), mask)
    assert trle.rle_area(rle) == jrle.rle_area(rle) == int(mask.sum())
    raw = {"size": list(mask.shape), "counts": counts}
    np.testing.assert_array_equal(trle.segmentation_to_mask(raw, mask.shape),
                                  mask)


def test_compressed_counts_round_trip_as_jax():
    rng = np.random.default_rng(4)
    for counts in ([0, 5, 3, 100, 2, 713], [0], [12],
                   rng.integers(0, 5000, 40).tolist()):
        s = trle.compress_counts(counts)
        assert s == jrle.compress_counts(counts)
        assert trle.decompress_counts(s) == counts
        # bytes counts, as some YTVIS files hold them
        rle = {"size": [1, int(sum(counts))], "counts": s.encode()}
        np.testing.assert_array_equal(trle.decode_mask(rle),
                                      jrle.decode_mask(rle))


def test_polygons_as_jax():
    pytest.importorskip("cv2")
    polygons = [[2, 2, 30, 4, 25, 20, 4, 18], [40, 30, 60, 30, 50, 45],
                [1, 1, 2, 2]]  # the last has fewer than 3 points
    np.testing.assert_array_equal(
        trle.segmentation_to_mask(polygons, (48, 64)),
        jrle.segmentation_to_mask(polygons, (48, 64)))
    assert not trle.segmentation_to_mask(None, (4, 5)).any()


def test_polygon_without_cv2_names_the_segmentation(monkeypatch):
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("cv2 is blocked")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match=r"polygon segmentation \[\[2, 2"):
        trle.segmentation_to_mask([[2, 2, 30, 4, 25, 20]], (48, 64))
    rle = trle.encode_mask(np.eye(4, dtype=bool))  # RLE needs no cv2
    np.testing.assert_array_equal(trle.segmentation_to_mask(rle, (4, 4)),
                                  np.eye(4, dtype=bool))
