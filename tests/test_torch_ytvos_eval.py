"""The port's YTVIS evaluator (`sam_pt_torch/vis_eval/ytvos_eval.py`, a
copy of `sam_pt_tpu/vis_eval/ytvos_eval.py`) against the JAX package's on
the synthetic cases of `tests/test_vis_eval.py` and on a random many-video
case: the 12 summary stats equal (exactly: the same float64 arithmetic),
`track_iou` and `avg_area` equal."""
import numpy as np
import pytest

import sam_pt_tpu.vis_eval.ytvos_eval as jeval
from sam_pt_torch.vis_eval import ytvos_eval as teval
from sam_pt_torch.vis_eval.rle import encode_mask

STATS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR@1", "AR@10",
         "AR@100", "ARs", "ARm", "ARl")
H, W = 300, 420


def _box(y0, x0, size, h=H, w=W):
    m = np.zeros((h, w), bool)
    m[y0:y0 + size, x0:x0 + size] = True
    return m


def _gt(objects, iscrowd=None, t=3):
    anns = [{"id": i + 1, "video_id": 1, "category_id": 1,
             "segmentations": [encode_mask(m)] * t,
             "iscrowd": 0 if iscrowd is None else iscrowd[i]}
            for i, m in enumerate(objects)]
    return {"videos": [{"id": 1, "height": H, "width": W, "length": t,
                        "file_names": [f"v/{i:05d}.jpg" for i in range(t)]}],
            "annotations": anns,
            "categories": [{"id": 1, "name": "object"}]}


def _det(score, mask, t=3, vid=1, cat=1):
    return {"video_id": vid, "category_id": cat, "score": score,
            "segmentations": [encode_mask(mask)] * t}


def _random_case():
    """Four videos, two categories, tracks with empty frames, crowd ground
    truth, detections that overlap the ground truth in part."""
    rng = np.random.default_rng(9)
    h, w, t = 64, 80, 4
    videos, anns, dets = [], [], []
    for v in range(1, 5):
        videos.append({"id": v, "height": h, "width": w, "length": t,
                       "file_names": [f"v{v}/{i}.jpg" for i in range(t)]})
        for k in range(3):
            y, x = rng.integers(0, 40, 2)
            size = int(rng.integers(8, 30))
            segs = []
            for f in range(t):
                m = _box(y + f, x, size, h, w)
                segs.append(None if (k == 2 and f == 1) else encode_mask(m))
            anns.append({"id": len(anns) + 1, "video_id": v,
                         "category_id": 1 + k % 2, "segmentations": segs,
                         "iscrowd": int(k == 1 and v == 2)})
            for j in range(2):
                dy, dx = rng.integers(-6, 7, 2)
                m = _box(max(0, y + dy), max(0, x + dx), size, h, w)
                dets.append({"video_id": v, "category_id": 1 + (k + j) % 2,
                             "score": float(rng.uniform()),
                             "segmentations": [encode_mask(m)] * t})
    gt = {"videos": videos, "annotations": anns,
          "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}
    return gt, dets


def _cases():
    small, medium, large = _box(0, 0, 10), _box(20, 20, 150), _box(0, 150, 260)
    obj, spurious = _box(40, 40, 150), _box(250, 350, 30)
    crowd, real = _box(0, 0, 150), _box(160, 160, 130)
    far = _box(280, 390, 10)
    return {
        "perfect": (_gt([medium]), [_det(0.9, medium)]),
        "miss": (_gt([medium]), [_det(0.9, _box(0, 0, 2))]),
        "area_buckets": (_gt([small, medium, large]),
                         [_det(0.9, small), _det(0.8, medium),
                          _det(0.7, large)]),
        "high_scored_fp": (_gt([obj]), [_det(0.9, spurious),
                                        _det(0.8, obj)]),
        "out_of_range": (_gt([large]), [_det(0.9, far), _det(0.8, large)]),
        "crowd": (_gt([crowd, real], iscrowd=[1, 0]),
                  [_det(0.9, crowd), _det(0.8, real)]),
        "random": _random_case(),
    }


@pytest.mark.parametrize("name", list(_cases()))
@pytest.mark.parametrize("class_agnostic", [False, True])
def test_stats_equal_jax(name, class_agnostic):
    gt, dets = _cases()[name]
    got = teval.YTVOSEvaluator(gt).evaluate(dets,
                                            class_agnostic=class_agnostic)
    want = jeval.YTVOSEvaluator(gt).evaluate(dets,
                                             class_agnostic=class_agnostic)
    assert tuple(got) == STATS
    assert got == want
    for k in STATS:
        assert got[k] == -1.0 or 0.0 <= got[k] <= 1.0


def test_max_dets_equal_jax():
    gt, dets = _random_case()
    for max_dets in (1, 3):
        assert (teval.YTVOSEvaluator(gt, max_dets=max_dets).evaluate(dets)
                == jeval.YTVOSEvaluator(gt, max_dets=max_dets).evaluate(
                    dets))


def test_track_iou_and_avg_area_equal_jax():
    a, b = _box(2, 2, 30), _box(10, 10, 30)
    empty = np.zeros_like(a)
    for d, g in (([a, a], [a, a]), ([a], [b]), ([a, None], [a, a]),
                 ([None, b], [a, None]), ([empty, b], [a, b])):
        assert teval.track_iou(d, g) == jeval.track_iou(d, g)
    for masks in ([a, None, empty], [None, None], [a, b, b]):
        assert teval.avg_area(masks) == jeval.avg_area(masks)
