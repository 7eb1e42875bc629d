"""The port's automatic mask generator
(`sam_pt_torch/models/sam/auto_mask_generator.py`) against the JAX
package's, float32 on the CPU, on the tiny SAM of
`tests/torch_port_helpers.py::tiny_sam_pt_pair` (64-pixel input, the same
random weights on both sides).

- `build_point_grid`, `mask_to_box` and `box_nms` equal JAX's (ties in
  score kept in input order).
- `generate` at `crop_n_layers` 0 and 1 (a grid of 8 x 8 points, batches
  of 24, so the last batch is padded), with the HQ decoder's dict
  embeddings too: the same records in the same order, boxes equal,
  `predicted_iou` within 1e-4, stability scores equal, masks equal except
  at pixels whose logit lies within 1e-4 of the mask threshold. The gates
  and NMS are discontinuous, so the test asserts that its inputs keep
  every predicted IoU, stability score and box IoU at least 1e-3 from its
  threshold, the low-resolution logits of both sides within 1e-5 of each
  other (5.2e-6 measured) and the stability counts of both sides equal
  wherever the IoU gate passes, and the records' scores, which order the
  NMS, further apart than the two sides differ.
- The small-region step (`scipy.ndimage.label`, 8-connected) equals the
  JAX function's (cv2) on random masks, boxes and order included.
"""
import numpy as np
import pytest
import torch

from sam_pt_torch.models.sam import auto_mask_generator as tamg
from sam_pt_tpu.models.sam import auto_mask_generator as jamg
from torch_port_helpers import tiny_sam_pt_pair

torch.set_num_threads(1)

H, W = 48, 64
GEN = dict(points_per_side=8, points_per_batch=24, pred_iou_thresh=-0.3,
           stability_score_thresh=0.2, box_nms_thresh=0.99)
IOU_ATOL = 1e-4     # predicted IoU, float32 summation order
LOGIT_BAND = 1e-4   # mask pixels may differ only this close to 0
LOW_ATOL = 1e-5     # low-resolution logits, float32 summation order
MARGIN = 1e-3       # gates and NMS: inputs this far from each threshold


def _image(seed):
    """[H, W, 3] uint8: smooth colour fields with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([128 + 90 * np.sin(xx / (5.0 + k) + k)
                     * np.cos(yy / (7.0 - k)) for k in range(3)], -1)
    return np.clip(base + rng.normal(0, 6, (H, W, 3)), 0, 255).astype(
        np.uint8)


def test_point_grid_equals_jax():
    for n in (1, 3, 8, 32):
        np.testing.assert_array_equal(tamg.build_point_grid(n),
                                      jamg.build_point_grid(n))


def test_mask_to_box_equals_jax():
    rng = np.random.default_rng(1)
    masks = [np.zeros((9, 13), bool), np.ones((9, 13), bool),
             rng.uniform(size=(48, 64)) > 0.97]
    one = np.zeros((48, 64), bool)
    one[47, 0] = True
    masks.append(one)
    for m in masks:
        got = tamg.mask_to_box(m)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jamg.mask_to_box(m))


def test_box_nms_equals_jax():
    rng = np.random.default_rng(2)
    xy = rng.integers(0, 40, (60, 2))
    wh = rng.integers(1, 25, (60, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[10] = boxes[11]  # duplicates: the first of equal scores wins
    for scores in (rng.uniform(size=60), np.round(rng.uniform(size=60), 1),
                   np.ones(60)):
        for thresh in (0.0, 0.3, 0.7, 1.0):
            got = tamg.box_nms(boxes, scores, thresh)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(
                got, jamg.box_nms(boxes, scores, thresh))


def _capture(jgen, tgen, monkeypatch):
    """Record the JAX generator's decodes and the port generator's gate
    inputs and NMS calls."""
    seen = {"gates": [], "nms": [], "jax": []}
    gate, nms = tgen._gate_and_upscale, tamg.box_nms
    predict = jgen.predictor.predict

    def jax_predict(*args, **kwargs):
        low, iou, tokens = predict(*args, **kwargs)
        seen["jax"].append((np.asarray(low).reshape(-1, *low.shape[2:]),
                            np.asarray(iou).reshape(-1)))
        return low, iou, tokens

    jgen.predictor.predict = jax_predict

    def gate_and_upscale(low, iou, hw):
        seen["gates"].append((low.numpy().copy(), iou.numpy().copy()))
        return gate(low, iou, hw)

    def nms_(boxes, scores, thresh):
        seen["nms"].append((boxes.copy(), np.asarray(scores).copy(), thresh))
        return nms(boxes, scores, thresh)

    tgen._gate_and_upscale = gate_and_upscale
    monkeypatch.setattr(tamg, "box_nms", nms_)
    return seen


def _box_ious(boxes):
    x1 = np.maximum(boxes[:, None, 0], boxes[None, :, 0])
    y1 = np.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x2 = np.minimum(boxes[:, None, 2], boxes[None, :, 2])
    y2 = np.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = np.maximum(0, x2 - x1) * np.maximum(0, y2 - y1)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    iou = inter / np.maximum(area[:, None] + area[None] - inter, 1e-9)
    return iou[np.triu_indices(len(boxes), 1)]


def _assert_margins(seen, gen):
    """Every gate input and box IoU keeps its distance from its threshold
    (see the module's docstring)."""
    assert len(seen["jax"]) == len(seen["gates"])
    for (low, iou), (jlow, jiou) in zip(seen["gates"], seen["jax"]):
        assert np.abs(iou - gen.pred_iou_thresh).min() > MARGIN
        hi = (low > 1.0).sum((1, 2))
        lo = (low > -1.0).sum((1, 2))
        stability = hi / np.maximum(lo, 1)
        assert np.abs(stability - gen.stability_score_thresh).min() > MARGIN
        jlow = jlow[:len(low)]
        assert np.abs(low - jlow).max() < LOW_ATOL
        assert np.abs(iou - jiou[:len(iou)]).max() < IOU_ATOL
        # Where the IoU gate passes, the stability counts are the same.
        passing = iou > gen.pred_iou_thresh
        for cut in (1.0, -1.0):
            np.testing.assert_array_equal(
                (low[passing] > cut).sum((1, 2)),
                (jlow[passing] > cut).sum((1, 2)))
    for boxes, _, thresh in seen["nms"]:
        if len(boxes) > 1:
            assert np.abs(_box_ious(boxes) - thresh).min() > MARGIN


def _logits_of(tgen, image, record):
    """The port's upscaled logits of a record's (point, token), decoded
    alone: the token is the one whose IoU is the record's."""
    x0, y0, w, h = record["crop_box"]
    crop = image[y0:y0 + h, x0:x0 + w]
    px, py = record["point_coords"][0]
    emb = tgen._encode(crop)
    low, iou = tgen._decode(emb, np.array([[px - x0, py - y0]], np.float32),
                            (h, w))
    token = int(np.argmin(np.abs(iou.numpy() - record["predicted_iou"])))
    up = tgen.predictor.upscale_logits(low[token:token + 1], (h, w))[0]
    full = np.full(image.shape[:2], -np.inf, np.float32)
    full[y0:y0 + h, x0:x0 + w] = up.numpy()
    return full


def _compare(jrecs, trecs, tgen, image, seen):
    assert len(trecs) == len(jrecs) > 1
    ious = np.array([r["predicted_iou"] for r in jrecs])
    diff = max(abs(j["predicted_iou"] - t["predicted_iou"])
               for j, t in zip(jrecs, trecs))
    assert diff < IOU_ATOL
    # Scores that order an NMS lie further apart than the sides differ.
    for _, scores, _ in seen["nms"]:
        gaps = np.diff(np.sort(scores))
        gaps = gaps[gaps > 0]
        assert len(gaps) == 0 or gaps.min() > 2 * diff
    assert len(set(ious.tolist())) == len(ious)
    for j, t in zip(jrecs, trecs):
        assert set(t) == set(j)
        assert t["bbox"] == j["bbox"]
        assert t["area"] == j["area"] or not np.array_equal(
            t["segmentation"], j["segmentation"])
        assert t["stability_score"] == j["stability_score"]
        assert t["crop_box"] == [int(v) for v in j["crop_box"]]
        np.testing.assert_allclose(t["point_coords"], j["point_coords"],
                                   rtol=0, atol=1e-5)
        assert t["segmentation"].shape == (H, W)
        differ = t["segmentation"] != j["segmentation"]
        if differ.any():
            logits = _logits_of(tgen, image, t)
            assert np.abs(logits[differ]).max() < LOGIT_BAND


def _generators(hq=False, **settings):
    jsampt, tsampt = tiny_sam_pt_pair(hq=hq)
    kw = dict(GEN, **settings)
    return (jamg.SamAutomaticMaskGenerator(jsampt.sam_predictor, **kw),
            tamg.SamAutomaticMaskGenerator(tsampt.sam_predictor, **kw))


@pytest.mark.parametrize("crop_n_layers,seed", [(0, 5), (1, 8)])
def test_generate_equals_jax(crop_n_layers, seed, monkeypatch):
    jgen, tgen = _generators(crop_n_layers=crop_n_layers)
    seen = _capture(jgen, tgen, monkeypatch)
    image = _image(seed)
    jrecs = jgen.generate(image)
    trecs = tgen.generate(image)
    _assert_margins(seen, tgen)
    assert len(seen["gates"]) == (1 + 4 * crop_n_layers) * 3
    assert [r["crop_box"] for r in trecs].count([0, 0, W, H]) < len(trecs) \
        or crop_n_layers == 0
    _compare(jrecs, trecs, tgen, image, seen)


def test_generate_hq_dict_embeddings_equal_jax(monkeypatch):
    jgen, tgen = _generators(hq=True)
    seen = _capture(jgen, tgen, monkeypatch)
    image = _image(8)
    emb = tgen._encode(image)
    assert set(emb) == {"emb", "hq"}  # the features made once a crop
    jrecs = jgen.generate(image)
    trecs = tgen.generate(image)
    _assert_margins(seen, tgen)
    _compare(jrecs, trecs, tgen, image, seen)


def _region_records(seed):
    """Masks with holes and islands of 1-30 pixels, some clean."""
    rng = np.random.default_rng(seed)
    records = []
    for i in range(8):
        m = np.zeros((40, 56), bool)
        y, x = rng.integers(0, 15, 2)
        m[y:y + 20, x:x + 30] = True
        if i % 4:
            for _ in range(int(rng.integers(1, 5))):
                hy, hx = rng.integers(0, 38, 2)
                size = rng.integers(1, 6, 2)
                m[hy:hy + size[0], hx:hx + size[1]] ^= True
        if i == 7:
            m[:] = False
            m[5:7, 5:7] = True  # only a small island: dropped
        records.append({"segmentation": m, "bbox_xyxy": tamg.mask_to_box(m),
                        "predicted_iou": float(rng.uniform()),
                        "crop_box": [0, 0, 56, 40]})
    records.append(dict(records[0], segmentation=records[0]["segmentation"]
                        .copy()))  # an unchanged duplicate
    return records


@pytest.mark.parametrize("area", [3, 10, 40])
def test_small_regions_equal_jax_with_cv2(area):
    pytest.importorskip("cv2")
    jgen, tgen = (jamg.SamAutomaticMaskGenerator(None,
                                                 min_mask_region_area=area),
                  tamg.SamAutomaticMaskGenerator(None,
                                                 min_mask_region_area=area))
    for seed in range(3):
        want = jgen._postprocess_small_regions(_region_records(seed))
        got = tgen._postprocess_small_regions(_region_records(seed))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["segmentation"],
                                          w["segmentation"])
            np.testing.assert_array_equal(g["bbox_xyxy"], w["bbox_xyxy"])
            assert g["predicted_iou"] == w["predicted_iou"]
