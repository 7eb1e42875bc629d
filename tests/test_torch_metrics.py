"""The port's DAVIS boundary measure (`sam_pt_torch/vos_eval/metrics.py`),
which counts matched boundary pixels with a k-d tree, against the JAX
package's, which dilates whole frames: equal values, bit for bit, on
random masks of every density, with and without void pixels, at tolerance
radii from 0 to several pixels; and at 480 x 854, the size the
interactive loop scores every frame at."""
import numpy as np
import pytest

from sam_pt_torch.vos_eval import metrics as t_metrics
from sam_pt_tpu.vos_eval import metrics as j_metrics


@pytest.mark.parametrize("seed", range(8))
def test_boundary_f_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        h, w = rng.integers(2, 70, 2)
        fg = rng.random((3, h, w)) < rng.uniform(0, 1)
        gt = rng.random((3, h, w)) < rng.uniform(0, 1)
        if rng.random() < 0.2:
            gt[:] = False
        void = None if rng.random() < 0.5 else rng.random((3, h, w)) < 0.1
        bound_th = float(rng.choice([0.008, 0.05, 0.2, 1.0, 2.0, 3.0]))
        np.testing.assert_array_equal(
            t_metrics.db_eval_boundary(gt, fg, void, bound_th),
            j_metrics.db_eval_boundary(gt, fg, void, bound_th))


def test_boundary_f_equals_jax_at_full_size():
    gt = np.zeros((480, 854), bool)
    gt[60:200, 80:300] = True
    fg = np.zeros((480, 854), bool)
    fg[70:220, 90:320] = True
    fg[300:400, 500:700] = True
    fg[430:440, 10:20] = True
    got = t_metrics.db_eval_boundary(gt, fg)
    assert got == j_metrics.db_eval_boundary(gt, fg)
    assert 0.0 < got < 1.0
    assert t_metrics.db_eval_iou(gt, fg) == j_metrics.db_eval_iou(gt, fg)
