"""The port's counterparts of the JAX package's last public helpers, each
against its JAX function on the same inputs (numpy, from a seed) and,
where it has weights, the same weights (the JAX tree converted):

- `PointTracker.evaluate_batch` / `unpack_results` on a tiny PIPS (the
  JAX `build_tiny_pips` tree redrawn N(0, 0.02^2)), with and without
  ground truth: the same
  keys, shapes and records; trajectories within 1e-4 px (float32 through
  PIPS's iterations, as `test_torch_pips.py`), visibilities equal.
- `PipsPointTracker.encode_video` over 10 frames in chunks of 4 (the
  last padded): features within 1e-4 (values of order 1-10).
- `PromptEncoder.encode_boxes` (the tiny SAM's prompt encoder): within
  1e-5 (float32 sin/cos of the same coordinates).
- `resize_nearest` at the JAX test's shapes (`tests/test_ops_resize_
  color.py:42`) and in uint8 and bf16, `grid_sample_nearest` with
  half-pixel, negative and out-of-range coordinates: equal, same dtype.
- `StageTimer`, `batchify_list`, `round_up`: equal results.
- `build_image_encoder("vit_b")` (2 blocks, one global, 64 pixels) and
  `build_sam` / `build_tiny_sam` / `build_tiny_pips` (the tiny models):
  the JAX builders' trees load strictly; encodes within 1e-4 / 1e-5.
"""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sam_pt_tpu.utils.testing as jtesting
from sam_pt_torch.models.sam.image_encoder import build_image_encoder
from sam_pt_torch.models.sam.sam_model import build_sam
from sam_pt_torch.models.tracker.pips.tracker import PipsPointTracker
from sam_pt_torch.ops import grid_sample_nearest, resize_nearest
from sam_pt_torch.utils import testing as ttesting
from sam_pt_torch.utils.checkpoint import (
    pips_state_dict_from_jax,
    sam_state_dict_from_jax,
    vit_encoder_state_dict_from_jax,
)
from sam_pt_torch.utils.logging import StageTimer
from sam_pt_torch.utils.util import batchify_list, round_up
from sam_pt_tpu.models.sam.image_encoder import (
    build_image_encoder as jbuild_image_encoder,
)
from sam_pt_tpu.models.sam.sam_model import build_sam as jbuild_sam
from sam_pt_tpu.ops import grid_sample_nearest as jgrid_sample_nearest
from sam_pt_tpu.ops import resize_nearest as jresize_nearest
from sam_pt_tpu.utils.logging import StageTimer as JStageTimer
from sam_pt_tpu.utils.util import batchify_list as jbatchify_list
from sam_pt_tpu.utils.util import round_up as jround_up

torch.set_num_threads(1)

CPU = torch.device("cpu")
QUERIES = np.array([[[0, 5.0, 6.0], [3, 20.0, 15.0], [9, 40.0, 25.0],
                     [3, 30.0, 10.0]]], np.float32)


@pytest.fixture(scope="module")
def pips_pair():
    """(JAX tiny PIPS tracker, the port's `build_tiny_pips` on its tree, a
    [1, 10, 32, 48, 3] uint8 video). Every leaf of the JAX
    `build_tiny_pips` tree is redrawn N(0, 0.02^2), as the port's
    builder draws them: the flax initialisers' weights move random
    points by tens of pixels, where float32 summation order decides the
    track."""
    jtracker = jtesting.build_tiny_pips(height=32, width=48, seed=1)
    rng = np.random.default_rng(1)
    jtracker.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.02 * rng.standard_normal(a.shape),
                              jnp.float32), jtracker.params)
    jtracker.encode_chunk = 4
    ttracker = ttesting.build_tiny_pips(device=CPU)
    ttracker.model.load_state_dict(pips_state_dict_from_jax(jtracker.params))
    ttracker.encode_chunk = 4
    video = np.random.default_rng(2).integers(
        0, 255, (1, 10, 32, 48, 3)).astype(np.uint8)
    return jtracker, ttracker, video


@pytest.fixture(scope="module")
def sam_pair():
    """(JAX tiny Sam and its tree, the port's `build_sam` on it)."""
    model, params = jtesting.build_tiny_sam(image_size=64, seed=3)
    port = build_sam(jtesting.TINY_VIT, image_size=64, device=CPU)
    port.load_state_dict(sam_state_dict_from_jax(params))
    return model, params, port.eval().requires_grad_(False)


@pytest.mark.parametrize("with_gt", [False, True])
def test_evaluate_batch_and_unpack_results(pips_pair, with_gt):
    jtracker, ttracker, video = pips_pair
    rng = np.random.default_rng(5)
    gt = ((rng.uniform(0, 32, (1, 10, 4, 2)).astype(np.float32),
           rng.integers(0, 2, (1, 10, 4)).astype(np.float32))
          if with_gt else (None, None))
    ref = jtracker.evaluate_batch(video, QUERIES, *gt)
    got = ttracker.evaluate_batch(video, QUERIES, *gt)
    assert got.keys() == ref.keys()
    for key, value in ref.items():
        if value is None:
            assert got[key] is None
            continue
        assert isinstance(got[key], np.ndarray)
        assert got[key].shape == value.shape and got[key].dtype == value.dtype
    np.testing.assert_allclose(got["trajectories_pred"],
                               ref["trajectories_pred"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got["visibilities_pred"],
                                  ref["visibilities_pred"])
    np.testing.assert_array_equal(got["query_points"], QUERIES)
    rows = PipsPointTracker.unpack_results(got, batch_idx=7)
    ref_rows = type(jtracker).unpack_results(ref, batch_idx=7)
    assert len(rows) == len(ref_rows) == 4
    for row, ref_row in zip(rows, ref_rows):
        assert row.keys() == ref_row.keys()
        for key, value in ref_row.items():
            if key.startswith("trajectory"):
                np.testing.assert_allclose(row[key], value, atol=1e-4)
            else:
                np.testing.assert_array_equal(row[key], value)


def test_encode_video_matches_jax(pips_pair):
    jtracker, ttracker, video = pips_pair
    ref = np.asarray(jtracker.encode_video(video[0]))
    got = ttracker.encode_video(torch.from_numpy(video[0]))
    assert tuple(got.shape) == ref.shape == (10, 8, 12, 16)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_encode_boxes_matches_jax(sam_pair):
    model, params, port = sam_pair
    boxes = np.random.default_rng(4).uniform(0, 64, (5, 4)).astype(
        np.float32)
    ref = np.asarray(model.apply(
        params, jnp.asarray(boxes),
        method=lambda m, b: m.prompt_encoder.encode_boxes(b)))
    got = port.prompt_encoder.encode_boxes(boxes)
    assert got.shape == ref.shape == (5, 2, 256)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype, out_hw", [
    ("float32", (23, 7)), ("uint8", (4, 30)), ("bfloat16", (13, 10))])
def test_resize_nearest_matches_jax(dtype, out_hw):
    rng = np.random.default_rng(72)
    x = rng.uniform(0, 5, size=(1, 10, 13, 2))
    if dtype == "float32":  # tests/test_ops_resize_color.py:42's input
        x = (x > 2).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    ref = jresize_nearest(jx, out_hw)
    got = resize_nearest(torch.tensor(np.asarray(jx.astype(jnp.float32)))
                         .to(getattr(torch, dtype)), out_hw)
    assert str(got.dtype) == f"torch.{ref.dtype}"
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_grid_sample_nearest_matches_jax():
    rng = np.random.default_rng(9)
    img = rng.standard_normal((7, 9, 3)).astype(np.float32)
    x = np.concatenate([[-3.0, -0.5, 0.5, 1.5, 2.5, 8.5, 11.0],
                        rng.uniform(-2, 11, 13)]).astype(np.float32)
    y = np.concatenate([[0.5, 6.5, -1.0, 3.5, 4.5, 9.0, 2.0],
                        rng.uniform(-2, 9, 13)]).astype(np.float32)
    x, y = x.reshape(4, 5), y.reshape(4, 5)
    ref = np.asarray(jgrid_sample_nearest(jnp.asarray(img), jnp.asarray(x),
                                          jnp.asarray(y)))
    got = grid_sample_nearest(torch.from_numpy(img), torch.from_numpy(x),
                              torch.from_numpy(y))
    assert got.shape == ref.shape == (4, 5, 3)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_stage_timer_batchify_list_and_round_up_match_jax():
    timers = (StageTimer(), JStageTimer())
    for timer in timers:
        for name, seconds in (("a", 0.0), ("b", 0.02), ("a", 0.0),
                              ("c", 0.01)):
            with timer.stage(name):
                time.sleep(seconds)
    assert timers[0].counts == timers[1].counts == {"a": 2, "b": 1, "c": 1}
    assert list(timers[0].report()) == list(timers[1].report())
    assert list(timers[0].report())[0] == "b"
    data = list(range(11))
    for size in (1, 3, 4, 11, 20):
        assert batchify_list(data, size) == jbatchify_list(data, size)
        assert batchify_list(tuple(data), size) == jbatchify_list(
            tuple(data), size)
    for x in (0, 1, 7, 8, 9, 127, 128, 129):
        for multiple in (1, 8, 128):
            assert round_up(x, multiple) == jround_up(x, multiple)


def test_build_image_encoder_matches_jax():
    kw = dict(depth=2, global_attn_indexes=(1,), img_size=64)
    enc = jbuild_image_encoder("vit_b", **kw)
    x = np.random.default_rng(6).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    params = jax.jit(enc.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jax.jit(enc.apply)(params, jnp.asarray(x)))
    port = build_image_encoder("vit_b", device=CPU, **kw)
    port.load_state_dict(vit_encoder_state_dict_from_jax(params["params"],
                                                         prefix=""))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 4, 4, 256)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_tiny_builders_take_the_jax_builders_trees(sam_pair, pips_pair):
    model, params, port = sam_pair
    assert isinstance(jbuild_sam("vit_tiny_test", image_size=64), type(model))
    images = np.random.default_rng(8).uniform(0, 255, (2, 64, 48, 3)).astype(
        np.float32)
    ref = np.asarray(model.apply(params, jnp.asarray(images),
                                 method=type(model).encode_images))
    with torch.no_grad():
        got = port.encode_images(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    tiny = ttesting.build_tiny_sam(device=CPU, seed=3)
    tiny.load_state_dict(sam_state_dict_from_jax(params))
    predictor = ttesting.build_tiny_predictor(seed=3, device=CPU)
    for a, b in zip(ttesting.build_tiny_sam(device=CPU, seed=3)
                    .state_dict().values(),
                    predictor.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    jtracker, ttracker, _ = pips_pair  # its port model took the JAX tree
    assert (ttracker.s, ttracker.stride, ttracker.iters) == (
        jtracker.s, jtracker.stride, jtracker.iters)
