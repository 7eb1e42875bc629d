"""The tensor-parallel SAM encoder of the port
(`sam_pt_torch/parallel/tensor_parallel.py`) in gloo worlds of 2 and 4
CPU ranks, float32, against the JAX package's `create_tp_mesh` /
`shard_params_tp` encoder on the 8-device virtual CPU mesh and against
the port unsharded.

- The JAX test's tiny ViT (4 heads, 3 blocks, one global), its weights
  converted: model axis 2 (world 2), model axis 4 and a 2 x 2 data x
  model mesh (world 4). Each rank keeps H/m heads and 4C/m hidden units;
  the embeddings equal the JAX TP encode on the same mesh shape and the
  unsharded encodes to 2e-5 (the JAX test's tolerance: the output
  projections' float32 sums in another order).
- At a real-scale grid (32 x 32 tokens: the raw-qkv route, K1's and K2's
  wrappers, their plain versions here, at the local head count) the
  port's TP encode over 2 ranks equals its unsharded encode to 2e-5.
- `SamPredictor` with a TP model on a 2 x 2 mesh (the tiny SAM, one head
  a rank): embeddings to 1e-5, low-res masks to 1e-4 and IoU to 1e-5 of
  the JAX TP predictor on its 4 x 2 mesh and of the unsharded predictors,
  as the JAX test holds its own.
- `Sam(vit_t, tp_axis=...)` raises, as the JAX model does.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import sam_pt_tpu.utils.testing as jtesting
from sam_pt_torch.models.sam.image_encoder import ImageEncoderViT as TEncoder
from sam_pt_torch.models.sam.predictor import SamPredictor as TPredictor
from sam_pt_torch.models.sam.sam_model import Sam as TSam
from sam_pt_torch.utils.checkpoint import (
    randomize_,
    sam_state_dict_from_jax,
    vit_encoder_state_dict_from_jax,
)
from sam_pt_tpu.models.sam.image_encoder import ImageEncoderViT as JEncoder
from sam_pt_tpu.models.sam.predictor import SamPredictor as JPredictor
from sam_pt_tpu.models.sam.sam_model import Sam as JSam
from sam_pt_tpu.parallel.tensor_parallel import (
    create_tp_mesh as jcreate_tp_mesh,
    shard_params_tp as jshard_params_tp,
)
from sam_pt_tpu.utils.checkpoint import convert_sam_state_dict
from torch_parallel_worlds import cpu_world, tp_rank
from torch_port_helpers import random_sam_state_dict

torch.set_num_threads(1)

# tests/test_tensor_parallel.py's encoder.
TINY = dict(img_size=64, patch_size=16, embed_dim=32, depth=3, num_heads=4,
            out_chans=16, window_size=2, global_attn_indexes=(1,))
# A real-scale grid (32 x 32 tokens): window blocks take K1's route, the
# global block K2's.
GRID32 = dict(img_size=512, patch_size=16, embed_dim=64, depth=2,
              num_heads=4, out_chans=16, window_size=14,
              global_attn_indexes=(1,))
ATOL = 2e-5


@pytest.fixture(scope="module")
def encoder_pair():
    """(JAX params, port encoder, input x, JAX unsharded encode): the JAX
    test's weights (every leaf N(0, 0.1^2), seed 7) and input."""
    enc = JEncoder(**TINY)
    params = enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(rng.standard_normal(l.shape).astype(np.float32) * 0.1)
        for l in leaves])
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    expect = np.asarray(jax.jit(enc.apply)(params, jnp.asarray(x)))
    port = TEncoder(**TINY)
    port.load_state_dict(vit_encoder_state_dict_from_jax(params["params"],
                                                         prefix=""))
    return params, port.eval().requires_grad_(False), x, expect


@pytest.fixture(scope="module")
def sam_pair():
    """(JAX tiny Sam params, port tiny Sam) on `random_sam_state_dict(17)`,
    the prompts and images of the JAX predictor test."""
    params = convert_sam_state_dict(random_sam_state_dict(seed=17))
    port = TSam(jtesting.TINY_VIT, image_size=64)
    port.load_state_dict(sam_state_dict_from_jax(params))
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, size=(8, 64, 64, 3)).astype(np.float32)
    points = rng.uniform(0, 60, size=(8, 3, 2)).astype(np.float32)
    labels = np.ones((8, 3), np.int64)
    return params, port.eval().requires_grad_(False), images, points, labels


@pytest.fixture(scope="module")
def grid32():
    """A randomised port encoder at GRID32 and two frames."""
    g = torch.Generator().manual_seed(3)
    enc = randomize_(TEncoder(**GRID32).requires_grad_(False), g, std=0.1)
    for module in enc.modules():  # LayerNorms near the identity
        if isinstance(module, torch.nn.LayerNorm):
            module.weight.add_(1.0)
    x = torch.randn((2, 512, 512, 3), generator=g).numpy()
    with torch.no_grad():
        expect = enc(torch.from_numpy(x)).numpy()
    return enc.eval().requires_grad_(False), x, expect


@pytest.fixture(scope="module")
def worlds(encoder_pair, sam_pair, grid32):
    _, enc, x, _ = encoder_pair
    _, sam, images, points, labels = sam_pair
    g_enc, g_x, _ = grid32
    return {
        2: cpu_world(2, tp_rank, [(enc, x, 2, 1), (g_enc, g_x, 2, 1)], None),
        4: cpu_world(4, tp_rank, [(enc, x, 4, 1), (enc, x, 2, 2)],
                     (copy.deepcopy(sam), images, points, labels, 2, 2)),
    }


def _jax_tp_encode(params, x, n_model, n_data):
    mesh = jcreate_tp_mesh(n_model=n_model, n_data=n_data)
    dp = "data" if n_data > 1 else None
    enc = JEncoder(tp_axis="model", dp_axis=dp, **TINY)
    sharded = jshard_params_tp(params, mesh, axis="model")
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(dp)))
    with jax.set_mesh(mesh):
        return np.asarray(jax.jit(enc.apply)(sharded, xs))


@pytest.mark.parametrize("world, index, n_model, n_data",
                         [(2, 0, 2, 1), (4, 0, 4, 1), (4, 1, 2, 2)])
def test_tp_encoder_matches_jax_and_unsharded(encoder_pair, worlds, world,
                                              index, n_model, n_data):
    params, port, x, expect = encoder_pair
    jax_tp = _jax_tp_encode(params, x, n_model, n_data)
    with torch.no_grad():
        unsharded = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(unsharded, expect, atol=ATOL)
    ranks = [r["encoders"][index] for r in worlds[world]]
    for r in ranks:
        assert r["local_heads"] == TINY["num_heads"] // n_model
        assert r["local_hidden"] == 4 * TINY["embed_dim"] // n_model
        np.testing.assert_allclose(r["emb"], jax_tp, atol=ATOL)
        np.testing.assert_allclose(r["emb"], unsharded, atol=ATOL)
        np.testing.assert_array_equal(r["emb"], ranks[0]["emb"])


def test_tp_encoder_at_a_real_scale_grid_matches_unsharded(grid32, worlds):
    _, _, expect = grid32
    assert expect.std() > 0.1
    for r in worlds[2]:
        got = r["encoders"][1]
        assert got["local_heads"] == GRID32["num_heads"] // 2
        np.testing.assert_allclose(got["emb"], expect, atol=ATOL)


def test_tp_predictor_matches_jax_and_unsharded(sam_pair, worlds):
    params, sam, images, points, labels = sam_pair
    hw = (64, 64)
    plain = JPredictor(JSam(encoder_variant="vit_tiny_test", image_size=64),
                       params)
    mesh = jcreate_tp_mesh(n_model=2, n_data=4)
    jtp = JPredictor(JSam(encoder_variant="vit_tiny_test", image_size=64,
                          tp_axis="model", dp_axis="data"), params, mesh=mesh)
    refs = []
    for pred in (plain, jtp):
        e = pred.encode_frames(jnp.asarray(images), hw)
        m, i, _ = pred.predict(e, jnp.asarray(points),
                               jnp.asarray(labels, jnp.int32), hw)
        refs.append((np.asarray(e), np.asarray(m), np.asarray(i)))
    tplain = TPredictor(copy.deepcopy(sam))
    te = tplain.encode_frames(torch.from_numpy(images), hw)
    tm, ti, _ = tplain.predict(te, points, labels, hw)
    refs.append((te.numpy(), tm.numpy(), ti.numpy()))
    for r in worlds[4]:
        got = r["predictor"]
        for e, m, i in refs:
            np.testing.assert_allclose(got["emb"], e, atol=1e-5)
            np.testing.assert_allclose(got["masks"], m, atol=1e-4)
            np.testing.assert_allclose(got["iou"], i, atol=1e-5)
        np.testing.assert_array_equal(got["masks"],
                                      worlds[4][0]["predictor"]["masks"])


def test_tinyvit_refuses_tp_axis():
    with pytest.raises(ValueError, match="TinyViT"):
        TSam("vit_t", tp_axis="model")
