"""The rounding points of the port's tensor-parallel encoder in bf16
(`sam_pt_torch/parallel/tensor_parallel.py`), against the JAX package's
TP encoder on the virtual CPU mesh, and the port's bf16 ViT block at a
real ViT-H width against the JAX block (F13).

- T1, a case made by hand: one bf16 ViT block whose attention is zero
  and whose MLP gives the two ranks of a model axis of 2 the partial
  outputs 1 + 3 * 2^-10 and 3 * 2^-10. The JAX program (`mlp_lin2` a bf16
  `Dense`, row-sharded by GSPMD) rounds each partial to bf16, sums the
  bf16 partials, rounds the sum, adds the bias and rounds again: 1.0 in
  the channel where a float32 sum rounded once gives 1.0078125. Two more
  channels hold a partial rounded before the bias and a sum rounded
  before the bias. The port's block over a gloo world of 2 equals the JAX
  block bit for bit.
- T1 on random weights: the JAX test's tiny encoder (4 heads, 3 blocks,
  N(0, 0.1^2) weights) in bf16, model axes 2 and 4. The port's TP
  embeddings are within 2^-8 of the JAX TP encode's (the embeddings reach
  0.55: one bf16 ulp of [0.5, 1); found 2^-8 at both axes, as far as the
  unsharded port is from the unsharded JAX encode) and within 2^-9 of
  the port's unsharded bf16 encode (found 2^-9).
- F13: one bf16 ViT block at ViT-H's width (1280 channels, 16 heads x 80,
  5120 hidden units) over one 14 x 14 window, N(0, 0.02^2) weights,
  LayerNorm scales N(1, 0.1^2), N(0, 1) input: the port's block is within
  2^-5 (found 2^-5; the output reaches 5.75) and a relative L2 of 5e-3
  (found 4.23e-3) of the JAX block. The JAX `Dense` rounds its product
  and rounds again after the bias; `F.linear` rounds once. With every
  linear rounding twice the port's block comes within 3.90e-3: closer,
  by less than a fifth (asserted), so F13 is a small share of the
  difference.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from sam_pt_torch.models.sam.image_encoder import Block as TBlock
from sam_pt_torch.models.sam.image_encoder import ImageEncoderViT as TEncoder
from sam_pt_torch.utils.checkpoint import (
    attention_state_dict_from_jax,
    vit_encoder_state_dict_from_jax,
)
from sam_pt_tpu.models.sam.image_encoder import Block as JBlock
from sam_pt_tpu.models.sam.image_encoder import ImageEncoderViT as JEncoder
from sam_pt_tpu.parallel.tensor_parallel import (
    create_tp_mesh as jcreate_tp_mesh,
    shard_params_tp as jshard_params_tp,
)
from chip_smoke import world_jobs
from torch_parallel_worlds import cpu_world, tp_block_rank, tp_rank

torch.set_num_threads(1)

BF16 = jnp.bfloat16
# One global block over a 2 x 2 grid, 8 channels, 2 heads, 32 hidden
# units: rank 0 of a model axis of 2 holds units 0-15, rank 1 units 16-31.
HAND = dict(img_size=32, patch_size=16, embed_dim=8, depth=1, num_heads=2,
            out_chans=8, window_size=0, global_attn_indexes=(0,))
Q = 3 * 2.0 ** -10
# The JAX program's values in channels 0-2 (input 0.25, -0.25, 0.25), and
# those of a float32 sum of float32 partials rounded once.
HAND_JAX = (1.25, 0.75, 1.25)
HAND_F32_SUM = (1.2578125, 0.7578125, 1.2578125)
# tests/test_tensor_parallel.py's encoder.
TINY = dict(img_size=64, patch_size=16, embed_dim=32, depth=3, num_heads=4,
            out_chans=16, window_size=2, global_attn_indexes=(1,))
TINY_TP_ATOL = 2.0 ** -8
TINY_UNSHARDED_ATOL = 2.0 ** -9
VIT_H = dict(dim=1280, heads=16, grid=14)
F13_ATOL = 2.0 ** -5
F13_REL_L2 = 5e-3


def _hand_params():
    """The JAX tree of the HAND encoder: every leaf zero but the
    LayerNorm scales (1) and the MLP. Hidden units 0, 1 and 16 take the
    value 8 (lin1's bias; GELU(8) == 8 in bf16); `mlp_lin2` makes channel
    0's partials 1 + Q (rank 0) and Q (rank 1), channel 1's 1 + Q and 0
    with bias Q, channel 2's 1 and Q with bias Q."""
    params = JEncoder(**HAND).init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 32, 32, 3)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.full(leaf.shape, 1.0 if path[-1].key in (
            "scale", "weight") else 0.0, jnp.float32), params)
    b1 = np.zeros(32, np.float32)
    b1[[0, 1, 16]] = 8.0
    w2 = np.zeros((32, 8), np.float32)
    b2 = np.zeros(8, np.float32)
    w2[[0, 1, 16], 0] = (1 / 8, Q / 8, Q / 8)
    w2[[0, 1], 1] = (1 / 8, Q / 8)
    w2[[0, 16], 2] = (1 / 8, Q / 8)
    b2[1:3] = Q
    mlp = params["params"]["blocks_0"]
    mlp["mlp_lin1"]["bias"] = jnp.asarray(b1)
    mlp["mlp_lin2"]["kernel"] = jnp.asarray(w2)
    mlp["mlp_lin2"]["bias"] = jnp.asarray(b2)
    return params


@pytest.fixture(scope="module")
def hand():
    """(JAX params, port encoder in bf16, block input [1, 2, 2, 8])."""
    params = _hand_params()
    port = TEncoder(**HAND)
    port.load_state_dict(vit_encoder_state_dict_from_jax(params["params"],
                                                         prefix=""))
    x = np.tile(np.array([0.25, -0.25] * 4, np.float32), (1, 2, 2, 1))
    return params, port.to(torch.bfloat16).eval().requires_grad_(False), x


@pytest.fixture(scope="module")
def tiny():
    """(JAX params, port encoder in bf16, input x): the JAX TP test's
    weights (every leaf N(0, 0.1^2), seed 7) and input."""
    params = JEncoder(**TINY).init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 64, 64, 3)))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(rng.standard_normal(l.shape).astype(np.float32) * 0.1)
        for l in leaves])
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    port = TEncoder(**TINY)
    port.load_state_dict(vit_encoder_state_dict_from_jax(params["params"],
                                                         prefix=""))
    return params, port.to(torch.bfloat16).eval().requires_grad_(False), x


@pytest.fixture(scope="module")
def worlds(hand, tiny):
    """Each world's rank results: world 2 the hand-made block and the
    tiny encoder on model axis 2, world 4 the tiny encoder on 4."""
    _, hand_enc, hx = hand
    _, enc, x = tiny
    two = cpu_world(2, world_jobs, [
        (tp_block_rank, (hand_enc, hx.reshape(1, 4, 8), (2, 2), 2)),
        (tp_rank, ([(enc, x, 2, 1)], None))])
    four = cpu_world(4, world_jobs, [(tp_rank, ([(enc, x, 4, 1)], None))])
    return {"block": [r[0] for r in two],
            2: [r[1]["encoders"][0] for r in two],
            4: [r[0]["encoders"][0] for r in four]}


def _on_mesh(n_model, params, apply, x):
    """`apply(sharded params, x)` jitted under a (1 x n_model) TP mesh."""
    mesh = jcreate_tp_mesh(n_model=n_model, n_data=1)
    sharded = jshard_params_tp(params, mesh, axis="model")
    with jax.set_mesh(mesh):
        out = jax.jit(apply)(sharded, jnp.asarray(x))
    return np.asarray(out.astype(jnp.float32))


def test_tp_mlp_rounds_as_the_jax_program(hand, worlds):
    params, _, x = hand
    block = JBlock(num_heads=2, window_size=0, input_size=(2, 2),
                   tp_axis="model", dtype=BF16)
    expect = _on_mesh(2, params, lambda p, xx: block.apply(
        {"params": p["params"]["blocks_0"]}, xx.astype(BF16)), x)
    np.testing.assert_array_equal(expect[..., :3],
                                  np.broadcast_to(HAND_JAX, (1, 2, 2, 3)))
    assert not np.isin(HAND_F32_SUM, expect).any()
    for got in worlds["block"]:
        np.testing.assert_array_equal(got.reshape(expect.shape), expect)


@pytest.mark.parametrize("n_model", [2, 4])
def test_bf16_tp_encoder_matches_jax_tp(tiny, worlds, n_model):
    params, port, x = tiny
    enc = JEncoder(tp_axis="model", dtype=BF16, **TINY)
    expect = _on_mesh(n_model, params, enc.apply, x)
    with torch.no_grad():
        unsharded = port(torch.from_numpy(x)).float().numpy()
    assert 0.5 < np.abs(expect).max() < 1.0
    for r in worlds[n_model]:
        assert r["local_heads"] == TINY["num_heads"] // n_model
        assert np.abs(r["emb"] - expect).max() <= TINY_TP_ATOL
        assert np.abs(r["emb"] - unsharded).max() <= TINY_UNSHARDED_ATOL
        np.testing.assert_array_equal(r["emb"], worlds[n_model][0]["emb"])


def test_bf16_vit_h_block_against_jax_f13(monkeypatch):
    c, heads, g = VIT_H["dim"], VIT_H["heads"], VIT_H["grid"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, g, g, c)).astype(np.float32)
    block = JBlock(num_heads=heads, window_size=0, input_size=(g, g),
                   dtype=BF16)
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, g, g, c), BF16))
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(
            (path[-1].key == "scale")
            + (0.1 if path[-1].key == "scale" else 0.02)
            * rng.standard_normal(leaf.shape), jnp.float32), shapes)
    expect = np.asarray(jax.jit(block.apply)(
        params, jnp.asarray(x, BF16)).astype(jnp.float32))
    p = params["params"]
    sd = {f"attn.{k}": v for k, v in
          attention_state_dict_from_jax(p["attn"], c // heads).items()}
    for name in ("norm1", "norm2"):
        sd[f"{name}.weight"] = torch.tensor(np.asarray(p[name]["scale"]))
        sd[f"{name}.bias"] = torch.tensor(np.asarray(p[name]["bias"]))
    for name in ("lin1", "lin2"):
        sd[f"mlp.{name}.weight"] = torch.tensor(
            np.asarray(p[f"mlp_{name}"]["kernel"]).T)
        sd[f"mlp.{name}.bias"] = torch.tensor(
            np.asarray(p[f"mlp_{name}"]["bias"]))
    port = TBlock(c, heads, 4.0, (g, g), raw_qkv=False)
    port.load_state_dict(sd)
    port = port.to(torch.bfloat16).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(torch.bfloat16).reshape(
            1, g * g, c), (g, g)).float().numpy().reshape(expect.shape)
    err = np.abs(got - expect)
    assert np.abs(expect).max() > 4.0
    assert err.max() <= F13_ATOL
    rel = np.linalg.norm(err) / np.linalg.norm(expect)
    assert rel < F13_REL_L2
    # F13's share: with every linear rounding twice, as the JAX `Dense`
    # does, the block comes closer, but not much (found 3.90e-3).
    monkeypatch.setattr(torch.nn.Linear, "forward", lambda self, x: (
        F.linear(x, self.weight) + self.bias))
    with torch.no_grad():
        twice = port(torch.from_numpy(x).to(torch.bfloat16).reshape(
            1, g * g, c), (g, g)).float().numpy().reshape(expect.shape)
    rel_twice = np.linalg.norm(twice - expect) / np.linalg.norm(expect)
    assert 0.8 * rel < rel_twice < rel
