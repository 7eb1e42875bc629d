"""JAX -> port weight converters: exact round trips through the JAX
package's own converters, and refusal of trees they did not produce."""
import jax
import numpy as np
import pytest
import torch

import sam_pt_tpu.utils.testing  # noqa: F401  (registers vit_tiny_test)
from sam_pt_torch.utils.checkpoint import (
    attention_state_dict_from_jax,
    cotracker_state_dict_from_jax,
    sam_state_dict_from_jax,
)
from sam_pt_tpu.utils.checkpoint import (
    _pad_attn_heads,
    convert_cotracker_state_dict,
    convert_sam_state_dict,
)
from torch_port_helpers import (
    TINY_COTRACKER,
    random_cotracker_state_dict,
    random_sam_state_dict,
)

torch.set_num_threads(1)


def _assert_same(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


class TestSamRoundTrip:
    def test_tiny(self):
        sd = random_sam_state_dict(seed=3)
        _assert_same(sam_state_dict_from_jax(convert_sam_state_dict(sd)), sd)

    def test_vith_key_set_with_padded_global_blocks(self):
        """ViT-H's depth, global blocks (7/15/23/31) and head dim 80 at a
        narrow width: the JAX converter pads the global blocks' heads
        80 -> 128; the port's converter strips the pad exactly."""
        sd = random_sam_state_dict(seed=4, embed_dim=160, depth=32, heads=2,
                                   grid=64, window=14,
                                   global_idx=(7, 15, 23, 31))
        params = convert_sam_state_dict(sd)
        enc = params["params"]["image_encoder"]
        assert enc["blocks_7"]["attn"]["rel_pos_h"].shape == (127, 128)
        assert enc["blocks_6"]["attn"]["rel_pos_h"].shape == (27, 80)
        _assert_same(sam_state_dict_from_jax(params), sd)

    def test_nonzero_pad_lane_raises(self):
        sd = random_sam_state_dict(seed=5, embed_dim=160, depth=32, heads=2,
                                   grid=64, window=14,
                                   global_idx=(7, 15, 23, 31))
        params = jax.tree_util.tree_map(np.array, convert_sam_state_dict(sd))
        params["params"]["image_encoder"]["blocks_15"]["attn"]["qkv"][
            "kernel"][0, 100] = 1.0  # a pad lane of head 0's q
        with pytest.raises(ValueError, match="pad lanes"):
            sam_state_dict_from_jax(params)


class TestAttentionRoundTrip:
    @pytest.mark.parametrize("padded", [False, True])
    def test_one_attention(self, padded):
        """One Attention's params, as the JAX module holds them with its
        defaults or with the head dim padded 80 -> 128 in its weights."""
        rng = np.random.default_rng(7)
        c, heads = 160, 2
        w = [rng.standard_normal(s).astype(np.float32) for s in
             ((c, 3 * c), (3 * c,), (c, c), (15, 80), (15, 80))]
        stored = _pad_attn_heads(*w, num_heads=heads) if padded else w
        proj_b = rng.standard_normal(c).astype(np.float32)
        params = {"qkv": {"kernel": stored[0], "bias": stored[1]},
                  "proj": {"kernel": stored[2], "bias": proj_b},
                  "rel_pos_h": stored[3], "rel_pos_w": stored[4]}
        _assert_same(attention_state_dict_from_jax(params, 80, prefix="a."), {
            "a.qkv.weight": w[0].T, "a.qkv.bias": w[1],
            "a.proj.weight": w[2].T, "a.proj.bias": proj_b,
            "a.rel_pos_h": w[3], "a.rel_pos_w": w[4]})


class TestCoTrackerRoundTrip:
    @pytest.mark.parametrize("cfg", ["tiny", "published"])
    def test_round_trip(self, cfg):
        kwargs = TINY_COTRACKER if cfg == "tiny" else {}
        sd = random_cotracker_state_dict(seed=6, **kwargs)
        prefixed = {f"model.{k}": v for k, v in sd.items()}
        params = convert_cotracker_state_dict(prefixed)
        assert len(jax.tree_util.tree_leaves(params)) == len(sd)
        _assert_same(cotracker_state_dict_from_jax(params), sd)
