"""SuperGlue in the port (`sam_pt_torch/models/tracker/superglue/
superglue.py`) against the JAX package's, in float32, at the published
widths (256 wide, 9 self/cross pairs, 4 heads) with 20 Sinkhorn
iterations and K = 96 keypoints an image.

Weights: a random `superglue_outdoor.pth`-namespace state dict
(`torch_port_helpers.random_superglue_state_dict`), loaded by the port as
it is; the JAX side gets it through `convert_superglue_state_dict` with
the heads moved to its layout first (`jax_head_layout`): F9, the JAX
package splits heads contiguously where magicleap interleaves them.

Tolerances: the Sinkhorn and the attention block 1e-5; the whole
matcher's log transport plan 2e-3 + 1e-4 |ref| over the valid rows and
columns and the dustbins (its entries reach 320 in magnitude, and the
float32 sums of 18 propagations differ by up to 1e-4 of them), matching scores (exp of the
plan's entries) 1e-3, matches equal. The test asserts on its
inputs that every valid row's and column's two largest entries lie
further apart than twice the sides' difference (the pair seed is chosen
for it), and that no matching score lies within 1e-3 of the threshold.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_pt_torch.models.tracker.superglue import superglue as tsg
from sam_pt_torch.utils import checkpoint as tckpt
from sam_pt_tpu.models.tracker.superglue import superglue as jsg
from sam_pt_tpu.utils.checkpoint import convert_superglue_state_dict
from torch_port_helpers import (MARGIN, jax_head_layout,
                                random_superglue_state_dict, save_pth,
                                torch_sd)

torch.set_num_threads(1)

K = 96
HW = (96, 128)
ITERS = 20
PLAN_ATOL, PLAN_RTOL = 2e-3, 1e-4


@pytest.fixture(scope="module")
def matcher():
    sd = random_superglue_state_dict(seed=31, proj_scale=16.0)
    model = tsg.SuperGlue(sinkhorn_iterations=ITERS)
    model.load_state_dict(torch_sd(sd))
    params = convert_superglue_state_dict(jax_head_layout(sd))
    return sd, model.eval(), params


def _pair_inputs(seed: int, b: int = 2):
    """b pairs: image 1's keypoints a permutation of image 0's moved by
    2 px, its descriptors image 0's plus noise; some slots invalid."""
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("keypoints0", "keypoints1", "scores0", "scores1",
                           "valid0", "valid1", "descriptors0",
                           "descriptors1")}
    for _ in range(b):
        kp = rng.uniform([0, 0], [HW[1], HW[0]], (K, 2)).astype(np.float32)
        d = rng.standard_normal((K, 256)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        p = rng.permutation(K)
        valid = rng.uniform(size=K) > 0.15
        out["keypoints0"].append(kp)
        out["keypoints1"].append(kp[p] + 2.0)
        out["scores0"].append(rng.uniform(0, 1, K).astype(np.float32))
        out["scores1"].append(rng.uniform(0, 1, K).astype(np.float32))
        out["valid0"].append(valid)
        out["valid1"].append(valid[p] & (rng.uniform(size=K) > 0.1))
        d1 = d[p] + 0.15 * rng.standard_normal((K, 256))
        out["descriptors0"].append(d)
        out["descriptors1"].append((d1 / np.linalg.norm(
            d1, axis=1, keepdims=True)).astype(np.float32))
    return {k: np.stack(v) for k, v in out.items()}


def _jax_matcher(params, data, monkeypatch):
    """The JAX matcher's outputs and its log transport plan (kept from
    its `log_sinkhorn` call; eager, so that the plan is concrete)."""
    plans = []

    def keep(scores, alpha, iters):
        z = log_sinkhorn(scores, alpha, iters)
        plans.append(np.asarray(z))
        return z

    log_sinkhorn = jsg.log_sinkhorn
    monkeypatch.setattr(jsg, "log_sinkhorn", keep)
    out = jsg.SuperGlue(sinkhorn_iterations=ITERS).apply(
        params, dict(data, image_shape=HW))
    monkeypatch.setattr(jsg, "log_sinkhorn", log_sinkhorn)
    return {k: np.asarray(v) for k, v in out.items()}, plans[0]


def _port(model, data):
    with torch.no_grad():
        return {k: v.numpy() for k, v in model(dict(
            {k: torch.from_numpy(v) for k, v in data.items()},
            image_shape=HW)).items()}


def test_sinkhorn_matches_jax():
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((2, 7, 9)).astype(np.float32) * 3
    got = tsg.log_sinkhorn(torch.from_numpy(scores), torch.tensor(0.5),
                           ITERS).numpy()
    for i in range(2):
        ref = np.asarray(jsg.log_sinkhorn(jnp.asarray(scores[i]),
                                          jnp.float32(0.5), ITERS))
        np.testing.assert_allclose(got[i], ref, atol=1e-5, rtol=0)


def test_normalize_keypoints_matches_jax():
    kp = np.random.default_rng(1).uniform(0, 100, (3, 5, 2)).astype(
        np.float32)
    got = tsg.normalize_keypoints(torch.from_numpy(kp), (50, 100)).numpy()
    ref = np.asarray(jsg.normalize_keypoints(jnp.asarray(kp), (50, 100)))
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)


def test_attention_head_layout_f9():
    """One magicleap attention block (4 heads x 64, 48 queries against 64
    keys, 8 of them invalid): the port equals the JAX block on the
    converter's weights with the heads permuted to its layout, and differs
    from it on the converter's weights as they are (F9)."""
    rng = np.random.default_rng(5)
    block = tsg.MultiHeadedAttention(4, 256)
    sd = {k: (rng.standard_normal(v.shape) * 256 ** -0.5).astype(np.float32)
          for k, v in block.state_dict().items()}
    block.load_state_dict(torch_sd(sd))
    x = rng.standard_normal((1, 256, 48)).astype(np.float32)
    src = rng.standard_normal((1, 256, 64)).astype(np.float32)
    valid = np.ones((1, 64), bool)
    valid[0, -8:] = False
    with torch.no_grad():
        got = block(*(torch.from_numpy(a) for a in (x, src, src)),
                    torch.from_numpy(valid))[0].numpy().T

    def jax_block(state):
        names = {"proj.0": "q_proj", "proj.1": "k_proj", "proj.2": "v_proj",
                 "merge": "merge"}
        p = {names[k.rsplit(".", 1)[0]]: {} for k in state}
        for k, v in state.items():
            mod, leaf = k.rsplit(".", 1)
            p[names[mod]]["kernel" if leaf == "weight" else "bias"] = (
                v[:, :, 0].T if leaf == "weight" else v)
        return np.asarray(jsg.MultiHeadAttention().apply(
            {"params": p}, x[0].T, src[0].T, valid[0]))

    permuted = jax_head_layout({f"gnn.layers.0.attn.{k}": v
                                for k, v in sd.items()})
    ref = jax_block({k.removeprefix("gnn.layers.0.attn."): v
                     for k, v in permuted.items()})
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert np.abs(got - jax_block(sd)).max() > 1e-2  # F9 as converted


def test_matcher_matches_jax(matcher, monkeypatch):
    sd, model, params = matcher
    data = _pair_inputs(11)
    got = _port(model, data)
    for i in range(data["valid0"].shape[0]):
        ref, ref_plan = _jax_matcher(params, {k: v[i] for k, v in
                                              data.items()}, monkeypatch)
        with torch.no_grad():
            plan = model.log_transport(dict(
                {k: torch.from_numpy(v[i:i + 1]) for k, v in data.items()},
                image_shape=HW))[0].numpy()
        v0, v1 = data["valid0"][i], data["valid1"][i]
        rows = np.r_[np.nonzero(v0)[0], K]
        cols = np.r_[np.nonzero(v1)[0], K]
        np.testing.assert_allclose(plan[np.ix_(rows, cols)],
                                   ref_plan[np.ix_(rows, cols)], atol=PLAN_ATOL,
                                   rtol=PLAN_RTOL)
        np.testing.assert_array_equal(got["matches0"][i], ref["matches0"])
        np.testing.assert_allclose(got["matching_scores0"][i],
                                   ref["matching_scores0"], atol=1e-3,
                                   rtol=0)
        # margins of the mutual max and of the threshold
        inner = ref_plan[:K, :K][np.ix_(v0, v1)]
        diff = np.abs(plan - ref_plan)[:K, :K][np.ix_(v0, v1)].max()
        for axis in (0, 1):
            top2 = np.sort(inner, axis=axis).take([-2, -1], axis=axis)
            gap = np.diff(top2, axis=axis)
            assert gap.min() > 2 * diff
        assert np.abs(got["matching_scores0"][i]
                      - model.match_threshold).min() > MARGIN
        matched = got["matches0"][i] > -1
        assert matched.sum() >= 10 and not matched[~v0].any()
        assert set(got["matches0"][i][matched]) <= set(np.nonzero(v1)[0])


def test_invalid_slots_do_not_reach_the_valid_ones(matcher):
    """Invalid slots are masked out of attention and out of the transport
    problem: their keypoints and descriptors change nothing else."""
    _, model, _ = matcher
    data = _pair_inputs(8, b=1)
    other = {k: v.copy() for k, v in data.items()}
    rng = np.random.default_rng(9)
    for i in (0, 1):
        bad = ~other[f"valid{i}"][0]
        other[f"keypoints{i}"][0, bad] = rng.uniform(0, 90, (bad.sum(), 2))
        other[f"descriptors{i}"][0, bad] = rng.standard_normal(
            (bad.sum(), 256))
    a, b = _port(model, data), _port(model, other)
    np.testing.assert_array_equal(a["matches0"], b["matches0"])
    v0, v1 = data["valid0"][0], data["valid1"][0]
    rows, cols = np.r_[np.nonzero(v0)[0], K], np.r_[np.nonzero(v1)[0], K]
    np.testing.assert_allclose(a["log_transport"][0][np.ix_(rows, cols)],
                               b["log_transport"][0][np.ix_(rows, cols)],
                               atol=1e-4, rtol=0)


def test_batched_pairs_equal_single_pairs(matcher):
    _, model, _ = matcher
    data = _pair_inputs(10, b=3)
    whole = _port(model, data)
    for i in range(3):
        one = _port(model, {k: v[i:i + 1] for k, v in data.items()})
        np.testing.assert_array_equal(one["matches0"][0],
                                      whole["matches0"][i])
        np.testing.assert_allclose(one["matching_scores0"][0],
                                   whole["matching_scores0"][i], atol=1e-6,
                                   rtol=0)


def test_public_file_loads_as_it_is_and_the_carrier_round_trips(
        matcher, tmp_path):
    """A magicleap-namespace file (with BatchNorm's step counters) loads
    strictly with no key renamed; a file missing a key raises, naming it;
    the JAX tree of the file (heads in its layout) comes back through
    `superglue_state_dict_from_jax` as the file's own dict."""
    from sam_pt_torch.models.tracker.superglue.superpoint import SuperPoint

    sd, _, params = matcher
    sp = SuperPoint()
    sp_path = str(tmp_path / "sp.pth")
    torch.save(sp.state_dict(), sp_path)
    model = tsg.SuperGlue()
    tckpt.load_superglue_checkpoint(
        sp_path, save_pth(tmp_path / "sg.pth", sd, counters=True), sp, model)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    short = {k: v for k, v in sd.items() if k != "gnn.layers.3.mlp.1.bias"}
    with pytest.raises(ValueError, match="gnn.layers.3.mlp.1.bias"):
        tckpt.load_superglue_checkpoint(
            sp_path, save_pth(tmp_path / "short.pth", short), sp, model)
    back = tckpt.superglue_state_dict_from_jax(params)
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k])
    assert os.path.getsize(sp_path) > 0
