"""Shared fixtures for the port's parity tests (`test_torch_*.py`).

Weights start as random state dicts in the public checkpoint namespaces
(`segment_anything` SAM, CoTracker v1, PIPS, PIPS++, raft-things; TAPIR's
and TapNet's haiku module names), made with numpy from a seed. The
JAX side gets them through the JAX package's own converters; the port loads
them as they are or through `sam_pt_torch.utils.checkpoint`.
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

TINY_COTRACKER = dict(s=4, stride=4, latent_dim=16, input_dim=456,
                      hidden_size=32, num_heads=2, space_depth=1,
                      time_depth=2)


def random_sam_state_dict(seed: int = 0, embed_dim: int = 32, depth: int = 2,
                          heads: int = 2, grid: int = 4, window: int = 2,
                          global_idx: Sequence[int] = (1,), pdim: int = 256,
                          std: float = 0.5) -> Dict[str, np.ndarray]:
    """A SAM state dict (numpy float32) with `segment_anything` keys."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    hd = embed_dim // heads

    def add(key, *shape, scale=std):
        sd[key] = (rng.standard_normal(shape) * scale).astype(np.float32)

    def add_ln(key, dim):
        sd[f"{key}.weight"] = (1.0 + 0.1 * rng.standard_normal(dim)).astype(
            np.float32)
        sd[f"{key}.bias"] = (0.1 * rng.standard_normal(dim)).astype(np.float32)

    def add_lin(key, out_dim, in_dim):
        add(f"{key}.weight", out_dim, in_dim, scale=in_dim ** -0.5)
        add(f"{key}.bias", out_dim, scale=0.1)

    enc = "image_encoder"
    add(f"{enc}.patch_embed.proj.weight", embed_dim, 3, 16, 16, scale=0.02)
    add(f"{enc}.patch_embed.proj.bias", embed_dim, scale=0.1)
    add(f"{enc}.pos_embed", 1, grid, grid, embed_dim, scale=0.1)
    for i in range(depth):
        b = f"{enc}.blocks.{i}"
        size = grid if i in global_idx else window
        add_ln(f"{b}.norm1", embed_dim)
        add_lin(f"{b}.attn.qkv", 3 * embed_dim, embed_dim)
        add_lin(f"{b}.attn.proj", embed_dim, embed_dim)
        add(f"{b}.attn.rel_pos_h", 2 * size - 1, hd, scale=0.1)
        add(f"{b}.attn.rel_pos_w", 2 * size - 1, hd, scale=0.1)
        add_ln(f"{b}.norm2", embed_dim)
        add_lin(f"{b}.mlp.lin1", 4 * embed_dim, embed_dim)
        add_lin(f"{b}.mlp.lin2", embed_dim, 4 * embed_dim)
    add(f"{enc}.neck.0.weight", pdim, embed_dim, 1, 1, scale=embed_dim ** -0.5)
    add_ln(f"{enc}.neck.1", pdim)
    add(f"{enc}.neck.2.weight", pdim, pdim, 3, 3, scale=(9 * pdim) ** -0.5)
    add_ln(f"{enc}.neck.3", pdim)

    pe = "prompt_encoder"
    add(f"{pe}.pe_layer.positional_encoding_gaussian_matrix", 2, pdim // 2,
        scale=1.0)
    for i in range(4):
        add(f"{pe}.point_embeddings.{i}.weight", 1, pdim)
    add(f"{pe}.not_a_point_embed.weight", 1, pdim)
    add(f"{pe}.no_mask_embed.weight", 1, pdim)
    md = f"{pe}.mask_downscaling"
    add(f"{md}.0.weight", 4, 1, 2, 2, scale=0.5)
    add(f"{md}.0.bias", 4, scale=0.1)
    add_ln(f"{md}.1", 4)
    add(f"{md}.3.weight", 16, 4, 2, 2, scale=0.25)
    add(f"{md}.3.bias", 16, scale=0.1)
    add_ln(f"{md}.4", 16)
    add(f"{md}.6.weight", pdim, 16, 1, 1, scale=0.25)
    add(f"{md}.6.bias", pdim, scale=0.1)

    tr = "mask_decoder.transformer"
    for i in range(2):
        layer = f"{tr}.layers.{i}"
        for name, dim in (("self_attn", pdim),
                          ("cross_attn_token_to_image", pdim // 2),
                          ("cross_attn_image_to_token", pdim // 2)):
            for proj in ("q_proj", "k_proj", "v_proj"):
                add_lin(f"{layer}.{name}.{proj}", dim, pdim)
            add_lin(f"{layer}.{name}.out_proj", pdim, dim)
        for j in range(1, 5):
            add_ln(f"{layer}.norm{j}", pdim)
        add_lin(f"{layer}.mlp.lin1", 2048, pdim)
        add_lin(f"{layer}.mlp.lin2", pdim, 2048)
    for proj in ("q_proj", "k_proj", "v_proj"):
        add_lin(f"{tr}.final_attn_token_to_image.{proj}", pdim // 2, pdim)
    add_lin(f"{tr}.final_attn_token_to_image.out_proj", pdim, pdim // 2)
    add_ln(f"{tr}.norm_final_attn", pdim)

    add("mask_decoder.iou_token.weight", 1, pdim)
    add("mask_decoder.mask_tokens.weight", 4, pdim)
    up = "mask_decoder.output_upscaling"
    add(f"{up}.0.weight", pdim, pdim // 4, 2, 2, scale=pdim ** -0.5)
    add(f"{up}.0.bias", pdim // 4, scale=0.1)
    add_ln(f"{up}.1", pdim // 4)
    add(f"{up}.3.weight", pdim // 4, pdim // 8, 2, 2, scale=(pdim // 4) ** -0.5)
    add(f"{up}.3.bias", pdim // 8, scale=0.1)
    for i in range(4):
        h = f"mask_decoder.output_hypernetworks_mlps.{i}"
        add_lin(f"{h}.layers.0", pdim, pdim)
        add_lin(f"{h}.layers.1", pdim, pdim)
        add_lin(f"{h}.layers.2", pdim // 8, pdim)
    for j, (o, i_) in enumerate(((256, pdim), (256, 256), (4, 256))):
        add_lin(f"mask_decoder.iou_prediction_head.layers.{j}", o, i_)
    return sd


def random_like(state: Dict[str, torch.Tensor], seed: int
                ) -> Dict[str, np.ndarray]:
    """Random float64 numpy arrays for a module's state dict (callers
    scale them, then cast with `as_float32`): biases and other 1-D tensors
    N(0, 0.1^2), except norm scales and running variances
    ~1 + N(0, 0.1^2); weights N(0, 1/fan_in). Keys the module registers
    twice (a BatchNorm under two names) share one array."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    seen: Dict[int, np.ndarray] = {}
    for key, value in state.items():
        if value.dtype not in (torch.float32, torch.float64):
            continue
        if value.data_ptr() in seen:
            sd[key] = seen[value.data_ptr()]
            continue
        if key.endswith(("running_var",)) or (
                value.ndim == 1 and not key.endswith(("bias",
                                                      "running_mean"))):
            arr = 1.0 + 0.1 * rng.standard_normal(value.shape)
        elif value.ndim == 1:
            arr = rng.standard_normal(value.shape) * 0.1
        else:
            fan_in = int(np.prod(value.shape[1:]))
            arr = rng.standard_normal(value.shape) * fan_in ** -0.5
        sd[key] = seen[value.data_ptr()] = arr
    return sd


def as_float32(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: v.astype(np.float32) for k, v in sd.items()}


def random_cotracker_state_dict(seed: int = 0, flow_head_scale: float = 1.0,
                                **cfg) -> Dict[str, np.ndarray]:
    """A CoTracker v1 state dict (numpy float32) for the given config,
    laid out by the port's own module. `flow_head_scale` shrinks the
    coordinate rows of the update head, so that random weights move points
    by small steps."""
    from sam_pt_torch.models.tracker.cotracker.model import CoTracker

    sd = random_like(CoTracker(**cfg).state_dict(), seed)
    for key in ("updateformer.flow_head.weight",
                "updateformer.flow_head.bias"):
        sd[key][:2] *= flow_head_scale
    return as_float32(sd)


def random_pips_state_dict(seed: int = 0, delta_scale: float = 0.05,
                           vis_bias: float = 2.0) -> Dict[str, np.ndarray]:
    """A public-namespace PIPS state dict (numpy float32) at the published
    widths (latent 128, mixer 512 x 12, S = 8). The coordinate outputs of
    the delta block are scaled by `delta_scale`, so that random weights
    move points by small steps; the visibility head's bias is `vis_bias`.
    The input columns of the flow embedding's sines and cosines are scaled
    by 0.01: their frequencies reach ~970 per pixel, so at full size they
    turn a coordinate's last-bit difference into an O(1e-2) input
    difference each refinement iteration, and float32 runs that differ in
    summation order part after a few iterations."""
    from sam_pt_torch.models.tracker.pips.model import Pips

    model = Pips()
    sd = random_like(model.state_dict(), seed)
    sd["delta_block.to_delta.0.weight"][:, 324:516] *= 0.01
    out = f"delta_block.to_delta.{len(model.delta_block.to_delta) - 1}"
    for key in (f"{out}.weight", f"{out}.bias"):
        rows = sd[key].reshape(8, 130, -1)
        rows[:, :2] *= delta_scale
    sd["vis_predictor.0.bias"][:] = vis_bias
    return as_float32(sd)


def random_pips2_state_dict(seed: int = 0, delta_scale: float = 0.05
                            ) -> Dict[str, np.ndarray]:
    """A public-namespace PIPS++ state dict (numpy float32) at the
    published widths; the delta head is scaled by `delta_scale`, so that
    random weights move points by small steps."""
    from sam_pt_torch.models.tracker.pips2.model import PipsPlusPlus

    sd = random_like(PipsPlusPlus().state_dict(), seed)
    for key in ("delta_block.dense.weight", "delta_block.dense.bias"):
        sd[key] *= delta_scale
    return as_float32(sd)


def random_raft_state_dict(seed: int = 0, flow_scale: float = 0.05
                           ) -> Dict[str, np.ndarray]:
    """A raft-things.pth-namespace state dict (numpy float32); the flow
    head's last conv is scaled by `flow_scale`, so that random weights
    give small flows."""
    from sam_pt_torch.models.tracker.raft.model import Raft

    sd = random_like(Raft().state_dict(), seed)
    for key in ("update_block.flow_head.conv2.weight",
                "update_block.flow_head.conv2.bias"):
        sd[key] *= flow_scale
    return as_float32(sd)


def random_hq_state_dict(seed: int = 0, vit_dim: int = 32,
                         pdim: int = 256) -> Dict[str, np.ndarray]:
    """The keys `segment_anything_hq` adds to a SAM state dict (numpy
    float32, `random_like`'s draws): the HQ token, its MLP and the three
    feature blocks, for early features of width `vit_dim`."""
    from sam_pt_torch.models.sam.mask_decoder_hq import MaskDecoderHQ

    state = MaskDecoderHQ(pdim, vit_dim).state_dict()
    extra = ("hf_token", "hf_mlp", "compress_vit_feat", "embedding_encoder",
             "embedding_maskfeature")
    sd = random_like({k: v for k, v in state.items()
                      if k.startswith(extra)}, seed)
    return {f"mask_decoder.{k}": v for k, v in as_float32(sd).items()}


def random_superpoint_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """A `superpoint_v1.pth`-namespace state dict (numpy float32):
    `random_like`'s draws with the weights scaled to N(0, 2/fan_in) and
    the biases to N(0, 0.01^2), so that the activations keep their scale
    through the ReLUs and the detector's cell logits vary with the image
    (with the biases larger, every cell keeps the same pixel)."""
    from sam_pt_torch.models.tracker.superglue.superpoint import SuperPoint

    sd = random_like(SuperPoint().state_dict(), seed)
    return as_float32({k: v * (0.1 if k.endswith(".bias") else 2 ** 0.5)
                       for k, v in sd.items()})


def random_superglue_state_dict(seed: int = 0, live: bool = True,
                                proj_scale: float = 32.0
                                ) -> Dict[str, np.ndarray]:
    """A `superglue_outdoor.pth`-namespace state dict (numpy float32,
    `random_like`'s draws, bin_score 1) at the published widths. With
    `live`, the propagations' last convs and the keypoint encoder's output
    conv are scaled by 0.3 and `final_proj` is `proj_scale` times the
    identity plus N(0, 0.05^2): the descriptors pass through the network
    mostly as they are and the transport plan is peaked, so that similar
    descriptors match (random weights give a near-uniform plan, which no
    match passes)."""
    from sam_pt_torch.models.tracker.superglue.superglue import SuperGlue

    rng = np.random.default_rng(seed + 1)
    sd = random_like(SuperGlue().state_dict(), seed)
    sd["bin_score"] = np.asarray(1.0)
    if live:
        for key in sd:
            if ".mlp.3." in key or key.startswith("kenc.encoder.12."):
                sd[key] = sd[key] * 0.3
        sd["final_proj.weight"] = (proj_scale * np.eye(256)[:, :, None]
                                   + 0.05 * rng.standard_normal((256, 256, 1)))
    return as_float32(sd)


def jax_head_layout(sd: Dict[str, np.ndarray], heads: int = 4
                    ) -> Dict[str, np.ndarray]:
    """A magicleap SuperGlue state dict with its attention channels moved
    to the JAX package's head layout (`h * 64 + d` from `d * 4 + h`: the
    inverse of the F9 permutation), so that the JAX converter's tree
    computes magicleap's function."""
    from sam_pt_torch.utils.checkpoint import head_permutation

    inv = np.argsort(head_permutation(256, heads))
    out = dict(sd)
    for key, value in sd.items():
        if ".attn.proj." in key:
            out[key] = value[inv]
        elif key.endswith(".attn.merge.weight"):
            out[key] = value[:, inv]
    return out


def save_pth(path, sd: Dict[str, np.ndarray], counters: bool = False) -> str:
    """`sd` as a public .pth (a dict of tensors); with `counters`, the
    BatchNorms' `num_batches_tracked` too, as torch saves them."""
    tensors = torch_sd(sd)
    if counters:
        for key in sd:
            if key.endswith(".running_mean"):
                tensors[key.replace("running_mean", "num_batches_tracked")] = (
                    torch.tensor(0))
    torch.save(tensors, str(path))
    return str(path)


def superglue_pair(folder, weights_seed: int = 0, **kwargs
                   ) -> Tuple[object, object]:
    """(JAX, port) SuperGlue trackers on one random magicleap checkpoint
    pair (`random_superpoint_state_dict`, the live
    `random_superglue_state_dict`): the port reads the .pth files written
    under `folder` as they are, the JAX tracker gets its converters' trees
    of the files with the heads in its layout; `kwargs` go to both."""
    import os

    from sam_pt_torch.models.tracker.superglue.tracker import (
        SuperGluePointTracker as TTracker,
    )
    from sam_pt_tpu.models.tracker.superglue.tracker import (
        SuperGluePointTracker as JTracker,
    )
    from sam_pt_tpu.utils.checkpoint import (convert_superglue_state_dict,
                                             convert_superpoint_state_dict)

    sp = random_superpoint_state_dict(weights_seed)
    sg = random_superglue_state_dict(weights_seed + 1)
    params = {"superpoint": convert_superpoint_state_dict(sp),
              "superglue": convert_superglue_state_dict(jax_head_layout(sg))}
    ttracker = TTracker(
        checkpoint_path=save_pth(os.path.join(folder, "sg.pth"), sg, True),
        superpoint_checkpoint_path=save_pth(os.path.join(folder, "sp.pth"),
                                            sp),
        device="cpu", **kwargs)
    return JTracker(params=params, **kwargs), ttracker


@functools.lru_cache(maxsize=None)
def _flax_leaves(name: str, kwargs: Tuple = ()):
    """(module path, leaf name, shape) of the parameters of the JAX package's
    TAPIR(**kwargs) or TAPNet(), from their init shapes (no weights are
    computed; kept, since tracing the full-width TAPIR takes seconds)."""
    import jax
    import jax.numpy as jnp

    from sam_pt_tpu.models.tracker.tapir.model import TAPIR
    from sam_pt_tpu.models.tracker.tapnet.model import TAPNet

    model = TAPIR(**dict(kwargs)) if name == "tapir" else TAPNet()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 256, 256, 3)), jnp.zeros((1, 3)))
    leaves = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key for k in path][1:]  # under "params"
        leaves.append((tuple(keys[:-1]), keys[-1], tuple(leaf.shape)))
    return tuple(leaves)


def _haiku_draw(rng, leaf: str, shape) -> np.ndarray:
    """Weights N(0, 1/fan_in), norm scales and variances 1 + N(0, 0.1^2),
    biases, offsets and means N(0, 0.1^2), float32."""
    if leaf in ("w", "kernel"):
        arr = rng.standard_normal(shape) * np.prod(shape[:-1]) ** -0.5
    elif leaf in ("scale", "var"):
        arr = 1.0 + 0.1 * rng.standard_normal(shape)
    else:
        arr = 0.1 * rng.standard_normal(shape)
    return arr.astype(np.float32)


def _tapir_haiku_module(mod) -> str:
    """The JAX TAPIR's module path -> the haiku module name its converter
    reads (`sam_pt_tpu/utils/checkpoint.py::_map_tapir_module`)."""
    import re

    if mod[0] == "resnet":
        if mod[1] == "initial_conv":
            return "tapir/~/resnet/~/initial_conv"
        g, b = re.fullmatch(r"group(\d)_block(\d)", mod[1]).groups()
        sub = mod[2].replace("norm_", "instancenorm_")
        return f"tapir/~/resnet/~/block_group_{g}/~/block_{b}/~/{sub}"
    if mod[0] == "pips_mixer":
        top = {"input_proj": "linear", "out_proj": "linear_1",
               "out_norm": "layer_norm"}
        if mod[1] in top:
            return f"tapir/~/pips_mlp_mixer/~/{top[mod[1]]}"
        i = int(mod[1].split("_")[1])
        sub = {"norm1": "layer_norm", "norm2": "layer_norm_1",
               "dw1": "mlp1_up", "dw2": "mlp1_up_1", "mlp2_up": "mlp2_up",
               "mlp2_down": "mlp2_down"}[mod[2]]
        block = "block" if i == 0 else f"block_{i}"
        return f"tapir/~/pips_mlp_mixer/~/{block}/~/{sub}"
    return f"tapir/~/{mod[0]}"


def random_tapir_haiku_params(seed: int = 0, pyramid_level: int = 1,
                              **model_kwargs
                              ) -> Dict[str, Dict[str, np.ndarray]]:
    """A TAPIR haiku params dict (module name -> {'w', 'b', 'scale',
    'offset'}, numpy float32), shaped as the JAX `TAPIR(pyramid_level=...,
    **model_kwargs)` initialises: at the published widths by default (the
    mixer's input projection 486 rows wide at level 0, 535 at level 1)."""
    rng = np.random.default_rng(seed)
    hk: Dict[str, Dict[str, np.ndarray]] = {}
    names = {"kernel": "w", "bias": "b", "scale": "scale",
             "offset": "offset"}
    kwargs = tuple(sorted(dict(model_kwargs,
                               pyramid_level=pyramid_level).items()))
    for mod, leaf, shape in _flax_leaves("tapir", kwargs):
        hk.setdefault(_tapir_haiku_module(mod), {})[names[leaf]] = (
            _haiku_draw(rng, leaf, shape))
    return hk


def random_tapnet_haiku_checkpoint(seed: int = 0) -> Dict[str, Dict]:
    """A TapNet haiku checkpoint {'params', 'state'} (numpy float32) at the
    published widths, shaped as the JAX `TAPNet` initialises, under the
    names its converter reads: the cost-volume convs as Conv3D kernels
    [1, kh, kw, in, out], each BatchNorm's scale and offset [1, 1, 1, C]
    and its moving averages in the state ('.../batch_norm/~/mean_ema'
    {'average', 'hidden', 'counter'})."""
    import re

    rng = np.random.default_rng(seed)
    params: Dict[str, Dict[str, np.ndarray]] = {}
    state: Dict[str, Dict[str, np.ndarray]] = {}
    bn_leaves = {"scale": "scale", "bias": "offset"}
    for mod, leaf, shape in _flax_leaves("tapnet"):
        arr = _haiku_draw(rng, leaf, shape)
        if mod[0] != "tsm_resnet":
            name = f"tap_net/~/{mod[0]}"
            if leaf == "kernel" and arr.ndim == 4:
                arr = arr[None]  # a Conv3D over one frame
            leaf = {"kernel": "w", "bias": "b"}[leaf]
            params.setdefault(name, {})[leaf] = arr
            continue
        if mod[1] == "initial_conv":
            name = "tap_net/~/tsm_resnet_video/~/tsm_resnet_stem"
            params.setdefault(name, {})["w"] = arr
            continue
        u, b = re.fullmatch(r"unit(\d)_block(\d)", mod[1]).groups()
        sub = {"bn_pre": "batch_norm", "bn_1": "batch_norm_1"}.get(mod[2],
                                                                    mod[2])
        name = (f"tap_net/~/tsm_resnet_video/~/tsm_resnet_unit_{u}/~/"
                f"block_{b}/~/{sub}")
        if leaf == "kernel":
            params.setdefault(name, {})["w"] = arr
        elif leaf in bn_leaves:
            params.setdefault(name, {})[bn_leaves[leaf]] = arr.reshape(
                1, 1, 1, -1)
        else:  # mean, var: the moving averages
            state[f"{name}/~/{leaf}_ema"] = {
                "average": arr.reshape(1, 1, 1, -1),
                "hidden": arr.reshape(1, 1, 1, -1),
                "counter": np.asarray(1000, np.int32)}
    return {"params": params, "state": state}


def save_npy(path, tree) -> str:
    """`tree` as the public checkpoints store it: a pickled dict in an
    .npy."""
    np.save(str(path), np.asarray(tree, dtype=object), allow_pickle=True)
    return str(path)


def torch_sd(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v.copy()) for k, v in sd.items()}


# The tiny SamPt of the orchestrator parity tests: tiny SAM (`vit_tiny_test`,
# 64-pixel input), the tiny CoTracker (one refinement iteration per window)
# or PIPS.
TINY_SAM_PT_SETTINGS = dict(
    sam_iou_threshold=0.0,
    positive_point_selection_method="kmedoids",
    negative_point_selection_method="mixed",
    positive_points_per_mask=4,
    negative_points_per_mask=1,
    add_other_objects_positive_points_as_negative_points=True,
    iterative_refinement_iterations=3,
    sam_decode_chunk=8,
    sam_encode_chunk=4,
)
TINY_TRACKER = dict(interp_shape=(32, 40), visibility_threshold=0.5,
                    support_grid_size=2, support_grid_every_n_frames=6,
                    iters=1)


def tiny_sam_pt_pair(tracker: str = "cotracker", hq: bool = False,
                     trackers=None, **settings) -> Tuple[object, object]:
    """(JAX SamPt, port SamPt) on the same random weights, float32: the
    tiny SAM (seed 17; with `hq`, HQ-SAM's decoder, seed 19) and, by
    `tracker`, the tiny CoTracker (seed 18, most points visible), PIPS at
    its published widths (seed 18, stride 4, points visible), TAPIR or
    TapNet at theirs (`haiku_tracker_pair`, seed 18), SuperGlue
    (`tiny_superglue_pair`), or the (JAX, port)
    `trackers` given; TINY_SAM_PT_SETTINGS updated by `settings`."""
    import sam_pt_tpu.utils.testing as jtesting
    from sam_pt_torch.models.sam.predictor import SamPredictor as TPredictor
    from sam_pt_torch.models.sam.sam_model import Sam as TSam
    from sam_pt_torch.models.sam_pt import SamPt as TSamPt
    from sam_pt_torch.utils.checkpoint import sam_state_dict_from_jax
    from sam_pt_tpu.models.sam.predictor import SamPredictor as JPredictor
    from sam_pt_tpu.models.sam.sam_model import Sam as JSam
    from sam_pt_tpu.models.sam_pt import SamPt as JSamPt
    from sam_pt_tpu.utils.checkpoint import convert_sam_state_dict

    settings = dict(TINY_SAM_PT_SETTINGS, **settings)
    sd = random_sam_state_dict(seed=17)
    if hq:
        sd.update(random_hq_state_dict(seed=19, vit_dim=32))
    sam_params = convert_sam_state_dict(sd)
    jtracker, ttracker = trackers or {
        "cotracker": tiny_cotracker_pair, "pips": pips_pair,
        "superglue": lambda: tiny_superglue_pair(settings)}.get(
        tracker, lambda: haiku_tracker_pair(tracker, seed=18))()
    jpredictor = JPredictor(
        JSam(encoder_variant="vit_tiny_test", image_size=64, use_hq=hq),
        sam_params)
    jsampt = JSamPt(jtracker, jpredictor, **settings)

    tsam = TSam(jtesting.TINY_VIT, image_size=64, use_hq=hq)
    tsam.load_state_dict(sam_state_dict_from_jax(sam_params))
    tsampt = TSamPt(ttracker, TPredictor(tsam.eval().requires_grad_(False)),
                    **settings)
    return jsampt, tsampt


def tiny_superglue_pair(settings) -> Tuple[object, object]:
    """(JAX, port) SuperGlue trackers (`superglue_pair`, weights seed 18)
    with SamPt's points per mask from `settings`, K = 96 keypoints and 20
    Sinkhorn iterations, the matcher at its published widths."""
    import tempfile

    with tempfile.TemporaryDirectory() as folder:
        return superglue_pair(
            folder, weights_seed=18, max_keypoints=96,
            sinkhorn_iterations=20,
            positive_points_per_mask=settings["positive_points_per_mask"],
            negative_points_per_mask=settings["negative_points_per_mask"])


def tiny_cotracker_pair():
    """(JAX, port) tiny CoTracker trackers on one random state dict."""
    from sam_pt_torch.models.tracker.cotracker.model import (
        CoTracker as TCoTracker,
    )
    from sam_pt_torch.models.tracker.cotracker.tracker import (
        CoTrackerPointTracker as TTracker,
    )
    from sam_pt_torch.utils.checkpoint import cotracker_state_dict_from_jax
    from sam_pt_tpu.models.tracker.cotracker.model import (
        CoTracker as JCoTracker,
    )
    from sam_pt_tpu.models.tracker.cotracker.tracker import (
        CoTrackerPointTracker as JTracker,
    )
    from sam_pt_tpu.utils.checkpoint import convert_cotracker_state_dict

    cot_sd = random_cotracker_state_dict(seed=18, flow_head_scale=0.05,
                                         **TINY_COTRACKER)
    cot_sd["vis_predictor.0.bias"][:] = 2.0  # most points visible
    cot_params = convert_cotracker_state_dict(cot_sd)
    jtracker = JTracker(params=cot_params, s=4, stride=4, **TINY_TRACKER)
    jtracker.model = JCoTracker(**TINY_COTRACKER)
    tcot = TCoTracker(**TINY_COTRACKER)
    tcot.load_state_dict(cotracker_state_dict_from_jax(cot_params))
    return jtracker, TTracker(model=tcot.eval().requires_grad_(False),
                              **TINY_TRACKER)


def pips_pair():
    """(JAX, port) PIPS trackers (stride 4) on one random public-namespace
    state dict, the port's loaded as it is."""
    from sam_pt_torch.models.tracker.pips.tracker import (
        PipsPointTracker as TTracker,
    )
    from sam_pt_tpu.models.tracker.pips.tracker import (
        PipsPointTracker as JTracker,
    )
    from sam_pt_tpu.utils.checkpoint import convert_pips_state_dict

    sd = random_pips_state_dict(seed=18, vis_bias=3.0)
    ttracker = TTracker(stride=4, allow_random_init=True, device="cpu")
    ttracker.model.load_state_dict(torch_sd(sd))
    return JTracker(params=convert_pips_state_dict(sd), stride=4), ttracker


def haiku_tracker_pair(name: str, seed: int = 0, **kwargs
                       ) -> Tuple[object, object]:
    """(JAX, port) TAPIR or TapNet trackers (`name`) at the published
    widths on one random haiku checkpoint, written as an .npy and read by
    each side's own reader; `kwargs` go to both constructors."""
    import os
    import tempfile

    if name == "tapir":
        from sam_pt_torch.models.tracker.tapir.tracker import (
            TapirPointTracker as TTracker,
        )
        from sam_pt_tpu.models.tracker.tapir.tracker import (
            TapirPointTracker as JTracker,
        )
        tree = random_tapir_haiku_params(seed)
    else:
        from sam_pt_torch.models.tracker.tapnet.tracker import (
            TapNetPointTracker as TTracker,
        )
        from sam_pt_tpu.models.tracker.tapnet.tracker import (
            TapNetPointTracker as JTracker,
        )
        tree = random_tapnet_haiku_checkpoint(seed)
    with tempfile.TemporaryDirectory() as folder:
        path = save_npy(os.path.join(folder, f"{name}.npy"), tree)
        jtracker = JTracker(checkpoint_path=path, **kwargs)
        ttracker = TTracker(checkpoint_path=path, device="cpu", **kwargs)
    return jtracker, ttracker


def tiny_interactive_pair(tracker: str = "cotracker", **settings
                          ) -> Tuple[object, object]:
    """(JAX SamPtInteractive, port SamPtInteractive) on the weights of
    `tiny_sam_pt_pair(tracker)`, with TINY_SAM_PT_SETTINGS updated by
    `settings` (SamPt's keys and SamPtInteractive's)."""
    from sam_pt_torch.models.sam_pt_interactive import (
        SamPtInteractive as TInteractive,
    )
    from sam_pt_tpu.models.sam_pt_interactive import (
        SamPtInteractive as JInteractive,
    )

    jsampt, tsampt = tiny_sam_pt_pair(tracker)
    settings = dict(TINY_SAM_PT_SETTINGS, **settings)
    return (JInteractive(point_tracker=jsampt.point_tracker,
                         sam_predictor=jsampt.sam_predictor, **settings),
            TInteractive(point_tracker=tsampt.point_tracker,
                         sam_predictor=tsampt.sam_predictor, **settings))


def smooth_video(t: int = 6, h: int = 48, w: int = 64,
                 seed: int = 16) -> np.ndarray:
    """[t, h, w, 3] uint8: a smooth colour pattern moving 2 pixels a frame
    to the right, plus noise of std 4, so that a point's patches stay
    similar from frame to frame where it follows the pattern."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 7.0 + k) * np.cos(yy / 9.0 + k)
                     for k in range(3)], -1)
    frames = [np.roll(base, 2 * i, axis=1) + rng.normal(0, 4, (h, w, 3))
              for i in range(t)]
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


def textured_video(t: int = 4, h: int = 96, w: int = 128, seed: int = 0,
                   block: int = 4, step: int = 2) -> np.ndarray:
    """[t, h, w, 3] uint8: `block` x `block` squares of random colour
    moving `step` pixels a frame to the right, plus noise of +-8, so that
    SuperPoint's keypoints and descriptors follow the texture."""
    rng = np.random.default_rng(seed)
    texture = rng.integers(0, 255, (h // block + 2, w // block + 2, 3))
    texture = texture.repeat(block, 0).repeat(block, 1)
    frames = [np.roll(texture, step * i, axis=1)[:h, :w]
              + rng.integers(-8, 8, (h, w, 3)) for i in range(t)]
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


# Assertions shared by the TAPIR and TapNet parity tests: the SamPt pair's
# tolerances are test_torch_default_model.py's; no score the tests compare
# with a threshold may lie within MARGIN of it.
MARGIN = 1e-3
LOGIT_ATOL = 2e-2


def tree_equal(a, b):
    """Two nested dicts of arrays are equal, key for key."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k])


def flax_params(module, rng, *shapes):
    """A flax module's initial parameters for inputs of `shapes`, each
    moved by N(0, 0.1^2) (so that norm scales and biases are not 1 and
    0), as numpy."""
    import jax
    import jax.numpy as jnp

    params = module.init(jax.random.PRNGKey(0),
                         *(jnp.zeros(s) for s in shapes))
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(
            np.float32), params)


def assert_argmax_margins(got, ref):
    """The two largest logits of each heatmap lie further apart than the
    two sides' logits differ, so the argmax is the same on both."""
    top2 = np.sort(ref, axis=-1)[..., -2:]
    diff = np.abs(got - ref).max(-1)
    assert np.all(top2[..., 1] - top2[..., 0] > 2 * diff), (
        (top2[..., 1] - top2[..., 0]).min(), diff.max())
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def assert_visibility_margins(scores, threshold):
    assert np.abs(scores - threshold).min() > MARGIN


def sam_pt_video():
    """4 frames of 48 x 64, query masks of two objects on frames 0 and 3
    (with 4 points a mask, the trackers' T = 4 and N = 8 are the other
    TAPIR / TapNet tests' shapes)."""
    rng = np.random.default_rng(16)
    t, h, w = 4, 48, 64
    masks = np.zeros((2, h, w), np.float32)
    masks[0, 10:25, 8:30] = 1
    masks[1, 28:45, 35:60] = 1
    return {"image": rng.integers(0, 255, (t, h, w, 3)).astype(np.uint8),
            "target_hw": (96, 128), "query_masks": masks,
            "query_point_timestep": np.array([0, 3], np.float32)}


def assert_sam_pt_pair(video, jout, tout):
    """The SamPt pair's outputs, as test_torch_default_model.py holds
    them: trajectories 1e-3 px, equal visibilities, IoU scores 1e-4,
    float16 logits LOGIT_ATOL, fused labels equal away from the decision
    boundaries."""
    from sam_pt_torch.vos_eval.eval import device_fuse_index_masks as t_fuse
    from sam_pt_tpu.vos_eval.eval import device_fuse_index_masks as j_fuse

    assert tout["trajectories"].shape == np.asarray(
        jout["trajectories"]).shape
    np.testing.assert_allclose(tout["trajectories"].numpy(),
                               np.asarray(jout["trajectories"]), atol=1e-3,
                               rtol=0)
    np.testing.assert_array_equal(tout["visibilities"].numpy(),
                                  np.asarray(jout["visibilities"]))
    for key in ("scores_per_frame", "scores"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   atol=1e-4, rtol=0)
    got = tout["logits"].float().numpy()
    ref = np.asarray(jout["logits"], np.float32)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    finite = np.isfinite(ref)
    assert finite.any()
    np.testing.assert_allclose(got[finite], ref[finite], atol=LOGIT_ATOL,
                               rtol=1e-3)
    ts = [int(x) for x in video["query_point_timestep"]]
    gt = video["query_masks"].repeat(2, axis=1).repeat(2, axis=2)
    top2 = np.sort(np.maximum(ref, -1e4), axis=0)[-2:]
    near = (np.abs(ref) < LOGIT_ATOL).any(0) | (
        top2[1] - top2[0] < LOGIT_ATOL)
    assert np.array_equal(t_fuse(tout["logits"], gt, ts)[~near],
                          j_fuse(jout["logits"], gt, ts)[~near])
