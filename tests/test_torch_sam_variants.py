"""The six SAM variants of the CLI's `model/sam@model.sam_predictor=<v>`
override (`docs/04-running-experiments.md`) in the port: each composes
from `sam_pt_torch/configs/` as the JAX package composes it from
`configs/` (its `_target_`s naming the port, `device` set aside), binds
its keys, and the new ones build on the CPU on random weights
(`build_predictor`, `build_sam_pt`)."""
import inspect
import warnings

import pytest
import torch

from sam_pt_torch.build import build_sam_pt
from sam_pt_torch.config import compose, core, instantiate
from sam_pt_torch.config import resolve_interpolations
from sam_pt_torch.models.sam.factory import build_predictor
from sam_pt_torch.models.sam.mask_decoder_hq import MaskDecoderHQ
from sam_pt_torch.models.sam.tiny_vit import TinyViT
from sam_pt_torch.vos_eval.eval import CONFIG_DIR
from sam_pt_tpu.config import compose as j_compose
from test_torch_config import CWD, JAX_CONFIGS, _as_port, _without_device

torch.set_num_threads(1)

# variant config -> (variant, hq), and the extra overrides of the docs
VARIANTS = {
    "sam_vit_huge": ("vit_h", False, []),
    "sam_vit_large": ("vit_l", False, []),
    "sam_vit_base": ("vit_b", False, []),
    "samhq_vit_huge": ("vit_h", True, []),
    "samhq_light_vit_tiny": ("vit_t", True,
                             ["model.iterative_refinement_iterations=3"]),
    "sam_mobile_vit_tiny": ("vit_t", False,
                            ["model.iterative_refinement_iterations=3"]),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_composes_as_in_jax(name):
    variant, hq, extra = VARIANTS[name]
    overrides = ["model=sam_pt", f"model/sam@model.sam_predictor={name}",
                 *extra]
    got = compose(CONFIG_DIR, "vos_eval_root", overrides)
    ref = j_compose(JAX_CONFIGS, "vos_eval_root", overrides)
    assert _without_device(got) == _as_port(ref)
    node = resolve_interpolations(got, runtime_cwd=CWD)["model"][
        "sam_predictor"]
    assert (node["variant"], node.get("hq", False)) == (variant, hq)
    assert node["device"] == "cuda"
    fn = core._locate(node["_target_"])
    inspect.signature(fn).bind(**{k: v for k, v in node.items()
                                  if not k.startswith("_")})


@pytest.mark.parametrize("name", ["sam_mobile_vit_tiny",
                                  "samhq_light_vit_tiny"])
def test_tiny_variants_instantiate_on_the_cpu(name):
    cfg = resolve_interpolations(compose(CONFIG_DIR, "vos_eval_root", [
        "device=cpu", f"model/sam@model.sam_predictor={name}",
        "model.sam_predictor.allow_random_init=true"]), runtime_cwd=CWD)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the checkpoint is missing
        predictor = instantiate(cfg["model"]["sam_predictor"])
    model = predictor.model
    assert isinstance(model.image_encoder, TinyViT)
    assert isinstance(model.mask_decoder, MaskDecoderHQ) == (
        name == "samhq_light_vit_tiny")
    assert (model.dtype, model.device.type) == (torch.bfloat16, "cpu")
    frames = torch.randint(0, 255, (1, 48, 64, 3), dtype=torch.uint8)
    emb = predictor.encode_frames(frames, (48, 64))
    if model.use_hq:
        assert emb["interm"].shape == (1, 64, 64, 320)
        emb = emb["emb"]
    assert emb.shape == (1, 64, 64, 256) and bool(torch.isfinite(
        emb.float()).all())


def test_hq_vit_b_predictor_and_sam_pt_build():
    """`build_predictor(hq=True)` on a ViT (early features 768 wide) and
    `build_sam_pt(sam=, hq=)` no longer refuse these variants."""
    predictor = build_predictor("vit_b", hq=True, hq_token_only=True,
                                allow_random_init=True, dtype="float32",
                                device="cpu")
    decoder = predictor.model.mask_decoder
    assert isinstance(decoder, MaskDecoderHQ)
    assert decoder.compress_vit_feat[0].weight.shape == (768, 256, 2, 2)
    assert predictor.model.hq_token_only
    sam_pt = build_sam_pt("cpu", dtype=torch.float32, sam="vit_t", hq=True,
                          tracker="pips")
    encoder = sam_pt.sam_predictor.model.image_encoder
    assert isinstance(encoder, TinyViT)
    running_var = encoder.layers[0].blocks[0].conv1.bn.running_var
    assert bool((running_var == 1).all())  # untrained statistics
    with pytest.raises(ValueError, match="unknown SAM variant"):
        build_predictor("vit_x", allow_random_init=True, device="cpu")
