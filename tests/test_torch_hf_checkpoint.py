"""A HuggingFace-layout SAM checkpoint (`transformers.SamModel`'s
`vision_encoder.*` keys, as in the facebook/sam-vit-* files) through the
port's `build_predictor(checkpoint=...)` and the JAX package's
`load_sam_checkpoint`: the same embeddings and masks.

The file is a tiny `transformers.SamModel` built locally from a config
(`tests/tiny_hf_sam.py`; nothing is downloaded), saved under `tmp_path`.
Its widths are registered as a ViT variant and its prompt widths given to
the factory's `Sam`, as the JAX side's helper registers them.
Tolerance 1e-4 on embeddings of order 1 and on IoUs, 1e-3 on logits of
order 10 (float32 summation order).
"""
import functools

import jax.numpy as jnp
import numpy as np
import torch

from sam_pt_torch.models.sam import factory
from sam_pt_torch.models.sam.image_encoder import VIT_VARIANTS
from sam_pt_torch.models.sam.sam_model import Sam
from sam_pt_torch.utils.checkpoint import hf_sam_to_sam_state_dict
from sam_pt_tpu.models.sam.predictor import SamPredictor as JPredictor
from sam_pt_tpu.utils.checkpoint import hf_sam_to_sam_state_dict as j_map
from sam_pt_tpu.utils.checkpoint import load_sam_checkpoint
from tiny_hf_sam import IMAGE_SIZE, build_tiny_hf_and_flax

torch.set_num_threads(1)

# tests/tiny_hf_sam.py's vision config as `ImageEncoderViT` arguments.
HF_VIT = dict(embed_dim=64, depth=4, num_heads=2, global_attn_indexes=(1, 3),
              window_size=2)


def test_key_map_is_the_jax_one():
    hf, _, _ = build_tiny_hf_and_flax(seed=2)
    sd = hf.state_dict()
    got, want = hf_sam_to_sam_state_dict(sd), j_map(sd)
    assert list(got) == list(want)
    assert all(got[k] is want[k] for k in got)


def test_hf_file_gives_the_jax_embeddings_and_masks(tmp_path, monkeypatch):
    hf, jmodel, _ = build_tiny_hf_and_flax(seed=1)
    path = str(tmp_path / "sam_hf.pth")
    torch.save(hf.state_dict(), path)

    jpred = JPredictor(jmodel, load_sam_checkpoint(path))
    monkeypatch.setitem(VIT_VARIANTS, "hf_parity_test", HF_VIT)
    monkeypatch.setattr(factory, "Sam", functools.partial(
        Sam, prompt_embed_dim=32, mask_in_chans=4))
    tpred = factory.build_predictor("hf_parity_test", checkpoint=path,
                                    dtype="float32", image_size=IMAGE_SIZE,
                                    device="cpu")

    rng = np.random.default_rng(51)
    frames = rng.integers(0, 255, (2, 48, 80, 3)).astype(np.uint8)
    ref = jpred.encode_frames(jnp.asarray(frames), (48, 80))
    got = tpred.encode_frames(torch.from_numpy(frames), (48, 80))
    assert got.shape == (2, 4, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)

    pts = rng.uniform(0, 80, (2, 3, 2)).astype(np.float32)
    lbl = np.array([[1, 0, -1], [1, 1, 1]], np.int32)
    for multimask in (False, True):
        ref_m, ref_iou, _ = jpred.predict(ref, pts, lbl, (48, 80),
                                          multimask_output=multimask)
        got_m, got_iou, _ = tpred.predict(got, pts, lbl, (48, 80),
                                          multimask_output=multimask)
        np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m),
                                   atol=1e-3, rtol=0)
        np.testing.assert_allclose(got_iou.numpy(), np.asarray(ref_iou),
                                   atol=1e-4, rtol=0)
    up = tpred.upscale_logits(got_m[:, 0], (48, 80))
    np.testing.assert_array_equal(
        up.numpy() > 0,
        np.asarray(jpred.upscale_logits(ref_m[:, 0], (48, 80))) > 0)
