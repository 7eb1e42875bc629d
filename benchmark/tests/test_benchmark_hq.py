"""HQ-SAM ViT-H + CoTracker and the crowded mix: both new cells resolve,
the configuration is cell 1's with HQ-SAM's decoder, the HQ reference has
every routed function and counts HQ's FLOPs by the stated rule, and a run
reads correct while two faults planted in the HQ path read not correct:
the HQ term dropped (the single mask SAM token 0's alone) and the early
features taken from the second global block (block 15 of ViT-H) and not
the first. On the CPU at a tiny size (8 encoder blocks, global at 1 and
7: six blocks between the two, as ViT-H has seven between blocks 7 and
15, since a tiny block moves the residual stream little); a `cuda` case
runs the same on the card at the configuration's own widths over a short
video. Both faults change the masks and not the IoU
gate, so the runs hold the IoU head's bias where every pair passes the
gate (`GATE_KEEPS`) and every drawn pair's logits are compared."""
import copy
import time

import pytest
import torch

from benchmark.harness import flops, main, registry
from benchmark.reference import pipeline, pipeline_hq
from benchmark.tests import tiny
from benchmark.tests.test_benchmark_routing import ROUTED

HQ_CELL = "hqvith_cotracker.crowded"
PLAIN_CELL = "vith_cotracker.crowded"
SEED = 2 ** 31 + 7
# The IoU head's bias the HQ faults' runs are held at: every pair passes
# the gate (asserted), so every drawn pair's logits are compared (where
# none passes, the check compares no logits: ROADMAP.md §3 item 4).
GATE_KEEPS = {"mask_decoder.iou_prediction_head.layers.2.bias": 1.0}
SHORT = {"frame_hw": [480, 854], "cycle": [[12, 2, "short"]],
         "boxes": [[110, 360], [150, 120]], "warm_frames": 4}


def test_both_cells_resolve_on_the_crowded_mix():
    hq, plain = registry.Cell(HQ_CELL), registry.Cell(PLAIN_CELL)
    assert hq.traffic is not plain.traffic and hq.traffic == plain.traffic
    assert plain.config["name"] == "sam_vit_h-cotracker"
    assert hq.reference() is pipeline_hq
    assert plain.reference() is pipeline
    assert hq.system().SPANS["hq"] == "_hq_features_device"
    assert [m["name"] for m in hq.per_layer][-1] == "hq_ms_per_frame"
    assert "hq_ms_per_frame" not in [m["name"] for m in plain.per_layer]
    cycle = hq.traffic["cycle"]
    assert sum(t for t, _, _ in cycle) == 204
    assert sum(m for _, m, _ in cycle) == 13
    assert sum(t * m for t, m, _ in cycle) == 862


def test_configuration_is_cell_1s_with_hq_sams_decoder():
    hq = registry.Cell(HQ_CELL).config
    plain = registry.Cell(PLAIN_CELL).config
    for key in ("tracker", "sam_pt", "check"):
        assert hq[key] == plain[key], key
    extra = {k: hq["sam"][k] for k in set(hq["sam"]) - set(plain["sam"])}
    assert extra == {"hq": True, "vit_dim": 1280, "hq_token_only": False}
    assert all(hq["sam"][k] == v for k, v in plain["sam"].items())
    assert hq["sam"]["vit_dim"] == pipeline_hq.vit_dim(hq["sam"])
    entry = [c for c in registry.benchmark()["configs"]
             if c["name"] == hq["name"]][0]
    assert entry["reduced"] == []


def test_hq_reference_has_every_routed_function():
    assert all(callable(getattr(pipeline_hq, name, None)) for name in ROUTED)


@pytest.mark.parametrize("frames, objects", [(78, 5), (47, 5), (79, 3)])
def test_video_flops_add_the_stated_hq_count(frames, objects):
    config = registry.Cell(HQ_CELL).config
    hq = pipeline_hq.video_flops(config, frames, objects, (480, 854))
    plain = pipeline.video_flops(config, frames, objects, (480, 854))
    assert {k: v for k, v in hq.items() if k != "hq"} == plain
    # by hand at ViT-H: per frame, 2x2 stride-2 transposed convolutions
    # 1280 -> 256 and 256 -> 64 at 64 x 64, 256 -> 32 and 64 -> 32 at
    # 128 x 128 (2 x 4 operations a tap)
    image = 8 * 64 ** 2 * (1280 * 256 + 256 * 64) + 8 * 128 ** 2 * (
        256 * 32 + 64 * 32)
    assert pipeline_hq.image_flops(config["sam"]) == image
    assert image == pytest.approx(12.6e9, rel=0.01)
    # per pair and pass: two 3x3 convolutions 32 <-> 64 at 256 x 256, four
    # hypernetworks and four mask products more, and the HQ token
    m = 256 ** 2
    extra = 2 * 2 * m * 32 * 64 * 9 + 4 * 2 * (2 * 256 ** 2 + 256 * 32) + (
        4 * 2 * m * 32)
    tokens = pipeline_hq.pass_tokens(config["sam_pt"], objects)
    assert len(tokens) == 14 and tokens[0] == 17
    assert tokens[1] == 17 + 16 * (objects - 1) + 1
    token = sum(flops.decoder_pass_flops(n + 1, False)
                - flops.decoder_pass_flops(n, False) for n in tokens)
    want = frames * image + frames * objects * (14 * extra + token)
    assert hq["hq"] == pytest.approx(want, rel=1e-12)


def test_launch_schedule_is_the_pipelines():
    config = registry.Cell(HQ_CELL).config
    for frames, objects in ((78, 5), (12, 2)):
        assert pipeline_hq.launch_schedule(config, frames, objects) == (
            pipeline.launch_schedule(config, frames, objects))


def test_hq_reader():
    reader = registry.metric_reader("hq_ms_per_frame")
    record = main.Record()
    assert reader.read(record) is None
    record.spans, record.work = {"encode": 1.0}, {"frames": 100}
    assert reader.read(record) is None
    record.spans["hq"] = 0.25
    assert reader.read(record) == pytest.approx(2.5)


# ----------------------------------------------------------------------------
# Faults planted in the HQ path
# ----------------------------------------------------------------------------

def _patched(system, patch):
    build = system.build

    def patched(config, weights, device):
        sam_pt = build(config, weights, device)
        patch(sam_pt)
        return sam_pt

    system.build = patched
    return system


def hq_term_dropped(system):
    """The HQ token's mask zeroed: the single mask is SAM token 0's."""
    def patch(sam_pt):
        decoder = sam_pt.sam_predictor.model.mask_decoder
        forward = decoder.forward_features

        def sam_only(*args, **kwargs):
            masks, iou = forward(*args, **kwargs)
            masks = masks.clone()
            masks[:, 4] = 0
            return masks, iou

        decoder.forward_features = sam_only

    return _patched(system, patch)


def interm_from_second_global_block(system):
    """The early features taken after the second global block (block 15
    of ViT-H) in place of the first."""
    def patch(sam_pt):
        model = sam_pt.sam_predictor.model
        encoder = model.image_encoder
        later = {}
        block = encoder.blocks[encoder.global_attn_indexes[1]]
        block.register_forward_hook(
            lambda module, args, out: later.__setitem__("x", out))
        encode = model.encode_images

        def encode_images(images):
            out = encode(images)
            return {"emb": out["emb"],
                    "interm": later["x"].reshape(out["interm"].shape)}

        model.encode_images = encode_images

    return _patched(system, patch)


HQ_FAULTS = [hq_term_dropped, interm_from_second_global_block]


def _tiny_cell(fault=None):
    cell = tiny.cell(HQ_CELL)
    cell.config["sam"].update(depth=8, global_attn_indexes=[1, 7])
    for part in ("sam", "tracker"):
        cell.config[part]["dtype"] = "float32"
    return _with_fault(cell, fault)


def _with_fault(cell, fault):
    cell.config["weights"]["set"]["sam"].update(GATE_KEEPS)
    system = cell.system()
    if fault is not None:
        system = fault(system)
    cell.system = lambda: system
    return cell


@pytest.mark.parametrize("fault", [None, *HQ_FAULTS],
                         ids=lambda f: "sound" if f is None else f.__name__)
def test_hq_faults_on_the_cpu(fault):
    result = main.run(_tiny_cell(fault), SEED, 0.1, False,
                      time.perf_counter(), torch.device("cpu"),
                      log=lambda msg: None, warm=False)
    assert result["iou"]["passed"] == 1.0
    assert result["correct"] == (fault is None), result["rows"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, *HQ_FAULTS],
                         ids=lambda f: "sound" if f is None else f.__name__)
def test_hq_faults_on_the_card(fault):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = _with_fault(registry.Cell(HQ_CELL, traffic=copy.deepcopy(SHORT)),
                       fault)
    result = main.run(cell, 2 ** 31 + 11, 0.1, False, time.perf_counter(),
                      torch.device("cuda", 0), log=lambda msg: None,
                      warm=False)
    assert result["iou"]["passed"] == 1.0
    assert result["correct"] == (fault is None), result["rows"]
