"""Every model-specific step of the harness goes through the modules a
configuration names: no harness module imports a model's reference by
name, `check.compare` reads what the reference module it is given says
(embeddings one tensor or a dict of them, leaf by leaf), and the
yardstick's counts come from the reference module and equal `flops.py`'s
for the configurations there are."""
import ast
import copy
import json
import time
import types
from pathlib import Path

import pytest
import torch

from benchmark.harness import check, flops, main, registry
from benchmark.reference import pipeline
from benchmark.tests import tiny

HARNESS = Path(__file__).resolve().parents[1] / "harness"
MODELS = {"benchmark.reference.pipeline", "benchmark.reference.sam",
          "benchmark.reference.trackers"}
CELL = "vith_cotracker.davis17"
SEED = 2 ** 31 + 7
WORKLOADS = [w["name"] for w in registry.benchmark()["workloads"]]
# what check.py and main.py call on a configuration's reference module
ROUTED = ("param_shapes", "query_point_faults", "embeddings",
          "video_embeddings", "tracks", "threshold", "visibility", "prompt",
          "decode", "fuse", "launch_schedule", "video_flops")


def _config(entry: dict) -> dict:
    with open(registry.ROOT / entry["file"]) as f:
        return json.load(f)


PIPELINE_CONFIGS = [c for c in map(_config, registry.benchmark()["configs"])
                    if c["reference"] == "pipeline"]


def _imported(source: str) -> set:
    """Every module that a file of `benchmark.harness` with this source
    imports, by its absolute name; `from a import b` counts as `a` and as
    `a.b`."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = ["benchmark", "harness"][:3 - node.level] if node.level else []
            module = ".".join(base + ([node.module] if node.module else []))
            names.add(module)
            names |= {f"{module}.{a.name}" for a in node.names}
    return names


@pytest.mark.parametrize("path", sorted(HARNESS.glob("*.py")),
                         ids=lambda p: p.name)
def test_harness_names_no_models_reference(path):
    found = {n for n in _imported(path.read_text())
             if any(n == m or n.startswith(m + ".") for m in MODELS)}
    assert not found


def test_the_scan_resolves_relative_imports():
    found = _imported("from ..reference import pipeline as ref\n"
                      "from . import flops\n")
    assert {"benchmark.reference.pipeline", "benchmark.harness.flops"} <= found


@pytest.fixture(scope="module")
def sound():
    """A sound tiny run of cell 1 in float32: its reference module, the
    arguments `main.run` handed `check.compare`, and its numbers."""
    cell = tiny.cell(CELL)
    for part in ("sam", "tracker"):
        cell.config[part]["dtype"] = "float32"
    seen = {}
    compare = check.compare

    def record(ref, *args):
        seen["ref"], seen["args"] = ref, args
        return compare(ref, *args)

    check.compare = record
    try:
        result = main.run(cell, SEED, 0.1, False, time.perf_counter(),
                          torch.device("cpu"), log=lambda msg: None,
                          warm=False)
    finally:
        check.compare = compare
    assert result["correct"], result["rows"]
    numbers = dict(result["numbers"])
    del numbers["launch_faults"]
    return cell.config, seen, numbers


def _stand_in(**replaced):
    """The pipeline reference with some of its functions replaced."""
    return types.SimpleNamespace(**{**vars(pipeline), **replaced})


def test_run_hands_compare_the_cells_reference(sound):
    _, seen, _ = sound
    assert seen["ref"] is pipeline


def test_compare_reads_the_reference_it_is_given(sound):
    config, seen, numbers = sound
    assert check.compare(pipeline, *seen["args"]) == numbers

    def decode(*args, **kwargs):
        logits, iou, visible = pipeline.decode(*args, **kwargs)
        return 1.2 * logits, iou, visible

    scaled = check.compare(_stand_in(decode=decode), *seen["args"])
    assert scaled["logit_rel_l2"] > config["limits"]["logit_rel_l2"]
    assert scaled["embed_rel_l2"] == numbers["embed_rel_l2"]


def test_dict_embeddings_are_compared_leaf_by_leaf(sound):
    config, seen, numbers = sound
    _, ckpt, kept, seed, device = seen["args"]

    def embeddings(*args, **kwargs):
        emb = pipeline.embeddings(*args, **kwargs)
        return {"emb": emb, "interm": emb.clone()}

    def decode(emb, *args, **kwargs):
        assert set(emb) == {"emb", "interm"}
        return pipeline.decode(emb["emb"], *args, **kwargs)

    hq = _stand_in(embeddings=embeddings, decode=decode)

    def as_dicts(interm_scale):
        return [dict(k, embeddings={"emb": k["embeddings"],
                                    "interm": interm_scale * k["embeddings"]})
                for k in kept]

    same = check.compare(hq, config, ckpt, as_dicts(1.0), seed, device)
    assert same == numbers
    planted = check.compare(hq, config, ckpt, as_dicts(1.1), seed, device)
    assert planted["embed_rel_l2"] > config["limits"]["embed_rel_l2"]
    assert {k: v for k, v in planted.items() if k != "embed_rel_l2"} == {
        k: v for k, v in numbers.items() if k != "embed_rel_l2"}


def test_video_flops_raises_on_a_tracker_it_cannot_count():
    config = copy.deepcopy(registry.Cell(CELL).config)
    config["tracker"]["name"] = "tapir"
    with pytest.raises(ValueError, match="tapir"):
        flops.video_flops(config, 40, 2, (480, 854))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_has_every_routed_function(workload):
    ref = registry.Cell(workload).reference()
    assert all(callable(getattr(ref, name, None)) for name in ROUTED)


@pytest.mark.parametrize("config", PIPELINE_CONFIGS, ids=lambda c: c["name"])
@pytest.mark.parametrize("frames, objects", [(35, 1), (70, 3), (100, 5)])
def test_the_pipelines_counts_are_flops_counts(config, frames, objects):
    hw = (480, 854)
    assert pipeline.launch_schedule(config, frames, objects) == (
        flops.launch_schedule(config["sam"], config["sam_pt"], frames, objects))
    assert pipeline.video_flops(config, frames, objects, hw) == (
        flops.video_flops(config, frames, objects, hw))
