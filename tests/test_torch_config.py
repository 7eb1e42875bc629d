"""The port's config system against the JAX package's: its YAML reader
against `yaml.safe_load` (exact equality), its composition of
`sam_pt_torch/configs/vos_eval_root.yaml` against the JAX composition of
`configs/vos_eval_root.yaml` (equal once the JAX `_target_`s name the port
and the `device`/`platform` keys are set aside), every port config's
targets bound to their keys, and the default model instantiated from the
composed config on the CPU."""
import glob
import inspect
import math
import os
import warnings

import pytest
import torch
import yaml

from sam_pt_torch.config import compose, core, instantiate, miniyaml
from sam_pt_torch.config import resolve_interpolations
from sam_pt_torch.vos_eval.eval import CONFIG_DIR
from sam_pt_tpu.config import compose as j_compose
from sam_pt_tpu.config import resolve_interpolations as j_resolve

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(ROOT, "configs")
YAMLS = sorted(
    os.path.relpath(p, ROOT) for d in (JAX_CONFIGS, CONFIG_DIR)
    for p in glob.glob(os.path.join(d, "**", "*.yaml"), recursive=True))
CWD = "/data/run"


@pytest.mark.parametrize("name", YAMLS)
def test_reader_equals_safe_load(name):
    file = os.path.join(ROOT, name)
    with open(file) as f:
        ref = yaml.safe_load(f)
    assert miniyaml.load_file(file) == ref


OVERRIDE_VALUES = [
    "3", "-3", "+7", "0", "012", "0x1F", "0b101", "1_000", "1:30", "1.5",
    "-1.5e+3", "1e-5", "1.0e5", ".5", ".inf", "-.inf", "1.", "null", "~",
    "Null", "", "true", "False", "yes", "No", "on", "OFF", "y", "abc",
    "/a/b/c", "${a.b}", "${hydra:runtime.cwd}/x", "'q'", '"q\\tx"',
    "'it''s'", "[1, 2]", "[]", "[a, [1, 2.5], 'x y']", "[0, 1, 2, 15]",
    "sam_pt_reinit", "a b", "a #c", "a:b", "-1", "-x", "cuda", "bfloat16",
    "0.7", "2e3", "1_0.5",
]


def test_override_values_equal_safe_load():
    for text in OVERRIDE_VALUES:
        got, ref = core._parse_scalar(text), yaml.safe_load(text)
        assert type(got) is type(ref), text
        assert got == ref or (isinstance(ref, float) and math.isnan(ref)
                              and math.isnan(got)), text
    assert math.isnan(core._parse_scalar(".nan"))


@pytest.mark.parametrize("text", [
    "a: {b: 1}\n", "a: |\n  x\n", "a: &x 1\n", "a: *x\n", "a: !!str 1\n",
    "---\na: 1\n", "a: b\n  c\n", "a: 2001-12-14\n", "a:\n\tb: 1\n",
    "a: b: c\n",
])
def test_reader_refuses_what_is_outside_its_subset(text):
    with pytest.raises(miniyaml.YamlError, match=r"^t\.yaml:\d+: "):
        miniyaml.loads(text, "t.yaml")


def _as_port(node):
    """A JAX config with its `_target_`s naming the port, the `platform`
    key dropped."""
    if isinstance(node, dict):
        return {k: (v.replace("sam_pt_tpu.", "sam_pt_torch.", 1)
                    if k == "_target_" else _as_port(v))
                for k, v in node.items() if k != "platform"}
    if isinstance(node, list):
        return [_as_port(v) for v in node]
    return node


def _without_device(node):
    if isinstance(node, dict):
        return {k: _without_device(v) for k, v in node.items()
                if k != "device"}
    if isinstance(node, list):
        return [_without_device(v) for v in node]
    return node


@pytest.mark.parametrize("overrides", [
    [], ["model=sam_pt_reinit"], ["model/point_tracker=cotracker"],
    ["model/point_tracker=tapir"], ["model/point_tracker=tapnet"],
    ["+a.b=3"], ["model.sam_iou_threshold=0.5"],
], ids=["plain", "reinit", "cotracker", "tapir", "tapnet", "new_key",
        "value"])
def test_compose_equals_the_jax_compose(overrides):
    got = compose(CONFIG_DIR, "vos_eval_root", overrides)
    ref = j_compose(JAX_CONFIGS, "vos_eval_root", overrides)
    assert got["device"] == "cuda" and ref["platform"] is None
    assert _without_device(got) == _as_port(ref)
    got = resolve_interpolations(got, runtime_cwd=CWD)
    assert _without_device(got) == _as_port(j_resolve(ref, runtime_cwd=CWD))
    assert got["model"]["sam_predictor"]["device"] == "cuda"
    assert got["model"]["point_tracker"]["device"] == "cuda"


def _targets(node, found):
    if isinstance(node, dict):
        if "_target_" in node:
            found.append(node)
        for v in node.values():
            _targets(v, found)
    return found


@pytest.mark.parametrize("override", [
    "model=sam_pt", "model=sam_pt_reinit", "model=sam_pt_tiny_test",
    "model/point_tracker=cotracker", "model/point_tracker=pips",
    "model/point_tracker=pips_plus_plus", "model/point_tracker=raft",
    "model/point_tracker=tapir", "model/point_tracker=tapnet",
    "model/sam@model.sam_predictor=sam_vit_base",
    "model/sam@model.sam_predictor=sam_vit_large",
    "model/sam@model.sam_predictor=sam_vit_huge",
])
def test_every_target_binds_its_keys(override):
    cfg = resolve_interpolations(
        compose(CONFIG_DIR, "vos_eval_root", [override]), runtime_cwd=CWD)
    nodes = _targets(cfg, [])
    assert len(nodes) >= 2  # the model (and its parts) and the evaluator
    for node in nodes:
        fn = core._locate(node["_target_"])
        assert node["_target_"].startswith("sam_pt_torch.")
        kwargs = {k: v for k, v in node.items() if not k.startswith("_")}
        if node["_target_"].endswith("SamPtEvaluator"):
            kwargs.update(cfg=cfg, model=None)
        inspect.signature(fn).bind(**kwargs)


def test_default_model_instantiates_on_the_cpu():
    cfg = resolve_interpolations(compose(CONFIG_DIR, "vos_eval_root", [
        "device=cpu", "model.sam_predictor.allow_random_init=true",
        "model.point_tracker.allow_random_init=true"]), runtime_cwd=CWD)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the checkpoints are missing
        model = instantiate(cfg["model"])
    assert type(model).__name__ == "SamPt" and model.device.type == "cpu"
    encoder = model.sam_predictor.model.image_encoder
    assert (len(encoder.blocks), model.sam_predictor.model.dtype) == (
        12, torch.bfloat16)
    tracker = model.point_tracker
    assert type(tracker).__name__ == "PipsPointTracker"
    assert (tracker.stride, tracker.s, tracker.vis_threshold0) == (4, 8, 0.9)
    assert next(tracker.model.parameters()).device.type == "cpu"
    assert (model.sam_decode_chunk, model.point_tracker_mask_batch_size,
            model.iterative_refinement_iterations) == (32, 5, 12)
    # A model node that is already an object instantiates to itself.
    assert instantiate(model) is model
    with pytest.raises(FileNotFoundError):
        instantiate(resolve_interpolations(compose(
            CONFIG_DIR, "vos_eval_root", ["device=cpu"]),
            runtime_cwd=CWD)["model"]["sam_predictor"])
