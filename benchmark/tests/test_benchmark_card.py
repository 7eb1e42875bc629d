"""Checks that need the card, at the configurations' own widths on a short
video (12 frames of 480 x 854, 2 objects): the control comes out not
correct, a run with a fault planted underneath (`faults.py`) comes out not
correct and one without comes out correct, and a video's kernel launches
equal the copied schedule. The faulted runs and their sound twin hold the
IoU head's bias at `faults.GATE_DECIDES`.

    python -m pytest benchmark/tests/test_benchmark_card.py
"""
import time

import pytest
import torch

from benchmark.harness import main, registry, traffic, weights
from benchmark.tests.faults import CARD_FAULTS, GATE_DECIDES

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]
SHORT = {"frame_hw": [480, 854], "cycle": [[12, 2, "short"]],
         "boxes": [[110, 360], [150, 120]], "warm_frames": 4}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103])
def test_control_is_not_correct(name, seed):
    device = _card()
    from benchmark.control import control

    cell = registry.Cell(name, traffic=dict(SHORT))
    result = control(cell, seed, device)
    assert not result["correct"], result["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_launches_equal_the_schedule(name):
    device = _card()
    cell = registry.Cell(name, traffic=dict(SHORT))
    system = cell.system()
    system.load_kernels()
    config, ref = cell.config, cell.reference()
    ckpt = weights.checkpoints(config, ref.param_shapes(config), 5, device)
    harness = system.Harness(system.build(config, ckpt, device))
    video = traffic.cycle(SHORT, 5, device)[0]
    system.reset_launch_counts()
    harness.process(video)
    harness.resolve()
    assert system.launch_counts() == ref.launch_schedule(config, 12, 2)


def _run(name, fault, device, seed=2 ** 31 + 11):
    cell = registry.Cell(name, traffic=dict(SHORT))
    cell.config["weights"]["set"]["sam"].update(GATE_DECIDES)
    system = cell.system()
    fa = system.kernel_module()
    saved = dict(vars(fa))
    if fault is not None:
        system = fault(system)
    cell.system = lambda: system
    try:
        return main.run(cell, seed, 0.1, False, time.perf_counter(), device,
                        log=lambda msg: None, warm=False)
    finally:
        for key in ("window_attention_cuda", "global_attention_cuda",
                    "cross_attention_cuda"):
            setattr(fa, key, saved[key])


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, *CARD_FAULTS],
                         ids=lambda f: "sound" if f is None else f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_faults_on_the_card(name, fault):
    result = _run(name, fault, _card())
    assert result["correct"] == (fault is None), result["rows"]
