"""A whole run, short of the look for a card, at a tiny size on the CPU
(float32), with the timed path broken underneath (`faults.py`):
`correct` has to come out false for each fault this system can have, and
true without one; both at the IoU head's bias `faults.GATE_DECIDES`."""
import time

import pytest
import torch

from benchmark.harness import main, registry
from benchmark.tests import tiny
from benchmark.tests.faults import FAULTS, GATE_DECIDES

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]
SEED = 2 ** 31 + 7


def _cell(name, fault=None):
    cell = tiny.cell(name)
    for part in ("sam", "tracker"):
        cell.config[part]["dtype"] = "float32"
    cell.config["weights"]["set"]["sam"].update(GATE_DECIDES)
    system = cell.system()
    if fault is not None:
        system = fault(system)
    cell.system = lambda: system
    return cell


def _run(cell):
    return main.run(cell, SEED, 0.1, False, time.perf_counter(),
                    torch.device("cpu"), log=lambda msg: None, warm=False)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = _run(_cell(name))
    assert result["correct"], result["rows"]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    result = _run(_cell(name, fault))
    assert not result["correct"], result["rows"]
