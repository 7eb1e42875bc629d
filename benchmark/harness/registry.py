"""Finds what a cell is made of by the names in BENCHMARK.json: the
configuration's file, the traffic mix's file, the system adapter and
reference the configuration names, and the reader of each per-layer
metric. A later mix or metric is a new file and a new entry in
BENCHMARK.json; no code changes.

A new configuration (another SAM variant or tracker) adds:
  - its file under `configs/`, whose `reference` and `system` keys name
    the two modules below;
  - a reference module under `reference/` with the functions that
    `check.py` and `main.py` call on it: `param_shapes(config)`,
    `query_point_faults(query_points, masks, timesteps, n_pos)`,
    `embeddings(frames, sd, config, p)` (a tensor [F, ...] or a dict of
    them), `video_embeddings(video, frames, sd, config, p)`,
    `tracks(video, query_points, sd, config, p)`, `threshold(config)`,
    `visibility(traj, prob, hw, config)`, `prompt(traj, vis, obj, n_pos,
    other_positives)`, `decode(emb, points, labels, hw, sd, config, p)`,
    `fuse(logits, gt, gt_ts)`, `launch_schedule(config, frames, objects)`
    and `video_flops(config, frames, objects, hw)`; it may import
    `pipeline` and replace only what differs;
  - a system file under `systems/` only where `build_sam` or
    `build_tracker` of `systems/sam_pt.py` differs: it imports that file
    and composes its own `build` from the two.
No file of the harness changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout
BENCH = ROOT / "benchmark"


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, name: str, bench: dict = None, config: dict = None,
                 traffic: dict = None):
        bench = bench or benchmark()
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        entry = [c for c in bench["configs"]
                 if c["name"] == self.workload["config"]][0]
        self.config = config or _json(ROOT / entry["file"])
        self.traffic = traffic or _json(
            BENCH / "traffic" / f"{self.workload['traffic']}.json")
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def system(self):
        """The adapter that builds and drives the program for this
        configuration (`benchmark/systems/<system>.py`)."""
        return load_module(BENCH / "systems" / f"{self.config['system']}.py",
                           f"bench_system_{self.config['system']}")

    def reference(self):
        """The configuration's plain reference (`benchmark/reference/
        <reference>.py`), imported as part of the reference package."""
        return importlib.import_module(
            f"benchmark.reference.{self.config['reference']}")


def metric_reader(name: str):
    """`benchmark/metrics/<name>.py`, whose `read(trace)` returns the
    metric's value or None when the run has nothing for it to read."""
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_"))
