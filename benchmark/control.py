"""The readings that a cell's limits are set from, at the cell's own
sizes: the control (the plain reference computed one precision below the
configuration's, bfloat16 -> float8 e4m3 with a scale per tensor, float32
-> bfloat16, in the program's place, over the cycle's first pass), which
has to come out not correct, and with `--program` the program's sound
runs (the window of a run cut to the cycle's first pass, nothing warmed
up), many seeds in one process. The benchmark's runs do not run it.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 [--program]

Prints one JSON line a seed: the numbers, and whether they pass.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(cell, seed: int, device) -> dict:
    """The control's numbers for `cell` (a `registry.Cell`) and `seed`."""
    from benchmark.harness import check, traffic, weights

    config, ref = cell.config, cell.reference()
    ckpt = weights.checkpoints(config, ref.param_shapes(config), seed, device)
    videos = traffic.cycle(cell.traffic, seed, device)
    outputs = check.control_outputs(ref, config, ckpt, videos, seed, device)
    numbers = check.compare(ref, config, ckpt, outputs, seed, device)
    numbers["launch_faults"] = 0
    correct, _ = check.verdict(numbers, config["limits"])
    return {"seed": seed, "numbers": numbers, "correct": correct}


def program(cell, seed: int, device) -> dict:
    """A sound run's numbers for `cell` and `seed`."""
    from benchmark.harness import main

    result = main.run(cell, seed, 0.0, False, time.perf_counter(), device,
                      log=lambda msg: print(msg, file=sys.stderr, flush=True),
                      min_videos=len(cell.traffic["cycle"]), warm=False)
    return {"seed": seed, "numbers": result["numbers"], "iou": result["iou"],
            "correct": result["correct"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--program", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import registry

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = registry.Cell(args.workload)
    read = program if args.program else control
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(read(cell, seed, torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
