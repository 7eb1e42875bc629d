"""Benchmark of the PyTorch and CUDA port of SAM-PT (`sam_pt_torch`): one
run of one cell of BENCHMARK.json on one CUDA card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1`
`breakdown`, and last `checks`, each number compared with its limit. The
numbers compared are also the last lines of standard error. Without a
CUDA card, or with fewer than the cell asks for, it exits non-zero and
prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every cache of the program stays in the checkout, at fixed paths.
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "nv", "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def result_line(cell, result, trace: bool, chips: int) -> dict:
    import torch

    from benchmark.harness import registry

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = registry.metric_reader(m["name"]).read(result["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": result[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(result["peak"])}
    line = {"correct": bool(result["correct"]),
            "attempted": int(result["attempted"]),
            "failed": int(result["failed"]), "metrics": metrics,
            "device": device}
    profile = result["record"].profile
    if trace and profile is not None:
        device["busy_s"] = profile["busy_s"]
        device["window_s"] = profile["window_s"]
        top = sorted(profile["by_name"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(profile["gaps"].items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[k[:120], v] for k, v in top],
                             "idle_gaps": [[k, v] for k, v in gaps]}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in result["rows"]}
    return line


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import main as bench
    from benchmark.harness import registry

    cell = registry.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = bench.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), T0, device,
                       log=lambda msg: print(msg, flush=True))
    if result["forbidden"]:
        print(f"the process holds {', '.join(result['forbidden'])}: the port "
              f"must run without the JAX package", file=sys.stderr)
        return 3
    line = result_line(cell, result, bool(args.trace), cell.chips)
    print(json.dumps({"card": card_line(), "numbers": result["numbers"]}),
          flush=True)
    for name, value, limit in result["rows"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
