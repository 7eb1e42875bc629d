"""The harness finds every configuration, traffic mix, system, reference and
per-layer metric reader by the names in BENCHMARK.json, and the file keeps
to its shape."""
import re

import pytest

from benchmark.harness import registry
from benchmark.harness.main import Record

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in layer and len(layer) <= 200 for layer in layers)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(workload):
    cell = registry.Cell(workload)
    assert cell.chips == 1
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["cycle"] and cell.traffic["frame_hw"]
    assert len(cell.traffic["boxes"]) >= max(m for _, m, _ in
                                             cell.traffic["cycle"])
    assert hasattr(cell.system(), "build")
    assert hasattr(cell.reference(), "param_shapes")
    assert len(cell.workload["why"]) <= 200


@pytest.mark.parametrize("mix", sorted({w["traffic"]
                                        for w in BENCH["workloads"]}))
def test_cycle_is_the_stated_sample_of_its_table(mix):
    traffic = registry.Cell([w["name"] for w in BENCH["workloads"]
                             if w["traffic"] == mix][0]).traffic
    sample = traffic["sample"]
    table = traffic[sample["table"]]
    picked = table[sample["first"]::sample["every"]]
    assert [[t, m, name] for name, t, m in picked] == traffic["cycle"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_reads_nothing_from_an_empty_record(metric):
    reader = registry.metric_reader(metric)
    assert reader.read(Record()) is None


def test_readers_compute_from_a_record():
    record = Record()
    record.spans = {"decode": 2.0, "encode": 1.0}
    record.work = {"pairs": 400, "frames": 100, "objects": 9}
    record.profile = {"busy_s": 3.0, "window_s": 4.0,
                      "by_name": {"void sampt::relpos_flash_kernel<80>": 0.5},
                      "gaps": {}, "ops": 1}
    record.launches = {"global": [(4, 64, 64, 16, 80)] * 10}
    record.model = {"flops": 989e12, "wall": 10.0}

    def read(name):
        return registry.metric_reader(name).read(record)

    assert read("decode_ms_per_pair") == pytest.approx(5.0)
    assert read("encode_ms_per_frame") == pytest.approx(10.0)
    assert read("idle_share") == pytest.approx(25.0)
    assert read("mfu") == pytest.approx(10.0)
    assert read("k2_global_roofline") == pytest.approx(
        100 * 10 * 343.597e9 / 989e12 / 0.5, rel=1e-3)
    assert read("k1_window_roofline") is None
