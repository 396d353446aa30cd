"""The harness is driven by data: every cell resolves to its files by name,
a cell or a metric added as files and entries only is found with no code
edited, the result line carries the contract's keys, and BENCHMARK.json
keeps to the contract's limits."""

import json
import math
import os
import re
import subprocess
import sys
import time

import pytest

from portbench.core import bench, spec
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def benchmark():
    return spec.benchmark()


def test_every_cell_resolves_to_its_files(benchmark):
    for w in benchmark["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.family.layout(cell.family.config(cell.config))
        assert hasattr(cell.driver, "Driver") and hasattr(cell.flops, "forward")
        assert cell.limits["numbers"]
        names = [m["name"] for m in cell.end_to_end + cell.per_layer]
        assert "setup_s" in names and len(cell.end_to_end) >= 2 and cell.per_layer
        for m in names:
            assert callable(cell.reader(m).read)


def test_benchmark_keeps_to_the_contract(benchmark):
    assert set(benchmark) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert benchmark["command"] == ["python3", "portbench/run.py"]
    assert benchmark["paths"] == ["portbench"]
    rs = benchmark["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    cells = {w["name"] for w in benchmark["workloads"]}
    configs = {c["name"] for c in benchmark["configs"]}
    for c in benchmark["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            assert sorted(json.load(f)["reduced"]) == sorted(c["reduced"])
    pairs = set()
    for w in benchmark["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert all(any(w["config"] == c for w in benchmark["workloads"]) for c in configs)
    metrics = benchmark["end_to_end"] + benchmark["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in benchmark["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in benchmark["end_to_end"])
    e2e = {m["name"] for m in benchmark["end_to_end"]}
    for m in benchmark["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert m["workloads"]  # the cells in which its reader finds something to read
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    assert len(json.dumps(benchmark)) <= 64 * 1024


def test_a_cell_and_a_metric_added_as_data_are_found(tmp_path):
    """A new configuration, mix, cell, limits file and per-layer metric,
    written as files and entries only, in a copy of the benchmark."""
    root = tiny.make_root(str(tmp_path))
    with open(os.path.join(root, "portbench", "metrics", "units_probe.attack.py"), "w") as f:
        f.write("def read(r):\n    return float(r.units)\n")
    b = spec.benchmark(root)
    b["per_layer"].append({"name": "units_probe.attack", "unit": "units", "better": "higher",
                           "source": "host_clock", "layer": "harness", "moves": "adv_images_per_s",
                           "workloads": ["vit_tiny.pgd3_b4"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    cell = spec.cell("vit_tiny.pgd3_b4", root)
    assert cell.config["registry"] == "vit_test" and cell.traffic["steps"] == 3
    line = bench.run(cell, 7, 0.05, True, "cpu", time.perf_counter())
    assert line["metrics"]["units_probe.attack"]["value"] == line["_info"]["units"]


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_carries_the_contract_keys(trace, tiny_root):
    line = bench.run(spec.cell("vit_tiny.full_b4", tiny_root), 2 ** 31 + 3, 0.05, trace, "cpu",
                     time.perf_counter())
    line.pop("_info")
    keys = list(line)
    assert keys[:5] == LINE_KEYS and keys[-1] == "checks"
    assert set(keys) == set(LINE_KEYS) | {"checks"} | ({"breakdown"} if trace else set())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and math.isfinite(c["value"])
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])


def test_without_a_card_a_run_exits_non_zero_and_prints_no_result():
    out = subprocess.run([sys.executable, os.path.join(spec.ROOT, "portbench", "run.py"),
                          "--workload", "vit_b16_224.pgd30_b64", "--seed", str(2 ** 31 + 5),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_the_training_memory_peak_is_the_windows_reading(tiny_root):
    """The training cell's bounded metric reads the peak taken at the
    window's close, and nothing where no card was read."""
    cell = spec.cell("vit_tiny.full_b4", tiny_root)
    reader = spec.cell("vit_b16_224.full_train_b64").reader("train_memory_peak_gib")
    read = lambda taken: reader.read(bench.Readings(  # noqa: E731
        cell, setup_s=1.0, window_s=1.0, units=1, images=4, taken=taken))
    assert read({"window_memory_peak_bytes": 3 * 2 ** 30}) == 3.0
    assert read({}) is None and read(None) is None
