"""A cell resolved by name from the benchmark's data files.

``BENCHMARK.json`` names each cell's configuration and traffic mix. The
harness finds everything else by those names, so that a cell, a
configuration, a mix or a per-layer metric is added as new files and
entries, with no code edited:

* ``configs[].file``: the configuration (its ``family`` names the reference
  ``portbench/reference/<family>.py`` and the count ``portbench/flops/<family>.py``);
* ``portbench/traffic/<traffic>.json``: the mix (its ``driver`` names
  ``portbench/drivers/<driver>.py``);
* ``portbench/limits/<cell>.json``: the limit of each number the cell compares;
* ``portbench/metrics/<metric>.py``: the reader of each metric that lists the cell.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from types import ModuleType

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # portbench/
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries of the metrics the cell reports
    per_layer: list
    root: str

    def module(self, sub: str, name: str) -> ModuleType:
        return load_module(self.root, sub, name)

    @property
    def family(self) -> ModuleType:
        return self.module("reference", self.config["family"])

    @property
    def flops(self) -> ModuleType:
        return self.module("flops", self.config["family"])

    @property
    def driver(self) -> ModuleType:
        return self.module("drivers", self.traffic["driver"])

    def reader(self, metric: str) -> ModuleType:
        return self.module("metrics", metric)


def load_module(root: str, sub: str, name: str) -> ModuleType:
    """``<root>/portbench/<sub>/<name>.py``, loaded once a process. A module
    of a package directory keeps its package, so its relative imports work;
    a metric reader (a name with dots) is loaded under a name of its own."""
    path = os.path.join(root, "portbench", sub, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {sub} file for {name!r}: {path}")
    modname = (f"portbench.{sub}.{name}" if "." not in name
               else f"portbench_{sub}_" + name.replace(".", "__"))
    mod = sys.modules.get(modname)
    if mod is not None and os.path.abspath(getattr(mod, "__file__", "")) == os.path.abspath(path):
        return mod
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _read(os.path.join(root, "BENCHMARK.json"))


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``, or
    every cell where the metric has none (``setup_s``)."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(work)}")
    w = work[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    layer = [m for m in bench["per_layer"] if reports(m, name)]
    return Cell(name=name, chips=w["chips"], config_name=w["config"],
                config=_read(os.path.join(root, conf["file"])),
                traffic_name=w["traffic"],
                traffic=_read(os.path.join(root, "portbench", "traffic", f"{w['traffic']}.json")),
                limits=_read(os.path.join(root, "portbench", "limits", f"{name}.json")),
                end_to_end=e2e, per_layer=layer, root=root)
