"""Nothing the benchmark runs imports JAX, the JAX package, its alias or the
repository's JAX tools, compared by whole top-level module name."""

import os
import subprocess
import sys

from portbench.core import bench, spec

PROBE = r"""
import glob, os, sys
sys.path.insert(0, {root!r})
import importlib
import portbench.run  # noqa: F401  (sets the environment, imports the harness)
from portbench.core import bench, spec
for sub in ("drivers", "reference", "flops", "metrics"):
    for path in sorted(glob.glob(os.path.join({root!r}, "portbench", sub, "*.py"))):
        name = os.path.basename(path)[:-3]
        if name != "__init__":
            spec.load_module({root!r}, sub, name)
importlib.import_module("portbench.drivers.common").port("train.loop")
importlib.import_module("portbench.drivers.common").port("attacks.whitebox")
print(repr(bench.jax_modules()))
"""


def test_no_jax_module_is_loaded():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=spec.ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_banned_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "apvt_lora_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "toolsy", sys)
    assert bench.jax_modules() == [] or all(
        n.split(".")[0] in bench.BANNED for n in bench.jax_modules())
    monkeypatch.setitem(sys.modules, "apvt_lora.sub", sys)
    assert "apvt_lora.sub" in bench.jax_modules()
