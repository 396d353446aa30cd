"""The PyTorch port never imports jax: not directly, not through the JAX
package. Checked in a fresh interpreter (this test process has jax loaded
by the suite's conftest) and by reading every source file."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch"
JAX_PKG = "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu"
# the Swin / eval-compose, ConvNeXt, training, attack, model-zoo, file-stage, ETL and W8A8 /
# BiLoRA slices; the walk below must import each of them
NEW_MODULES = ("kernels.window_attention", "models.swin", "ops.peft_io", "train.metrics",
               "train.steps", "train.loop", "eval.compose",
               "kernels.dwconv", "kernels.mlp", "models.convnext",
               # the training slice
               "kernels.attn_block", "data.augment", "train.optim", "utils.observability",
               # the attack families
               "attacks.corruptions", "attacks.patch", "attacks.rp2", "attacks.autoattack",
               "attacks.autoattack.apgd", "attacks.autoattack.fab", "attacks.autoattack.square",
               # the five-backbone zoo and the weight import
               "models.yolo11", "models.hf_import", "models.pretrained",
               # the native codec, the runner and the parity side
               "utils.native", "tools.run_robustness", "tools.parity_e2e",
               # the raw-corpus ETL
               "data.process",
               # the W8A8 attack path, BiLoRA and its FashionMNIST loader
               "ops.quant", "ops.bilora", "data.fashion")
# the port's example workflows (scripts, imported by path)
EXAMPLES = ("examples/sequential_lora_demo_torch.py", "examples/bilora_fashion_demo_torch.py")


def _sources():
    out = []
    for d, _, files in os.walk(os.path.join(REPO, PKG)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out) + [os.path.join(REPO, "apvt_lora_torch", "__init__.py"),
                          os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, e) for e in EXAMPLES]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        f"import {PKG} as pkg, apvt_lora_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "names = [n for n in names if not n.endswith('__main__')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke, importlib.util\n"
        f"for path in {EXAMPLES!r}:\n"
        "    spec = importlib.util.spec_from_file_location(path.replace('/', '_')[:-3], path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        f"or m.startswith('{JAX_PKG}') or m == 'apvt_lora')\n"
        "assert not bad, bad\n"
        "short = {n.split('.', 1)[1] for n in names}\n"
        f"assert set({NEW_MODULES!r}) <= short, short\n"
        "assert len(names) >= 40, names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=180)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_has_no_jax_import(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "optax", JAX_PKG,
                                           "apvt_lora"), f"{path}: imports {n}"


# the measurement entry points: the root script and the tools of the port
MEASUREMENT_MODULES = ("tools.flops", "tools.trace_table", "tools.timing", "tools.bench_zoo",
                       "tools.bench_train", "tools.bench_eval", "tools.bench_compose",
                       "tools.profile_pgd", "tools.profile_train", "tools.profile_eval")


def test_bench_torch_and_the_measurement_tools_load_no_jax():
    code = (
        "import importlib, sys\n"
        "import bench_torch\n"
        f"for n in {MEASUREMENT_MODULES!r}:\n"
        f"    importlib.import_module('{PKG}.' + n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        f"or m.startswith('{JAX_PKG}') or m == 'apvt_lora' or m.startswith('tools'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=180)
    assert out.returncode == 0, out.stderr


def test_bench_torch_has_no_jax_import():
    test_source_has_no_jax_import(os.path.join(REPO, "bench_torch.py"))
    tree = ast.parse(open(os.path.join(REPO, "bench_torch.py")).read())
    for node in ast.walk(tree):  # nor the JAX package's tools/ or bench.py
        if isinstance(node, ast.ImportFrom):
            assert (node.module or "").split(".")[0] not in ("tools", "bench", "tunnel_probe")
        elif isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] not in ("tools", "bench", "tunnel_probe")
                       for a in node.names)
