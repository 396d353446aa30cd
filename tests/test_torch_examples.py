"""The port's two example workflows (``examples/*_torch.py``) on the CPU.

Each demo runs in a fresh interpreter with ``--device cpu`` and one thread
and must print the JAX demo's lines (the same text around other numbers):
the sequential-LoRA demo's noisy accuracy after stage 2 is at least stage
0's, and the BiLoRA demo's last printed loss is below its first. Without
``--device cpu`` and without a card a demo exits non-zero.
"""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = r"(\d+\.\d{3})"


def _run(script, *args, cwd, hide_cards=False):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    if hide_cards:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, os.path.join(REPO, "examples", script), *args],
                          capture_output=True, text=True, env=env, cwd=cwd, timeout=300)


def test_sequential_lora_demo_on_the_cpu(tmp_path):
    out = _run("sequential_lora_demo_torch.py", "--device", "cpu", cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    labels = ("stage 0 (random base)", "stage 1 (LoRA-1 r=4 on clean, merged)",
              "stage 2 (+LoRA-2 r=16 on noisy, merged)")
    lines = out.stdout.splitlines()
    assert len(lines) == 3, out.stdout
    acc = []
    for line, label in zip(lines, labels):
        m = re.fullmatch(re.escape(label) + f": clean={NUM} noisy={NUM}", line)
        assert m, line
        acc.append((float(m.group(1)), float(m.group(2))))
    assert acc[2][1] >= acc[0][1]
    assert acc[1][0] > acc[0][0]  # LoRA-1 learned the clean task


def test_bilora_fashion_demo_on_the_cpu(tmp_path):
    out = _run("bilora_fashion_demo_torch.py", "--device", "cpu", cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "no ./fashion_data — generating a synthetic IDX fixture"
    assert lines[1] == "BiLoRA trainable params: 800 spectral coefficients + head"
    losses = []
    for i, line in enumerate(lines[2:6]):
        m = re.fullmatch(rf"step {20 * i}: loss (\d+\.\d{{4}})", line)
        assert m, line
        losses.append(float(m.group(1)))
    assert losses[-1] < losses[0]
    m = re.fullmatch(rf"test accuracy: base {NUM} -> BiLoRA {NUM}", lines[6])
    assert m and len(lines) == 7, out.stdout
    assert float(m.group(2)) > float(m.group(1))


def test_demos_ask_for_the_card_by_default(tmp_path):
    for script in ("sequential_lora_demo_torch.py", "bilora_fashion_demo_torch.py"):
        out = _run(script, cwd=tmp_path, hide_cards=True)
        assert out.returncode != 0 and "no CUDA device found" in out.stderr, script
