"""The port's measurement tools (``<port>/tools/bench_*.py``, ``profile_*.py``,
``trace_table.py``) against the JAX tools in ``tools/``.

Each tool runs here with ``--device cpu`` at a tiny size, and the JAX tool
with the same arguments on the CPU: the artifacts' keys must be the same
(the profile tables: the JAX table's keys and its op-record keys, plus the
port's groups, busy time and idle share). ``bench_train --tiny``'s first
step must give the JAX step's loss (rtol 1e-5) on the JAX tool's params,
images and labels, with augmentation off (its draws differ between the
packages; the LoRA branch starts at B = 0, so its dropout draws change no
loss). The JAX-only flags are refused, a card asked for and absent is an
error, and the zoo records a failed backbone and exits 1. The trace table's
grouping, busy time and idle share are held on a profiler stand-in with CUDA
events.
"""

import ast
import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import (
    bench_compose, bench_eval, bench_train, bench_zoo, profile_eval, profile_pgd, profile_train,
    trace_table)
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import vit as jvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the workers share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_both(name, port_main, args, tmp_path, monkeypatch):
    """Run the JAX tool and the port's with ``args`` and ``--json``-style
    output at two paths; returns the two parsed artifacts."""
    out_flag = "--table_json" if name.startswith("profile") else "--json"
    jpath, tpath = str(tmp_path / f"jax_{name}.json"), str(tmp_path / f"port_{name}.json")
    extra = ["--platform", "cpu"] if name == "bench_compose" else []
    monkeypatch.setattr(sys, "argv", [name, *args, *extra, out_flag, jpath])
    _jax_tool(name).main()
    assert port_main([*args, "--device", "cpu", out_flag, tpath]) == 0
    return json.load(open(jpath)), json.load(open(tpath))


def _same_record_keys(jax_art, port_art):
    assert port_art.keys() == jax_art.keys()
    assert len(port_art["records"]) == len(jax_art["records"])
    for j, t in zip(jax_art["records"], port_art["records"]):
        assert set(t) == set(j), (j, t)
    assert port_art["device"] == "cpu" and port_art["unit"] == jax_art["unit"]


def test_bench_zoo_artifact_keys(tmp_path, monkeypatch):
    args = ["--models", "vit_test", "convnext_test", "--batch", "2", "--steps", "1",
            "--iters", "1"]
    j, t = _run_both("bench_zoo", bench_zoo.main, args, tmp_path, monkeypatch)
    _same_record_keys(j, t)
    for jr, tr in zip(j["records"], t["records"]):
        assert (tr["backbone"], tr["metric"], tr["fused_attention"], tr["fused_block"]) == (
            jr["backbone"], jr["metric"], jr["fused_attention"], jr["fused_block"])
        assert tr["value"] > 0


def test_bench_zoo_records_a_failed_backbone_and_exits_1(tmp_path):
    path = str(tmp_path / "zoo.json")
    assert bench_zoo.main(["--models", "no_such_model", "vit_test", "--batch", "1", "--steps",
                           "1", "--iters", "1", "--fused-block", "--device", "cpu",
                           "--json", path]) == 1
    bad, good = json.load(open(path))["records"]
    assert bad["value"] is None and "KeyError" in bad["error"]
    assert good["value"] > 0 and "error" not in good
    # asked for, and what the ViT's config ran (f32 compute at vit_test: the
    # field is set, the kernel engages only in bf16)
    assert good["fused_block"] is True and good["fused_attention"] is True


def test_bench_train_artifact_keys(tmp_path, monkeypatch):
    # one mode: every mode's record has the same keys (the loss test below builds all three)
    args = ["--tiny", "--modes", "lora_pa", "--batch", "2", "--iters", "1"]
    j, t = _run_both("bench_train", bench_train.main, args, tmp_path, monkeypatch)
    _same_record_keys(j, t)
    assert [r["metric"] for r in t["records"]] == [r["metric"] for r in j["records"]]
    assert all(r["mfu_pct_analytic"] is None and r["device_kind"] == "cpu" for r in t["records"])


@pytest.mark.parametrize("mode", ["full", "lora", "lora_pa"])
def test_bench_train_tiny_first_step_loss_matches_jax(mode):
    jbt = _jax_tool("bench_train")
    built = jbt.build_step(mode, 4, False, tiny=True)
    _, m = built["step"](built["state"], built["images"], built["labels"], built["valid"])
    want = float(m["loss_sum"])
    # bench_train's params: vit.init of its jitted build at key 0
    params = jvit.init(jax.random.key(0), jvit.VIT_TEST.with_classes(5))
    data = {"params": {p: torch.from_numpy(np.array(v))
                       for p, v in jtrees.flatten_with_paths(params).items()},
            "images": torch.from_numpy(np.array(built["images"])),
            "labels": torch.from_numpy(np.array(built["labels"])),
            "valid": torch.from_numpy(np.array(built["valid"]))}
    ours = bench_train.build_step(mode, 4, False, torch.device("cpu"), tiny=True, data=data)
    state, m = ours["step"](ours["state"], ours["images"], ours["labels"], ours["valid"])
    np.testing.assert_allclose(float(m["loss_sum"]), want, rtol=1e-5)
    assert ours["model"] == "vit_test" and state.step == 1


def test_bench_eval_artifact_keys(tmp_path, monkeypatch):
    args = ["--models", "vit_test", "--batch", "2", "--iters", "2", "--sweep_batch", "3"]
    j, t = _run_both("bench_eval", bench_eval.main, args, tmp_path, monkeypatch)
    _same_record_keys(j, t)
    assert [(r["batch"], r["int8"]) for r in t["records"]] == [(3, False), (2, False)]


def test_bench_eval_int8_row_and_chain():
    v, s = bench_eval.bench_one("vit_test", 2, 2, torch.device("cpu"), int8=True)
    assert v > 0 and np.isfinite(s)
    # the chain depends on every pass: one more pass moves the output
    sweep1, images = bench_eval.build("vit_test", 2, 1, torch.device("cpu"))
    sweep2, _ = bench_eval.build("vit_test", 2, 2, torch.device("cpu"))
    assert float(sweep1(images)) != float(sweep2(images))


def test_bench_compose_artifact_keys(tmp_path, monkeypatch):
    args = ["--tiny", "--n_per_dataset", "3", "--datasets", "2", "--batch", "2"]
    j, t = _run_both("bench_compose", bench_compose.main, args, tmp_path, monkeypatch)
    assert t.keys() == j.keys()
    for k, v in j.items():
        if isinstance(v, dict):
            assert t[k].keys() == v.keys() and t[k]["device"] is None and t[k]["host"] > 0
        elif k != "device":
            assert t[k] == v, k
    assert t["variants"] == 27


def _jax_table_keys():
    """The keys of ``tools/trace_table.py``'s JSON table and of its op records."""
    tree = ast.parse(open(os.path.join(REPO, "tools", "trace_table.py")).read())
    dicts = [n for n in ast.walk(tree) if isinstance(n, ast.Dict) and n.keys
             and all(isinstance(k, ast.Constant) for k in n.keys)]
    keys = [{k.value for k in d.keys} for d in dicts]
    return next(k for k in keys if "ops" in k), next(k for k in keys if "op" in k)


def test_profile_pgd_and_eval_tables(tmp_path, monkeypatch):
    top_keys, op_keys = _jax_table_keys()
    for name, port_main, args in (
            ("profile_pgd", profile_pgd.main, ["--backbone", "vit_test", "--batch", "2",
                                               "--steps", "1", "--out", str(tmp_path / "p")]),
            ("profile_eval", profile_eval.main, ["--backbone", "vit_test", "--batch", "2",
                                                 "--iters", "1", "--out", str(tmp_path / "e")])):
        j, t = _run_both(name, port_main, args, tmp_path, monkeypatch)
        assert set(j) == top_keys <= set(t)
        assert set(t) - top_keys == {"groups", "intervals", "busy_ms", "wall_ms", "idle_share"}
        # a CPU run: a trace file, no device numbers
        assert os.path.exists(t["trace"]) and t["trace"].endswith(".pt.trace.json")
        assert t["device_total_ms"] is None and t["busy_ms"] is None and t["ops"] == []
    assert op_keys == {"op", "total_ms", "count", "pct"}


def test_profile_train_traces_bench_trains_step(tmp_path):
    built = bench_train.build_step("lora", 2, True, torch.device("cpu"), tiny=True)
    table = profile_train.trace_step(built, str(tmp_path / "t"), torch.device("cpu"))
    assert os.path.exists(table["trace"]) and table["busy_ms"] is None
    assert built["state"].step == 2  # the warm-up step and the traced one


def test_refused_and_absent():
    with pytest.raises(SystemExit):
        bench_zoo.main(["--no-fused", "--device", "cpu"])
    with pytest.raises(SystemExit):
        profile_pgd.main(["--scan", "--device", "cpu"])
    with pytest.raises(SystemExit):  # --device replaces the JAX tool's --platform
        bench_compose.main(["--platform", "cpu"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_eval.main(["--device", "cuda"])


def _event(name, start, end):
    return SimpleNamespace(name=name, device_type=torch.autograd.DeviceType.CUDA,
                           time_range=SimpleNamespace(start=start, end=end))


def test_trace_table_groups_union_and_idle_share():
    host = SimpleNamespace(name="aten::mm", device_type=torch.autograd.DeviceType.CPU,
                           time_range=SimpleNamespace(start=0, end=10_000))
    events = [host, _event("apvt_attn_fwd_wgmma", 0, 1000), _event("apvt_attn_bwd", 500, 2000),
              _event("sm90_xmma_gemm_bf16", 3000, 4000), _event("sm90_xmma_gemm_bf16", 4000, 4500),
              _event("vectorized_elementwise_kernel", 6000, 6500)]
    prof = SimpleNamespace(events=lambda: events)
    t = trace_table.summarize(prof, wall_ms=10.0, top=2, trace="x.json")
    assert t["device_total_ms"] == pytest.approx(4.5)
    assert t["busy_ms"] == pytest.approx(4.0)  # 0-2000, 3000-4500, 6000-6500 us
    assert t["idle_share"] == pytest.approx(0.6) and t["intervals"] == 5
    groups = {g["group"]: (g["total_ms"], g["count"]) for g in t["groups"]}
    assert groups == {"packed attention fwd (this repo)": (1.0, 1),
                      "packed attention bwd (this repo)": (1.5, 1),
                      "GEMMs (cuBLAS)": (1.5, 2),
                      "other elementwise, fills, reductions": (0.5, 1)}
    assert [o["op"] for o in t["ops"]] == ["apvt_attn_bwd", "sm90_xmma_gemm_bf16"]
    assert t["ops"][1]["count"] == 2 and t["ops"][1]["pct"] == pytest.approx(100 * 1.5 / 4.5)
    text = trace_table.lines(t, "head", "what", "[card]", top=1)
    assert text[0] == ("head what [card]: unprofiled 10.00 ms/call; one traced call: device "
                       "busy 4.00 ms (union of 5 kernel intervals), kernel time 4.50 ms, idle "
                       "share of the unprofiled wall 60.0%")
    assert len(text) == 1 + 4 + 1 and "top kernel" in text[-1]
