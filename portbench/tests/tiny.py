"""A copy of the benchmark's data in a temporary root with tiny cells added
as data only: the CPU tests' cells (the families' test-sized configurations
of the program, f32 compute, a few images)."""

from __future__ import annotations

import json
import os
import shutil

from portbench.core import spec

TINY_CONFIGS = {
    "vit_tiny": {"family": "vit", "registry": "vit_test", "source": "test size",
                 "image_size": 32, "patch_size": 8, "hidden_size": 64, "num_hidden_layers": 2,
                 "num_attention_heads": 2, "intermediate_size": 128, "layer_norm_eps": 1e-12,
                 "num_labels": 10, "compute_dtype": "float32", "reduced": [],
                 "w8a8_targets": ["blocks/attn/q", "blocks/mlp/fc1"]},
    "swin_tiny": {"family": "swin", "registry": "swin_test", "source": "test size",
                  "image_size": 32, "patch_size": 4, "window_size": 4, "embed_dim": 32,
                  "depths": [2, 2], "num_heads": [2, 4], "mlp_ratio": 4.0,
                  "layer_norm_eps": 1e-5, "num_labels": 10, "compute_dtype": "float32",
                  "reduced": [], "w8a8_targets": ["stages/0/blocks/mlp/fc1"]},
}
TINY_TRAFFIC = {
    "pgd3_b4": {"driver": "attack", "steps": 3, "eps_over_255": 8,
                "alpha_over_255": 3, "batch": 4, "param_dtype": "float32",
                "trace_units": 1},
    "lora_b4": {"driver": "train", "mode": "lora", "rank": 4, "alpha": 8.0, "dropout": 0.1,
                "train_head": True, "lr": 0.001, "batch": 4, "param_dtype": "float32",
                "trace_units": 2},
    "full_b4": {"driver": "train", "mode": "full", "lr": 0.001, "weight_decay": 0.0001,
                "steplr_epochs": 3, "steplr_gamma": 0.5, "steps_per_epoch": 1, "batch": 4,
                "param_dtype": "float32", "trace_units": 2},
}
# tiny cell -> (config, traffic, the real cell whose limits it is held to)
TINY_CELLS = {
    "vit_tiny.pgd3_b4": ("vit_tiny", "pgd3_b4", "vit_b16_224.pgd30_b64"),
    "swin_tiny.pgd3_b4": ("swin_tiny", "pgd3_b4", "swin_b_224.pgd30_b64"),
    "vit_tiny.lora_b4": ("vit_tiny", "lora_b4", "vit_b16_224.lora_train_b64"),
    "vit_tiny.full_b4": ("vit_tiny", "full_b4", "vit_b16_224.full_train_b64"),
}


def write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def make_root(dst: str) -> str:
    """A root holding BENCHMARK.json and portbench/ copied from the
    repository, with the tiny cells added as new files and entries."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(spec.HERE, os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.benchmark(dst)
    for name, conf in TINY_CONFIGS.items():
        write(os.path.join(dst, "portbench", "configs", f"{name}.json"), conf)
        bench["configs"].append({"name": name, "source": "test size",
                                 "file": f"portbench/configs/{name}.json", "reduced": [],
                                 "why": "test size"})
    for name, traffic in TINY_TRAFFIC.items():
        write(os.path.join(dst, "portbench", "traffic", f"{name}.json"), traffic)
    for cell, (conf, traffic, like) in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": conf, "traffic": traffic,
                                   "chips": 1, "why": "test size"})
        shutil.copy(os.path.join(dst, "portbench", "limits", f"{like}.json"),
                    os.path.join(dst, "portbench", "limits", f"{cell}.json"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    write(os.path.join(dst, "BENCHMARK.json"), bench)
    return dst
