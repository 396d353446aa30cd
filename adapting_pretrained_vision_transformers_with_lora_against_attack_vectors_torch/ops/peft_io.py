"""PEFT-format LoRA adapter directories, read and written.

Counterpart of the JAX package's ``ops/peft_io.py``, with its file layout,
so adapters written by either package (or by HF PEFT) load in the other:

* ``adapter_config.json`` (``r``, ``lora_alpha``, ``lora_dropout``,
  ``target_modules``...) and ``adapter_model.safetensors``;
* ViT targets under HF-PEFT keys, one per encoder layer, factors transposed
  to torch's ``(out, in)`` convention (``lora_A`` ``(r, in)``, ``lora_B``
  ``(out, r)``): ``base_model.model.vit.encoder.layer.{i}.attention.
  attention.query.lora_A.weight`` and so on;
* other backbones' targets (Swin) under ``framework.{path}.lora_A/B`` with
  the full stacked shapes;
* a linear head as PEFT's ``classifier`` copy (``modules_to_save``), any
  other head tree under ``framework_head.{path}``.

Factors and the classifier are written in float32, as the JAX package
writes them; ``framework_head`` leaves keep their dtype. Safetensors files
go through the port's own reader and writer (``utils/checkpoint.py``);
``adapter_model.bin`` is read with ``torch.load(weights_only=True)``.
Loaded tensors are CPU tensors.
"""

from __future__ import annotations

import json
import os
import re
from typing import Mapping, Optional

import torch

from ..utils import checkpoint, trees
from .lora import LoRAConfig

# framework target path -> PEFT module name (per encoder layer i)
_PATH_TO_PEFT = {
    "blocks/attn/q": "vit.encoder.layer.{i}.attention.attention.query",
    "blocks/attn/k": "vit.encoder.layer.{i}.attention.attention.key",
    "blocks/attn/v": "vit.encoder.layer.{i}.attention.attention.value",
    "blocks/attn/o": "vit.encoder.layer.{i}.attention.output.dense",
    "blocks/mlp/fc1": "vit.encoder.layer.{i}.intermediate.dense",
    "blocks/mlp/fc2": "vit.encoder.layer.{i}.output.dense",
}
_MODULE_TO_PATH = {tmpl.split("{i}.", 1)[1]: path for path, tmpl in _PATH_TO_PEFT.items()}
_PEFT_RE = re.compile(
    r"base_model\.model\.vit\.encoder\.layer\.(\d+)\."
    r"(attention\.attention\.(?:query|key|value)|attention\.output\.dense|"
    r"intermediate\.dense|output\.dense)\.lora_(A|B)\.weight")
# PEFT's target_modules names (suffix-matched: "output.dense" hits both the
# attention output and the MLP down projection)
_PATH_TO_TARGET = {"blocks/attn/q": "query", "blocks/attn/k": "key",
                   "blocks/attn/v": "value", "blocks/attn/o": "output.dense",
                   "blocks/mlp/fc1": "intermediate.dense", "blocks/mlp/fc2": "output.dense"}
_CLASSIFIER_KEYS = ("base_model.model.classifier.weight",
                    "base_model.model.classifier.modules_to_save.default.weight")


def peft_targets_to_paths(target_modules) -> tuple[str, ...]:
    """Expand PEFT ``target_modules`` (suffix-matched) into framework paths."""
    paths: list[str] = []
    for t in target_modules:
        paths += [p for p, name in _PATH_TO_TARGET.items() if name == t and p not in paths]
    return tuple(paths)


def paths_to_peft_targets(paths) -> list[str]:
    out: list[str] = []
    for p in paths:
        name = _PATH_TO_TARGET.get(p, p)
        if name not in out:
            out.append(name)
    return out


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu().float()


def save_peft_adapter(adapter: Mapping, cfg: LoRAConfig, out_dir: str, *,
                      head: Optional[Mapping] = None,
                      base_model_name: str = "google/vit-base-patch16-224") -> None:
    """Write ``adapter_config.json`` + ``adapter_model.safetensors``.

    ``head``: optional classifier params, ``{"w": (in, out), "b": (out,)}``
    (written as PEFT's ``classifier``) or any other head tree (written under
    ``framework_head.``). With a head the adapter is saved as a ``SEQ_CLS``
    task with ``modules_to_save=["classifier"]``, as the reference trains it.
    """
    os.makedirs(out_dir, exist_ok=True)
    tensors: dict[str, torch.Tensor] = {}
    for path, fac in adapter.items():
        a, b = _f32(fac["a"]), _f32(fac["b"])
        if path not in _PATH_TO_PEFT:
            tensors[f"framework.{path}.lora_A"] = a
            tensors[f"framework.{path}.lora_B"] = b
            continue
        for i in range(a.shape[0]):
            mod = _PATH_TO_PEFT[path].format(i=i)
            tensors[f"base_model.model.{mod}.lora_A.weight"] = a[i].T
            tensors[f"base_model.model.{mod}.lora_B.weight"] = b[i].T
    if head is not None:
        if "w" in head:
            tensors["base_model.model.classifier.weight"] = _f32(head["w"]).T
            tensors["base_model.model.classifier.bias"] = _f32(head["b"])
        else:
            for path, leaf in trees.flatten_with_paths(head).items():
                tensors[f"framework_head.{path}"] = torch.as_tensor(leaf).detach().cpu()
    checkpoint.save_tensors(tensors, os.path.join(out_dir, "adapter_model.safetensors"))

    config = {
        "peft_type": "LORA",
        "task_type": "SEQ_CLS" if head is not None else None,
        "base_model_name_or_path": base_model_name,
        "r": cfg.rank,
        "lora_alpha": cfg.alpha,
        "lora_dropout": cfg.dropout,
        # sorted paths, as the JAX package's tree traversal orders them
        "target_modules": paths_to_peft_targets(sorted(adapter)),
        "bias": "none",
        "fan_in_fan_out": False,
        "inference_mode": True,
        "modules_to_save": ["classifier"] if head is not None else None,
        "use_rslora": False,
        "use_dora": False,
    }
    with open(os.path.join(out_dir, "adapter_config.json"), "w") as f:
        json.dump(config, f, indent=2)


def load_peft_adapter(adapter_dir: str, *, depth: Optional[int] = None
                      ) -> tuple[dict, LoRAConfig, Optional[dict]]:
    """Read a PEFT LoRA directory into ``(adapter, LoRAConfig, head-or-None)``;
    ViT factors come back stacked on the layer axis in ``(in, out)`` form."""
    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        config = json.load(f)
    if config.get("peft_type") != "LORA":
        raise ValueError(f"not a LoRA adapter: peft_type={config.get('peft_type')}")
    tensors = _read_adapter_tensors(adapter_dir)

    adapter: dict = {}
    per_path: dict[str, dict[int, dict[str, torch.Tensor]]] = {}
    for key, t in tensors.items():
        if key.startswith("framework."):
            body, which = key[len("framework."):].rsplit(".lora_", 1)
            adapter.setdefault(body, {})["a" if which == "A" else "b"] = t
            continue
        m = _PEFT_RE.fullmatch(key)
        if m is not None:
            layer, path = int(m.group(1)), _MODULE_TO_PATH[m.group(2)]
            per_path.setdefault(path, {}).setdefault(layer, {})[m.group(3)] = t
    for path, layers in per_path.items():
        n = depth if depth is not None else max(layers) + 1
        missing = [i for i in range(n) if i not in layers]
        if missing:
            raise ValueError(f"adapter missing layer {missing[0]} for {path}")
        adapter[path] = {"a": torch.stack([layers[i]["A"].T for i in range(n)]),
                         "b": torch.stack([layers[i]["B"].T for i in range(n)])}

    cfg = LoRAConfig(rank=int(config["r"]), alpha=float(config["lora_alpha"]),
                     targets=tuple(sorted(adapter)),
                     dropout=float(config.get("lora_dropout") or 0.0))
    fh = {k[len("framework_head."):]: t for k, t in tensors.items()
          if k.startswith("framework_head.")}
    if fh:
        return adapter, cfg, trees.unflatten_from_paths(fh)
    for w_key in _CLASSIFIER_KEYS:
        if w_key in tensors:
            b_key = w_key.rsplit(".", 1)[0] + ".bias"
            return adapter, cfg, {"w": tensors[w_key].T.contiguous(), "b": tensors[b_key]}
    return adapter, cfg, None


def _read_adapter_tensors(adapter_dir: str) -> dict[str, torch.Tensor]:
    st = os.path.join(adapter_dir, "adapter_model.safetensors")
    if os.path.exists(st):
        return checkpoint.load_tensors(st)[0]
    bin_path = os.path.join(adapter_dir, "adapter_model.bin")
    if os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {k: v.detach() for k, v in sd.items()}
    raise FileNotFoundError(f"no adapter weights in {adapter_dir}")
