"""Model registry: the five backbone families (ViT and DINOv1, Swin, ConvNeXt, YOLO11-cls).

Counterpart of the JAX package's ``models/registry.py``. Each entry gives:

* ``config(num_classes)`` — static architecture config
* ``init(cfg, generator, device=None)`` — seeded params in the JAX layout
* ``from_tree(flat, cfg)`` — the module built from such a tree
* ``to_tree(model)`` — back: flat '/' paths -> CPU tensors (real copies)
* ``apply(cfg, model, images)`` — logits
* ``lora_targets(cfg)`` — default adapter target paths
* ``normalization`` — preprocessing mean/std (ImageNet for every backbone)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from . import convnext as _convnext
from . import swin as _swin
from . import vit as _vit
from . import yolo11 as _yolo11

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    family: str
    config: Callable  # (num_classes) -> cfg
    init: Callable  # (cfg, generator, device=None) -> JAX-layout tree
    from_tree: Callable  # (flat tree, cfg) -> nn.Module
    to_tree: Callable  # (nn.Module) -> flat JAX-layout tree of CPU tensors
    apply: Callable  # (cfg, model, images) -> logits
    lora_targets: Callable  # (cfg) -> tuple[str, ...]
    normalization: tuple = (IMAGENET_MEAN, IMAGENET_STD)


_REGISTRY: dict[str, ModelEntry] = {}


def register(entry: ModelEntry) -> None:
    _REGISTRY[entry.name] = entry


def get_model(name: str) -> ModelEntry:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def create_model(name: str, num_classes: int, generator=None, *, device=None):
    """Returns ``(entry, cfg, model)`` with seeded random params."""
    entry = get_model(name)
    cfg = entry.config(num_classes)
    model = entry.from_tree(entry.init(cfg, generator, device=device), cfg)
    return entry, cfg, model


def get_normalization(model_name: str) -> tuple:
    """ImageNet mean/std for every registered backbone."""
    return get_model(model_name).normalization if model_name in _REGISTRY else (
        IMAGENET_MEAN, IMAGENET_STD)


def _vit_entry(name: str, base_cfg) -> ModelEntry:
    return ModelEntry(
        name=name,
        family="vit",
        config=lambda num_classes, _b=base_cfg: _b.with_classes(num_classes),
        init=_vit.init,
        from_tree=_vit.params_from_jax,
        to_tree=_vit.params_to_jax,
        apply=_vit.apply,
        lora_targets=lambda cfg: _vit.LORA_TARGETS_DEFAULT,
    )


def _entry(name: str, family: str, module, base_cfg) -> ModelEntry:
    """A backbone whose module has init/params_from_jax/apply/lora_target_paths."""
    return ModelEntry(
        name=name,
        family=family,
        config=lambda num_classes, _b=base_cfg: _b.with_classes(num_classes),
        init=module.init,
        from_tree=module.params_from_jax,
        to_tree=module.params_to_jax,
        apply=module.apply,
        lora_targets=module.lora_target_paths,
    )


register(_vit_entry("google_vit", _vit.VIT_B16))
register(_vit_entry("vit_tiny", _vit.VIT_TINY))
register(_vit_entry("vit_test", _vit.VIT_TEST))
# DINOv1: architecturally ViT-B/16 (weights from the head-less DINO checkpoint)
register(_vit_entry("dinov1", _vit.VIT_B16))
register(_entry("swin", "swin", _swin, _swin.SWIN_B))
register(_entry("swin_test", "swin", _swin, _swin.SWIN_TEST))
register(_entry("convnext", "convnext", _convnext, _convnext.CONVNEXT_B))
register(_entry("convnext_test", "convnext", _convnext, _convnext.CONVNEXT_TEST))
register(_entry("yolo11-cls", "yolo11", _yolo11, _yolo11.YOLO11N_CLS))
register(_entry("yolo11_test", "yolo11", _yolo11, _yolo11.YOLO11_TEST))
