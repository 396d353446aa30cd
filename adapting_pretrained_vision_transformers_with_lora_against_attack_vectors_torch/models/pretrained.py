"""Pretrained-weight loading facade over the per-family importers.

Counterpart of the JAX package's ``models/pretrained.py``. Loading is
file-based only (no download): a local checkpoint, an HF model directory,
``model.safetensors``, ``pytorch_model.bin`` or the reference's torch
``.pth`` state dict, goes through the importer of the registry entry's
family; ``checkpoint=None`` is a seeded random init.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..utils import trees
from . import hf_import
from .registry import get_model


def load_pretrained(name: str, num_classes: int, checkpoint: Optional[str], *,
                    generator: Optional[torch.Generator] = None, device=None):
    """Returns ``(entry, cfg, tree)``: the JAX-layout tree, on ``device`` when given.

    Families: vit/dinov1, swin and convnext in HF-transformers or timm naming
    (detected from ``patch_embed.proj.weight`` / ``stem.0.weight``), and
    yolo11 in ultralytics naming, whose classifier is zero-initialized when
    the checkpoint's class count is not ``num_classes``. A missing file
    raises ``FileNotFoundError``, a family without an importer ``ValueError``."""
    entry = get_model(name)
    cfg = entry.config(num_classes)
    if checkpoint is None:
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        return entry, cfg, entry.init(cfg, g, device=device)

    if not os.path.exists(checkpoint):
        raise FileNotFoundError(checkpoint)
    sd = hf_import.load_checkpoint_state_dict(checkpoint)

    is_timm = "patch_embed.proj.weight" in sd or "stem.0.weight" in sd
    if entry.family == "vit":
        if is_timm:
            tree = hf_import.vit_params_from_timm(
                sd, cfg, allow_missing_head="head.weight" not in sd)
        else:
            prefix = "vit." if any(k.startswith("vit.") for k in sd) else ""
            tree = hf_import.vit_params_from_hf(
                sd, cfg, prefix=prefix, allow_missing_head="classifier.weight" not in sd)
    elif entry.family == "swin":
        tree = (hf_import.swin_params_from_timm(sd, cfg) if is_timm
                else hf_import.swin_params_from_hf(sd, cfg))
    elif entry.family == "convnext":
        tree = (hf_import.convnext_params_from_timm(sd, cfg) if is_timm
                else hf_import.convnext_params_from_hf(sd, cfg))
    elif entry.family == "yolo11":
        lin = next((k for k in sd if k.endswith("linear.weight")), None)
        n_ckpt = sd[lin].shape[0] if lin is not None else -1
        tree = hf_import.yolo11_params_from_ultralytics(
            sd, cfg, allow_missing_head=n_ckpt != cfg.num_classes)
    else:
        raise ValueError(f"no weight importer for family {entry.family!r} "
                         f"(model {name!r}); omit checkpoint for random init")
    if device is not None:
        tree = trees.map_leaves(lambda t: t.to(device), tree)
    return entry, cfg, tree
