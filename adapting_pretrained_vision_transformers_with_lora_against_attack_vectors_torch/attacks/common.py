"""Shared attack machinery.

Counterpart of the JAX package's ``attacks/common.py``. Attacks operate on
**unnormalized [0,1] NHWC images** and fold the model's normalization into
the differentiated loss, so the Linf ball, the [0,1] clamp and the uint8 PNG
quantization stay exact in pixel space.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Normalizer:
    """Per-channel mean/std normalization folded into attack losses."""

    mean: tuple[float, float, float]
    std: tuple[float, float, float]

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(self.mean, dtype=images.dtype, device=images.device)
        std = torch.tensor(self.std, dtype=images.dtype, device=images.device)
        return (images - mean) / std


IMAGENET = Normalizer((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def to_unit_floats(images: torch.Tensor) -> torch.Tensor:
    """uint8 batches become [0,1] float32 on the tensor's own device; float
    inputs (already [0,1]) pass through unchanged."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    return images


def linf_project(x: torch.Tensor, origin: torch.Tensor, eps: float) -> torch.Tensor:
    """Project onto the Linf ball around ``origin`` intersected with [0,1]."""
    return torch.clamp(x, (origin - eps).clamp_min(0.0), (origin + eps).clamp_max(1.0))


def sum_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed CE: each example's input gradient keeps its full magnitude."""
    return F.cross_entropy(logits.float(), labels.long(), reduction="sum")


def uint8_quantize(images) -> np.ndarray:
    """[0,1] float -> uint8 with truncation (``(img * 255).astype(np.uint8)``),
    the grid downstream stages see. Device tensors are copied to the host."""
    if isinstance(images, torch.Tensor):
        images = images.detach().cpu().float().numpy()
    arr = np.clip(np.asarray(images), 0.0, 1.0)
    return (arr * 255.0).astype(np.uint8)
