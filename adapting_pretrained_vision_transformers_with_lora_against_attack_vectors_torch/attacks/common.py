"""Shared attack machinery.

Counterpart of the JAX package's ``attacks/common.py``. Attacks operate on
**unnormalized [0,1] NHWC images** and fold the model's normalization into
the differentiated loss, so the Linf ball, the [0,1] clamp and the uint8 PNG
quantization stay exact in pixel space.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Normalizer:
    """Per-channel mean/std normalization folded into attack losses."""

    mean: tuple[float, float, float]
    std: tuple[float, float, float]

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        on_card = images.device.type == "cuda"
        mean, std = _constants(tuple(self.mean), tuple(self.std), images.dtype, on_card)
        if on_card:
            mean = mean.to(images.device, non_blocking=True)
            std = std.to(images.device, non_blocking=True)
        return (images - mean) / std


@functools.lru_cache(maxsize=64)
def _constants(mean: tuple, std: tuple, dtype: torch.dtype, pinned: bool):
    """``mean`` and ``std`` as host tensors, made once per values and dtype
    (and shared: never written to); ``pinned`` for images on the card. A
    copy from pinned memory does not wait for the card, where one from a
    tensor made from a tuple (pageable) does, and PGD normalizes once a
    step. Each call copies them to the card and frees the copies with the
    call: the card holds no constant between calls (a training step's
    memory peak counts every byte it holds)."""
    out = (torch.tensor(mean, dtype=dtype), torch.tensor(std, dtype=dtype))
    return tuple(t.pin_memory() for t in out) if pinned else out


IMAGENET = Normalizer((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def to_unit_floats(images: torch.Tensor) -> torch.Tensor:
    """uint8 batches become [0,1] float32 on the tensor's own device; float
    inputs (already [0,1]) pass through unchanged. The divisor is a tensor on
    that device: CUDA divides by a CPU scalar as a product with its
    reciprocal, one ulp off the quotient for 126 of the 256 values, which
    moves truncated adversarial pixels by one level."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / images.new_full((), 255.0, dtype=torch.float32)
    return images


def linf_project(x: torch.Tensor, origin: torch.Tensor, eps: float) -> torch.Tensor:
    """Project onto the Linf ball around ``origin`` intersected with [0,1]."""
    return torch.clamp(x, (origin - eps).clamp_min(0.0), (origin + eps).clamp_max(1.0))


def sum_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed CE: each example's input gradient keeps its full magnitude."""
    return F.cross_entropy(logits.float(), labels.long(), reduction="sum")


@contextlib.contextmanager
def frozen(params):
    """Every parameter of a module ``params`` frozen inside the block, each
    one's ``requires_grad`` restored on the way out (also when the block
    raises). An attack takes the gradient of its input only: a kernel's
    ``autograd.Function`` decides at forward time from ``requires_grad``
    whether its backward recomputes the parameter gradients."""
    saved = ([(p, p.requires_grad) for p in params.parameters()]
             if isinstance(params, torch.nn.Module) else [])
    for p, _ in saved:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in saved:
            p.requires_grad_(flag)


def uint8_quantize(images) -> np.ndarray:
    """[0,1] float -> uint8 with truncation (``(img * 255).astype(np.uint8)``),
    the grid downstream stages see. Device tensors are copied to the host."""
    if isinstance(images, torch.Tensor):
        images = images.detach().cpu().float().numpy()
    arr = np.clip(np.asarray(images), 0.0, 1.0)
    return (arr * 255.0).astype(np.uint8)


def from_uint8(images: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1] on the host (the inverse grid of
    :func:`uint8_quantize`)."""
    return images.astype(np.float32) / 255.0
