"""The eval step (the train step comes with the training stages).

Counterpart of the JAX package's ``train/steps.py:make_eval_step``: uint8
images become [0,1] floats and are normalized on the device, the model
gives f32 logits, and the step returns the summed cross-entropy over the
``valid`` rows and a (C, C) confusion matrix (rows = true class, cols =
predicted), both still on the device, so a loop can sum them there and
fetch once.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from ..attacks.common import IMAGENET, Normalizer, to_unit_floats


def make_eval_step(forward: Callable[[Any, torch.Tensor], torch.Tensor], num_classes: int, *,
                   normalize: Optional[Normalizer] = IMAGENET) -> Callable:
    """``(params, images, labels, valid) -> (loss_sum, confusion)``.

    ``forward(params, normalized_images) -> logits``; ``valid`` is a float
    mask (B,), 1 for real samples and 0 for padding."""

    @torch.no_grad()
    def eval_step(params, images, labels, valid):
        x = to_unit_floats(images)
        logits = forward(params, normalize(x) if normalize is not None else x).float()
        labels = labels.long()
        valid = valid.float()
        ce = F.cross_entropy(logits, labels, reduction="none")
        preds = logits.argmax(dim=-1)
        conf = torch.zeros(num_classes * num_classes, dtype=torch.float32, device=logits.device)
        conf.index_add_(0, labels * num_classes + preds, valid)
        return (ce * valid).sum(), conf.reshape(num_classes, num_classes)

    return eval_step
