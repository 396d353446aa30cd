"""Epoch-level loops (``evaluate``; the trainers come with training).

Counterpart of the JAX package's ``train/loop.py:evaluate``: batches go to
the device as uint8, the loss sum and confusion matrix add up there, and
the totals cross to the host once, at the end.
"""

from __future__ import annotations

import torch

from .metrics import confusion_matrix_metrics


def evaluate(eval_step, params, loader, *, device=None) -> dict:
    """Run ``eval_step`` over a loader of ``Batch``es; returns accuracy,
    weighted F1, mean loss and support. ``device`` defaults to the CPU."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    loss_sum = conf_sum = None
    for batch in loader:
        images, labels, valid = (torch.as_tensor(a).to(device)
                                 for a in (batch.images, batch.labels, batch.valid))
        loss, conf = eval_step(params, images, labels, valid)
        loss_sum = loss if loss_sum is None else loss_sum + loss
        conf_sum = conf if conf_sum is None else conf_sum + conf
    if conf_sum is None:
        return {"accuracy": 0.0, "f1": 0.0, "loss": 0.0, "support": 0.0}
    m = confusion_matrix_metrics(conf_sum.cpu().numpy())
    m["loss"] = float(loss_sum.cpu()) / max(m["support"], 1.0)
    return m
