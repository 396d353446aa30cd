"""Metrics from an accumulated confusion matrix.

Counterpart of the JAX package's ``train/metrics.py``: accuracy and
weighted precision/recall/F1 (sklearn ``average='weighted'`` semantics)
derive exactly from the (C, C) confusion matrix the eval step accumulates
on the device. numpy only.
"""

from __future__ import annotations

import numpy as np


def confusion_matrix_metrics(conf) -> dict:
    """Accuracy + weighted precision/recall/F1 from a (C, C) confusion matrix
    with rows = true class, cols = predicted class."""
    conf = np.asarray(conf, np.float64)
    support = conf.sum(axis=1)  # per true class
    predicted = conf.sum(axis=0)
    tp = np.diag(conf)
    total = conf.sum()

    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(predicted > 0, tp / predicted, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall / (precision + recall), 0.0)

    weights = support / max(total, 1.0)
    return {
        "accuracy": float(tp.sum() / max(total, 1.0)),
        "f1": float((f1 * weights).sum()),
        "precision": float((precision * weights).sum()),
        "recall": float((recall * weights).sum()),
        "support": float(total),
    }
