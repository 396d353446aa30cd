"""Observability: structured JSONL metrics and a NaN guard.

Counterpart of the JAX package's ``utils/observability.py``:

* :class:`MetricsLogger`: append-only JSONL event stream (one object per
  line: ts, step, event, payload) next to the run's artifacts, with the same
  keys as the JAX class writes;
* :func:`assert_finite`: NaN/Inf guard for dict trees at stage boundaries (a
  debug tool; it copies every leaf to the host).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

import torch


class MetricsLogger:
    """Append-only JSONL metrics (``{"ts":..., "step":..., "event":..., ...}``)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")

    def log(self, event: str, *, step: Optional[int] = None, **payload) -> None:
        if self._f is None:
            return
        rec = {"ts": round(time.time(), 3), "event": event}
        if step is not None:
            rec["step"] = int(step)
        for k, v in payload.items():
            if hasattr(v, "item"):
                v = v.item()
            rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def assert_finite(tree: Any, *, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first non-finite leaf path."""
    from . import trees

    for path, leaf in trees.flatten_with_paths(tree).items():
        t = torch.as_tensor(leaf)
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            bad = int((~torch.isfinite(t)).sum())
            raise FloatingPointError(f"{name}/{path}: {bad}/{t.numel()} non-finite values")
