"""Observability: structured JSONL metrics, step timing, a profiler scope
and a NaN guard.

Counterpart of the JAX package's ``utils/observability.py``:

* :class:`MetricsLogger`: append-only JSONL event stream (one object per
  line: ts, step, event, payload) next to the run's artifacts, with the same
  keys as the JAX class writes;
* :class:`StepTimer`: EMA step timing and images/s on the host clock (the
  caller synchronizes where it needs device time);
* :func:`profile_trace`: a ``torch.profiler`` scope that records host and,
  where there is a card, CUDA activity, and writes a TensorBoard-loadable
  trace under its directory;
* :func:`assert_finite`: NaN/Inf guard for dict trees at stage boundaries (a
  debug tool; it copies every leaf to the host).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Iterator, Optional

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


class StepTimer:
    """EMA step timing; call :meth:`tick` once per step on the host."""

    def __init__(self, *, ema: float = 0.9):
        self._ema = ema
        self._avg: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._avg = dt if self._avg is None else (
                self._ema * self._avg + (1 - self._ema) * dt)
        self._last = now
        return dt

    @property
    def seconds_per_step(self) -> Optional[float]:
        return self._avg

    def images_per_second(self, batch_size: int) -> Optional[float]:
        return batch_size / self._avg if self._avg else None


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """``torch.profiler`` scope writing its trace under ``log_dir`` on exit
    (``tensorboard_trace_handler``: ``<worker>.<ms>.pt.trace.json``); yields
    the profiler, whose ``events()`` the caller may read after the block.
    Inert, yielding None, when ``log_dir`` is empty."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def assert_finite(tree: Any, *, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first non-finite leaf path."""
    from . import trees

    for path, leaf in trees.flatten_with_paths(tree).items():
        t = torch.as_tensor(leaf)
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            bad = int((~torch.isfinite(t)).sum())
            raise FloatingPointError(f"{name}/{path}: {bad}/{t.numel()} non-finite values")
