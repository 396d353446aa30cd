"""Observability: structured JSONL metrics, the program's trace spans, a
profiler scope and a NaN guard.

Counterpart of the JAX package's ``utils/observability.py``:

* :class:`MetricsLogger`: append-only JSONL event stream (one object per
  line: ts, step, event, payload) next to the run's artifacts, with the same
  keys as the JAX class writes;
* :func:`span`: a named range of the program (``apvt.<name>``) on the
  profiler's timeline, opened only while a profiler records;
* :func:`profile_trace`: a ``torch.profiler`` scope that records host and,
  where there is a card, CUDA activity, and writes a TensorBoard-loadable
  trace under its directory;
* :func:`assert_finite`: NaN/Inf guard for dict trees at stage boundaries (a
  debug tool; it copies every leaf to the host).

Host step timing is the callers' own (``tools/timing``, the benchmark's
clock); the JAX package's ``StepTimer`` has no counterpart here.
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


SPAN_PREFIX = "apvt."  # the program's spans on the profiler's timeline
_CLOSED = contextlib.nullcontext()  # what a span is while no profiler records


def span(name: str):
    """The program's range ``apvt.<name>`` on the profiler's timeline: a
    ``torch.profiler.record_function`` while a profiler records, so its host
    interval lies on the trace's timeline beside the device's operations
    (whose timestamps the profiler converts to the host's clock); nested
    spans nest there. With no profiler on it opens nothing: one shared
    ``contextlib.nullcontext()`` (a ``record_function`` costs microseconds an
    enter and exit even then, and an attack batch opens over a hundred). A
    torch without the profiler's flag gets the ``record_function`` always."""
    if getattr(torch.autograd.profiler, "_is_profiler_enabled", True):
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _CLOSED


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
