"""Device time of a call on the card, and the device helpers of the
measurement scripts (``bench_torch.py``, ``chip_smoke.py`` and the tools of
this package)."""

from __future__ import annotations

import subprocess


def resolve_device(name: str):
    """``--device`` -> ``torch.device``; the card when asked for and absent
    is an error (a measurement never falls back to the CPU)."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device (torch.cuda.is_available() is false). "
                         f"The tools measure on the card; pass --device cpu to run on the CPU")
    return device


def device_kind(device) -> str:
    """The device's name as the artifacts record it: the card's, or "cpu"."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device.index or 0)
    return device.type


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of the first card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def fetch_sum(x) -> float:
    """Wait for the device, then fetch ``x.sum()`` to the host: the end of a
    timed region whose output depends on every call in it."""
    import torch

    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return float(x.detach().sum())


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over ``iters`` calls (after one
    warm-up), by CUDA events around the whole run: host time between
    launches counts."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA graph,
    the replay timed with CUDA events (after a warm-up call and a warm replay).
    No host time: a call shorter than its host work (a kernel of tens of
    microseconds behind a Python wrapper) shows its own time, not the host's."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
