"""Device time of a call on the card, for the measurement scripts
(``chip_smoke.py``, ``tools/dwconv_diagnose.py``)."""

from __future__ import annotations


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
