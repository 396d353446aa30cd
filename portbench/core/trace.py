"""The traced part of a ``--trace 1`` run and its reduction.

After the measured window, whole units of work (attack batches, training
steps) run under ``torch.profiler`` with CPU and CUDA activity. The
reduction keeps the device operations (name, start, end), the benchmark's
own host spans (:data:`SPANS`, ``torch.profiler.record_function`` ranges
that the drivers open around their calls into the program) and the
program's counters before and after. From them: the device's busy time as
the union of its operation intervals, device time by kernel group (the
frozen :data:`GROUPS`) or by a reader's own pattern, and the idle gaps
between device operations labelled by the host span that was open when each
began.
"""

from __future__ import annotations

import dataclasses
import re
import time

SPANS = ("batch_to_device", "attack_call", "fetch_to_host", "train_step", "optimizer_step")

# device time by kernel group, first match wins: a frozen copy of the port's
# trace-table groups (tools/trace_table.GROUPS) as the port names its kernels
GROUPS = (("dwconv7 (this repo)", r"dwconv7_tma|dwconv7_kernel"),
          ("fused MLP fwd, with or without LN (this repo)", r"ln_mlp_fwd|wg_mlp_fwd"),
          ("fused MLP bwd, with or without LN (this repo)", r"ln_mlp_bwd|wg_mlp_bwd"),
          ("attn_block heads fwd: LN, q/k/v, attention (this repo)", r"heads_fwd"),
          ("attn_block o-projection fwd (this repo)", r"oproj_fwd"),
          ("attn_block heads bwd: recompute, da, attention bwd (this repo)", r"heads_bwd"),
          ("attn_block dh + LN backward (this repo)", r"dh_bwd"),
          ("window attention fwd (this repo)", r"win_fwd"),
          ("window attention bwd (this repo)", r"win_bwd"),
          ("packed attention fwd (this repo)", r"attn_fwd|wgs::stream_fwd|cc::fwd"),
          ("packed attention bwd (this repo)", r"attn_bwd|wgs::stream_(?:bwd|stats)|cc::bwd"),
          ("depthwise conv (cuDNN / ATen)", r"conv|cudnn|depthwise|dgrad|wgrad"),
          ("int8 GEMMs (cuBLASLt, _int_mm)", r"s8s8|i8i8|imma|[Ii]nt8|_s8|_i8"),
          ("GEMMs (cuBLAS)", r"gemm|nvjet|cutlass|cublas|xmma"),
          ("optimizer (foreach Adam/AdamW)", r"multi_tensor|adam|Adam"),
          ("grid_sample (augmentation)", r"grid_sampler"),
          ("softmax, cross-entropy", r"softmax|nll_loss"),
          ("LayerNorm", r"layer_norm|LayerNorm"), ("GELU", r"[Gg]elu"),
          ("round, clamp, abs, row max, div (W8A8 quantizers; PGD's clamps)",
           r"round|clamp|abs_kernel|MaxNan|amax|div_true|DivFunctor"),
          ("copies, casts, cat", r"copy|Copy|cat|Cat|direct_copy|convert"),
          ("index_select / index_add", r"index"),
          ("other elementwise, fills, reductions", r".*"))


def union_s(intervals) -> float:
    """Length of the union of (start, end) microsecond intervals, in s."""
    return sum(b - a for a, b in merged(intervals)) / 1e6


def merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclasses.dataclass
class Trace:
    ops: list  # device operations: (name, start_us, end_us)
    spans: list  # host spans: (name, start_us, end_us)
    units: int  # whole units of work traced
    wall_s: float  # host clock over them, profiler on
    counters: dict  # the program's counters: their increase over the traced units

    @property
    def busy_s(self) -> float:
        return union_s([(a, b) for _, a, b in self.ops])

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(b - a for name, a, b in self.ops if rx.search(name)) / 1e6

    def groups(self) -> list:
        """[[group, device seconds]] by :data:`GROUPS`, largest first."""
        total: dict = {}
        for name, a, b in self.ops:
            g = next(g for g, pat in GROUPS if re.search(pat, name))
            total[g] = total.get(g, 0.0) + (b - a) / 1e6
        return sorted(([g, s] for g, s in total.items()), key=lambda x: -x[1])

    def idle_by_span(self) -> list:
        """[[host span, idle device seconds]]: each gap between device
        operations given to the innermost benchmark span open at its start."""
        busy = merged([(a, b) for _, a, b in self.ops])
        spans = sorted(self.spans, key=lambda s: s[1])
        total: dict = {}
        for (_, end), (start, _) in zip(busy, busy[1:]):
            open_ = [s for s in spans if s[1] <= end < s[2]]
            label = max(open_, key=lambda s: s[1])[0] if open_ else "outside the spans"
            total[label] = total.get(label, 0.0) + (start - end) / 1e6
        return sorted(([k, v] for k, v in total.items()), key=lambda x: -x[1])

    def breakdown(self) -> dict:
        return {"device_ops": self.groups()[:10], "idle_gaps": self.idle_by_span()[:10]}


def profile(driver, units: int) -> Trace:
    """``units`` whole units of ``driver``'s work under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    before = driver.counters()
    driver.drain()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            driver.unit()
        driver.drain()
        wall = time.perf_counter() - t0
    after = driver.counters()
    ops, spans = [], []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            # the profiler mirrors each host range onto the device's timeline
            # (a user annotation, not an operation): those are left out
            if ev.name in SPANS or getattr(ev, "is_user_annotation", False):
                continue
            ops.append((ev.name, ev.time_range.start, ev.time_range.end))
        elif ev.name in SPANS:
            spans.append((ev.name, ev.time_range.start, ev.time_range.end))
    return Trace(ops=ops, spans=spans, units=units, wall_s=wall,
                 counters={k: after[k] - before.get(k, 0) for k in after})
