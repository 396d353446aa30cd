"""Device time of a ``torch.profiler`` trace, by kernel group: the table that
``chip_smoke.py --profile`` and the port's ``profile_*`` tools print.

Counterpart of ``tools/trace_table.py`` (which reads a JAX trace file's TPU
lanes by fusion). :func:`summarize` reads the profiler's CUDA kernel events
and gives device ms and calls per group (:data:`GROUPS`, one per device
function of this repo, then the library's), the top kernels by name (the
``ops`` rows, with the JAX table's keys), the union of the kernel intervals
(the device's busy time), against the unprofiled wall of one call, the
idle share, and the idle gaps between kernels by the program's span
(``utils.observability.span``) that was innermost when each gap began:
which phase of the step kept the card waiting (a PGD step that is one
CUDA-graph replay: ``apvt.attack.replay``, ``apvt.attack.update`` or the step
between them). The profiler's device-side mirrors of host ranges are not
kernels and are left out. A trace without CUDA events (a CPU run) has no
device numbers: they are None, never a CPU time under a device name.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

from ..utils.observability import SPAN_PREFIX

OUTSIDE = "outside the program's spans"

# device time by kernel group, first match wins (one group per device function
# of this repo, then the library's)
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


def _merged(intervals: list) -> list:
    """(start, end) intervals merged where they touch or overlap, in order."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _union_ms(spans: list) -> float:
    """Length of the union of (start, end) microsecond intervals, in ms."""
    return sum(b - a for a, b in _merged(spans)) / 1e3


def idle_by_span(kernels: list, spans: list) -> list:
    """``[{"span", "idle_ms", "gaps"}]``, most idle first: each gap between
    the merged (start, end) microsecond ``kernels`` goes to the innermost of
    the ``spans`` (name, start, end) open when it begins (the latest opened,
    of two opened together the first to close), or to :data:`OUTSIDE`."""
    merged = _merged(kernels)
    total: dict = {}
    for (_, end), (start, _) in zip(merged, merged[1:]):
        open_ = [s for s in spans if s[1] <= end < s[2]]
        label = max(open_, key=lambda s: (s[1], -s[2]))[0] if open_ else OUTSIDE
        ms, gaps = total.get(label, (0.0, 0))
        total[label] = (ms + (start - end) / 1e3, gaps + 1)
    return [{"span": k, "idle_ms": ms, "gaps": n}
            for k, (ms, n) in sorted(total.items(), key=lambda kv: -kv[1][0])]


def summarize(prof, *, wall_ms: Optional[float] = None, top: int = 25,
              trace: Optional[str] = None) -> dict:
    """The table of one profiled region: ``trace`` (the file the caller
    wrote, or None), ``device_total_ms`` (kernel time), ``ops`` (the ``top``
    kernels by name: ``op``, ``total_ms``, ``count``, ``pct``), ``groups``
    (every group with a kernel: ``group``, ``total_ms``, ``count``, ``pct``),
    ``intervals`` and ``busy_ms`` (the union of the kernel intervals),
    ``wall_ms`` (the caller's unprofiled ms for the region), ``idle_share``
    (1 - busy / wall, None without a wall) and ``idle_by_span``
    (:func:`idle_by_span` over the program's spans, None without kernels)."""
    import torch

    groups = {g: [0.0, 0] for g, _ in GROUPS}
    by_name: dict = {}
    spans, program = [], []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            if ev.name.startswith(SPAN_PREFIX):
                program.append((ev.name, ev.time_range.start, ev.time_range.end))
            continue
        if getattr(ev, "is_user_annotation", False) or ev.name.startswith(SPAN_PREFIX):
            continue  # a host range mirrored onto the device's timeline, not a kernel
        dur = (ev.time_range.end - ev.time_range.start) / 1e3  # ms
        group = next(g for g, pat in GROUPS if re.search(pat, ev.name))
        groups[group][0] += dur
        groups[group][1] += 1
        ms, calls = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + dur, calls + 1)
        spans.append((ev.time_range.start, ev.time_range.end))
    total = sum(ms for ms, _ in groups.values())
    busy = _union_ms(spans) if spans else None

    def pct(ms: float) -> float:
        return 100.0 * ms / total if total else 0.0

    return {
        "trace": trace,
        "device_total_ms": total if spans else None,
        "ops": [{"op": name, "total_ms": ms, "count": calls, "pct": pct(ms)}
                for name, (ms, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]],
        "groups": [{"group": g, "total_ms": ms, "count": calls, "pct": pct(ms)}
                   for g, (ms, calls) in sorted(groups.items(), key=lambda kv: -kv[1][0])
                   if calls],
        "intervals": len(spans),
        "busy_ms": busy,
        "wall_ms": wall_ms,
        "idle_share": (max(0.0, 1.0 - busy / wall_ms)
                       if busy is not None and wall_ms else None),
        "idle_by_span": idle_by_span(spans, program) if spans else None,
    }


def lines(table: dict, head: str, what: str, card: str = "", *, top: int = 0) -> list[str]:
    """The printed form: a summary line, one line per group, one per span
    that the idle gaps went to, and with ``top`` > 0 that many kernels by
    name."""
    if table["busy_ms"] is None:
        return [f"{head} {what} {card}: no device activity in the trace (a CPU run has no "
                f"device time)"]
    wall = (f"unprofiled {table['wall_ms']:.2f} ms/call; " if table["wall_ms"] else "")
    idle = table["idle_share"]
    out = [f"{head} {what} {card}: {wall}one traced call: device busy {table['busy_ms']:.2f} ms "
           f"(union of {table['intervals']} kernel intervals), kernel time "
           f"{table['device_total_ms']:.2f} ms, idle share of the unprofiled wall "
           + (f"{idle:.1%}" if idle is not None else "not measured")]
    out += [f"{head}:   {g['group']:40s} {g['total_ms']:9.2f} ms {g['pct'] / 100:6.1%}  "
            f"{g['count']} calls" for g in table["groups"]]
    out += [f"{head}:   idle in {i['span']:38s} {i['idle_ms']:9.2f} ms  {i['gaps']} gaps"
            for i in table.get("idle_by_span") or ()]
    out += [f"{head}:     top kernel {op['total_ms']:9.2f} ms  {op['op'][:120]}"
            for op in table["ops"][:top]]
    return out


def trace_call(call, out_dir: str, device, *, top: int = 25) -> dict:
    """One warm ``call()`` inside ``utils.observability.profile_trace``
    (its trace file under ``out_dir``), summarized; on the card the
    unprofiled wall is the mean of two more calls by CUDA events."""
    import torch

    from ..utils.observability import profile_trace
    from . import timing

    on_card = torch.device(device).type == "cuda"
    wall_ms = timing.cuda_ms(call, 2) if on_card else None
    os.makedirs(out_dir, exist_ok=True)
    before = set(os.listdir(out_dir))
    with profile_trace(out_dir) as prof:
        call()
    written = sorted(set(os.listdir(out_dir)) - before)
    return summarize(prof, wall_ms=wall_ms, top=top,
                     trace=os.path.join(out_dir, written[-1]) if written else None)


def write(table: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(table, f, indent=2)
