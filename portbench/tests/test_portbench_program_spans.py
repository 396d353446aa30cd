"""The program's own spans (``apvt.*`` ranges that the port opens while a
profiler records) leave the harness's reduction as it was.

A stand-in profiler hands ``trace.profile`` a synthetic event list: the
harness's ranges, device operations, and interleaved with them the
program's host spans and the profiler's device-side mirrors of every range
(flagged as user annotations, as the CUDA build of torch flags them). The
trace reduced from it, and every reader of the cells that read a trace,
give exactly what they give with the program's spans taken out.
"""

from types import SimpleNamespace

import pytest
import torch

from portbench.core import bench, spec
from portbench.core import trace as tracing

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _ev(name, start, end, device=CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def _events(harness_span: str, kernels: list, program: bool) -> list:
    """One unit of 0-10000 us: the harness's range and its mirror, the
    device's kernels, and with ``program`` the program's step, its three
    phases, and their mirrors."""
    out = [_ev(harness_span, 0, 10_000), _ev(harness_span, 0, 9_900, CUDA, annotation=True)]
    out += [_ev(name, a, b, CUDA) for name, a, b in kernels]
    if program:
        for name, a, b in (("apvt.attack.step", 50, 9_950), ("apvt.attack.forward", 60, 3_900),
                           ("apvt.attack.backward", 3_900, 8_800),
                           ("apvt.attack.update", 8_800, 9_900)):
            out.insert(1, _ev(name, a, b))
            out.append(_ev(name, a + 20, b - 20, CUDA, annotation=True))
    return out


KERNELS = {
    "vit_b16_224.pgd30_b64": ("attack_call", [
        ("sm90_xmma_gemm_bf16", 100, 1_000), ("apvt_attn_fwd_wgmma", 1_200, 1_500),
        ("layer_norm_kernel", 1_500, 2_500), ("apvt_attn_bwd", 4_000, 5_000),
        ("wgs::stream_stats", 5_000, 5_200), ("clamp_kernel", 9_000, 9_100)],
        {"attention.FWD_LAUNCHES": 1, "attention.BWD_LAUNCHES": 1}),
    "swin_b_224.pgd30_b64": ("attack_call", [
        ("win_fwd", 100, 900), ("sm90_xmma_gemm_bf16", 900, 2_000),
        ("win_bwd", 4_000, 6_000), ("copy_kernel", 7_000, 7_500)],
        {"window_attention.FWD_LAUNCHES": 24, "window_attention.BWD_LAUNCHES": 24}),
    "vit_b16_224.full_train_b64": ("train_step", [
        ("sm90_xmma_gemm_bf16", 100, 3_000), ("multi_tensor_apply_kernel", 8_000, 9_000)],
        {}),
}


class _Profiler:
    """``torch.profiler.profile`` as ``trace.profile`` uses it, over a list."""

    events_ = []

    def __init__(self, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return self.events_


class _Driver:
    def __init__(self, counters):
        self.n, self.k = counters, 0

    def counters(self):
        return {k: v * self.k for k, v in self.n.items()}

    def drain(self):
        pass

    def unit(self):
        self.k += 1
        return 64


def _traced(monkeypatch, cell: str, program: bool) -> tracing.Trace:
    span, kernels, counters = KERNELS[cell]
    monkeypatch.setattr(_Profiler, "events_", _events(span, kernels, program))
    monkeypatch.setattr(torch.profiler, "profile", _Profiler)
    return tracing.profile(_Driver(counters), 1)


@pytest.mark.parametrize("cell", sorted(KERNELS))
def test_the_programs_spans_move_no_reading(cell, monkeypatch):
    plain, spanned = _traced(monkeypatch, cell, False), _traced(monkeypatch, cell, True)
    assert spanned.ops == plain.ops and spanned.spans == plain.spans
    assert not any(name.startswith("apvt.") for name, _, _ in spanned.ops + spanned.spans)
    assert spanned.busy_s == plain.busy_s and spanned.groups() == plain.groups()
    assert spanned.idle_by_span() == plain.idle_by_span()
    assert spanned.breakdown() == plain.breakdown()
    c = spec.cell(cell)
    readers = [m["name"] for m in c.per_layer if m["source"] == "device_trace"]
    assert len(readers) == (3 if "pgd30" in cell else 1)  # idle and the two rooflines
    for name in readers:
        got = [c.reader(name).read(bench.Readings(c, setup_s=1.0, window_s=0.02, units=2,
                                                  images=128, trace=t))
               for t in (plain, spanned)]
        assert got[0] is not None and got[0] == got[1], name
