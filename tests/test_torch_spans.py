"""The port's trace spans (``utils.observability.span``) and the trace
table's idle gaps by span (``tools/trace_table``).

With no profiler on, a span opens nothing: ``record_function`` is never
called. With one on (the CPU here), each span is a ``apvt.<name>`` range,
nested in the ranges it was opened in: PGD's start, steps and their three
phases in order, FGSM's forward and backward, and a training step's five
phases once each inside the step. The trace table gives each idle gap
between kernels to the innermost span open when it began, and leaves the
profiler's device-side mirrors of the spans out of the kernels.
"""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import whitebox
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import trace_table
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.train import optim, steps
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import observability as obs

PGD_PHASES = ["apvt.attack.forward", "apvt.attack.backward", "apvt.attack.update"]
TRAIN_PHASES = ["apvt.train.input", "apvt.train.forward", "apvt.train.backward",
                "apvt.train.optimizer", "apvt.train.metrics"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the workers share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def model():
    return vit.params_from_jax(vit.init(vit.VIT_TEST, torch.Generator().manual_seed(0)),
                               vit.VIT_TEST)


@pytest.fixture(scope="module")
def batch():
    g = torch.Generator().manual_seed(1)
    return (torch.randint(0, 256, (2, 32, 32, 3), generator=g, dtype=torch.uint8),
            torch.randint(0, 10, (2,), generator=g))


def _spans(prof) -> list:
    """The program's spans (name, start, end), in the order they opened."""
    return sorted(((ev.name, ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.name.startswith(obs.SPAN_PREFIX)), key=lambda s: (s[1], -s[2]))


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _forbid_record_function(monkeypatch):
    def refused(*a, **k):
        raise AssertionError("record_function opened with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refused)


def test_span_off_opens_no_record_function(monkeypatch, model, batch):
    assert not torch.autograd.profiler._is_profiler_enabled
    _forbid_record_function(monkeypatch)
    with obs.span("outer"), obs.span("inner"):
        pass
    assert obs.span("a") is obs.span("b")  # one shared null context
    images, labels = batch  # a whole attack opens none either
    adv = whitebox.make_pgd(vit.apply, vit.VIT_TEST, eps=8 / 255, alpha=2 / 255, steps=1)(
        model, images, labels, torch.Generator().manual_seed(0))
    assert adv.shape == (2, 32, 32, 3)


def test_span_without_the_profilers_flag_always_opens(monkeypatch):
    monkeypatch.delattr(torch.autograd.profiler, "_is_profiler_enabled")
    assert isinstance(obs.span("x"), torch.profiler.record_function)


def test_spans_nest_under_the_prefix_with_the_profiler_on():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("outer"):
            with obs.span("inner"):
                torch.ones(4).sum()
    (outer, inner) = _spans(prof)
    assert (outer[0], inner[0]) == ("apvt.outer", "apvt.inner")
    assert _inside(inner, outer) and inner != outer
    assert obs.span("x") is obs.span("y")  # closed again once the profiler stops


def test_pgd_spans_a_start_then_each_step_and_its_phases_in_order(model, batch):
    images, labels = batch
    run = whitebox.make_pgd(vit.apply, vit.VIT_TEST, eps=8 / 255, alpha=2 / 255, steps=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(model, images, labels, torch.Generator().manual_seed(0))
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert names == ["apvt.attack.start", *(["apvt.attack.step", *PGD_PHASES] * 2)]
    (start,), steps_ = spans[:1], [s for s in spans if s[0] == "apvt.attack.step"]
    assert start[2] <= steps_[0][1] and steps_[0][2] <= steps_[1][1]
    for step in steps_:
        phases = [s for s in spans if s[0] in PGD_PHASES and _inside(s, step)]
        assert [s[0] for s in phases] == PGD_PHASES
        assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))  # one after another


def test_fgsm_shares_the_forward_and_backward_spans(model, batch):
    images, labels = batch
    run = whitebox.make_fgsm(vit.apply, vit.VIT_TEST, eps=8 / 255)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(model, images, labels)
    assert [s[0] for s in _spans(prof)] == PGD_PHASES[:2]


def test_a_train_step_opens_its_six_spans_once_each(batch):
    model = vit.params_from_jax(vit.init(vit.VIT_TEST, torch.Generator().manual_seed(2)),
                                vit.VIT_TEST)
    state = steps.TrainState.create(model, None, lambda ps: optim.adamw_steplr(ps, 1e-3))
    step = steps.make_train_step(lambda m, x: vit.apply(vit.VIT_TEST, m, x), model)
    images, labels = batch
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, metrics = step(state, images, labels, torch.ones(2))
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["apvt.train.step", *TRAIN_PHASES]
    assert all(_inside(s, spans[0]) for s in spans[1:])
    assert all(a[2] <= b[1] for a, b in zip(spans[1:], spans[2:]))
    assert state.step == 1 and float(metrics["count"]) == 2.0


def _event(name, start, end, cuda=True, mirror=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=(torch.autograd.DeviceType.CUDA if cuda
                                        else torch.autograd.DeviceType.CPU),
                           is_user_annotation=mirror)


def test_trace_table_gives_each_idle_gap_to_the_innermost_span():
    # host: a step over 0-10000 us holding a forward (0-4000) and a backward
    # (4000-9000); device: kernels 0-1000, 2000-3000, 5000-6000, 9500-9800,
    # 11000-11500, and the profiler's mirror of the step over 0-9800
    host = [_event("apvt.attack.step", 0, 10_000, cuda=False),
            _event("apvt.attack.forward", 0, 4_000, cuda=False),
            _event("apvt.attack.backward", 4_000, 9_000, cuda=False),
            _event("aten::mm", 100, 200, cuda=False)]
    kernels = [_event("sm90_xmma_gemm_bf16", 0, 1_000),
               _event("sm90_xmma_gemm_bf16", 2_000, 3_000), _event("apvt_attn_bwd", 5_000, 6_000),
               _event("vectorized_elementwise", 9_500, 9_800),
               _event("vectorized_elementwise", 11_000, 11_500)]
    mirrors = [_event("apvt.attack.step", 0, 9_800, mirror=True),
               _event("apvt.attack.forward", 0, 3_000)]  # a mirror without the flag
    plain = trace_table.summarize(SimpleNamespace(events=lambda: host + kernels), wall_ms=20.0)
    t = trace_table.summarize(SimpleNamespace(events=lambda: host + kernels + mirrors),
                              wall_ms=20.0)
    for key in ("device_total_ms", "groups", "intervals", "busy_ms", "idle_share", "ops"):
        assert t[key] == plain[key], key
    assert t["busy_ms"] == pytest.approx(3.8) and t["intervals"] == 5
    # gaps: 1000-2000 and 3000-5000 in the forward (1 + 2 ms; it opened with the
    # step and closes first), 6000-9500 in the backward, 9800-11000 in the step
    # alone; none after the last kernel
    assert t["idle_by_span"] == [
        {"span": "apvt.attack.backward", "idle_ms": pytest.approx(3.5), "gaps": 1},
        {"span": "apvt.attack.forward", "idle_ms": pytest.approx(3.0), "gaps": 2},
        {"span": "apvt.attack.step", "idle_ms": pytest.approx(1.2), "gaps": 1}]
    text = trace_table.lines(t, "head", "what")
    assert [line.split()[3] for line in text if "idle in" in line] == [
        "apvt.attack.backward", "apvt.attack.forward", "apvt.attack.step"]


def test_trace_table_idle_outside_the_spans_and_without_kernels():
    gaps = trace_table.idle_by_span([(0, 1_000), (3_000, 4_000), (3_500, 5_000), (6_000, 7_000)],
                                    [("apvt.train.step", 4_900, 8_000)])
    assert gaps == [{"span": trace_table.OUTSIDE, "idle_ms": pytest.approx(2.0), "gaps": 1},
                    {"span": "apvt.train.step", "idle_ms": pytest.approx(1.0), "gaps": 1}]
    cpu_only = [_event("apvt.train.step", 0, 10, cuda=False)]
    t = trace_table.summarize(SimpleNamespace(events=lambda: cpu_only))
    assert t["idle_by_span"] is None and t["busy_ms"] is None
