"""PGD's step as one CUDA-graph replay (``attacks.whitebox.StepGraphs``) and
the normalization's constants (``attacks.common.Normalizer``).

On the CPU: which attacks and models take the graph (:func:`graphable`,
FGSM, a one-step PGD, a direct ``pgd`` call), the graphs' key and their
eviction, the launch counters' bookkeeping, the graphed step's spans and
the one side stream of attacks made in turn, with ``torch.cuda``'s graph and stream calls replaced by stand-ins and the
counters bumped by hand; the chain back through the normalization against
the eager step, bit for bit; the normalization's values and its host
constants, made once per dtype.

Marked ``card``, skipped without one: on the card, bf16 PGD-3 at B=8 on a
small ViT and a small Swin, graphed against eager, bit for bit, with the
kernels' launch counters equal, a new capture for a second shape and for a
replaced parameter, and the normalization's values from pinned constants;
ViT-B/16 at 384 px (577 tokens) graphed against eager, bit for bit, every
packed forward on the streamed kernel; three attacks freed in turn leaving
the same device memory. ``python -m pytest --noconftest tests/test_torch_pgd_graph.py``
runs the file where JAX is not installed (this file does not import it).
"""

import contextlib
import dataclasses
import gc
from functools import partial
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import common
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import whitebox
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import attention, window_attention
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import swin, vit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops.nn import LoRADropout
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import trace_table
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import observability as obs

EPS, ALPHA = 8 / 255, 3 / 255


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the workers share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def model():
    return vit.params_from_jax(vit.init(vit.VIT_TEST, torch.Generator().manual_seed(0)),
                               vit.VIT_TEST)


def _batch(n=2, size=32, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 256, (n, size, size, 3), generator=g, dtype=torch.uint8),
            torch.randint(0, 10, (n,), generator=g))


class _Graph:
    """``torch.cuda.CUDAGraph``'s stand-in: a replay runs nothing."""

    replays = 0

    def replay(self):
        _Graph.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda``'s graph, stream and capture calls as CPU stand-ins, so
    the graphed path runs here: a warm-up step runs its body, a capture runs
    it once (the launches it counts are what a graph would hold) and a
    replay runs nothing."""
    stream = SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(whitebox, "graphable", lambda params, device: True)
    monkeypatch.setattr(whitebox, "_SIDE_STREAMS", {})


def _mesh(data, model_axis):
    return SimpleNamespace(shape=(data, model_axis), mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("case,want", [
    ("plain", True), ("cpu", False), ("not_a_module", False), ("mesh_1x1", True),
    ("mesh_data_2", False), ("mesh_model_2", False), ("dropout_training", False),
    ("dropout_eval", True), ("capturing", False)])
def test_which_steps_are_graphable(case, want, monkeypatch):
    m = vit.params_from_jax(vit.init(vit.VIT_TEST, torch.Generator().manual_seed(0)),
                            vit.VIT_TEST)
    m.eval()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: case == "capturing")
    device = torch.device("cpu" if case == "cpu" else "cuda")
    if case.startswith("mesh"):
        m.mesh = {"mesh_1x1": _mesh(1, 1), "mesh_data_2": _mesh(2, 1),
                  "mesh_model_2": _mesh(1, 2)}[case]
    if case.startswith("dropout"):
        m.blocks[0].attn["q"].dropout = LoRADropout(0.1, "input", torch.Generator())
        m.train(case == "dropout_training")
    params = {"w": torch.ones(1)} if case == "not_a_module" else m
    assert whitebox.graphable(params, device) is want


def _has_graphs(run) -> bool:
    """Whether an attack built by make_pgd / make_fgsm carries StepGraphs."""
    cells = {c.cell_contents for c in run.__closure__ or ()}
    return any(isinstance(getattr(c, "graphs", None), whitebox.StepGraphs) for c in cells)


def test_fgsm_a_one_step_pgd_and_a_direct_pgd_call_stay_eager(model, fake_cuda):
    assert _has_graphs(whitebox.make_pgd(vit.apply, vit.VIT_TEST, eps=EPS, alpha=ALPHA, steps=2))
    assert not _has_graphs(whitebox.make_pgd(vit.apply, vit.VIT_TEST, eps=EPS, alpha=ALPHA,
                                             steps=1))
    assert not _has_graphs(whitebox.make_fgsm(vit.apply, vit.VIT_TEST, eps=EPS))
    images, labels = _batch()
    x = common.to_unit_floats(images)
    before = (whitebox.EAGER_STEPS, whitebox.GRAPH_CAPTURES, whitebox.GRAPH_REPLAYS)
    with common.frozen(model):
        whitebox.pgd(partial(vit.apply, vit.VIT_TEST), model, x, labels, eps=EPS, alpha=ALPHA,
                     steps=5)
        whitebox.fgsm(partial(vit.apply, vit.VIT_TEST), model, x, labels, eps=EPS)
    whitebox.make_fgsm(vit.apply, vit.VIT_TEST, eps=EPS)(model, images, labels)
    after = (whitebox.EAGER_STEPS, whitebox.GRAPH_CAPTURES, whitebox.GRAPH_REPLAYS)
    assert [b - a for a, b in zip(before, after)] == [7, 0, 0]


def test_the_cpu_path_stays_eager(model):
    images, labels = _batch()
    before = (whitebox.EAGER_STEPS, whitebox.GRAPH_CAPTURES)
    whitebox.make_pgd(vit.apply, vit.VIT_TEST, eps=EPS, alpha=ALPHA, steps=3)(
        model, images, labels, torch.Generator().manual_seed(0))
    assert (whitebox.EAGER_STEPS - before[0], whitebox.GRAPH_CAPTURES - before[1]) == (3, 0)


@pytest.mark.parametrize("normalize", [common.IMAGENET, common.Normalizer((0.5,) * 3, (0.25,) * 3),
                                       lambda x: x * 2.0 - 1.0], ids=["imagenet", "half", "lambda"])
def test_the_chain_back_through_normalize_is_the_eager_gradient(model, fake_cuda, monkeypatch,
                                                                normalize):
    """Every step a warm-up step: the step on the graph's static input,
    carried back through ``normalize``, against eager PGD, bit for bit."""
    monkeypatch.setattr(whitebox, "WARMUP_STEPS", 10)
    images, labels = _batch(4)
    kw = dict(eps=EPS, alpha=ALPHA, steps=4, normalize=normalize)
    graphed = whitebox.make_pgd(vit.apply, vit.VIT_TEST, **kw)(
        model, images, labels, torch.Generator().manual_seed(3))
    with common.frozen(model):
        eager = whitebox.pgd(partial(vit.apply, vit.VIT_TEST), model,
                             common.to_unit_floats(images), labels,
                             generator=torch.Generator().manual_seed(3), **kw)
    assert torch.equal(graphed, eager)


def _bumping_apply(times: int):
    """``vit.apply`` that counts ``times`` window-attention launches by hand."""
    def apply(cfg, m, x):
        window_attention.FWD_LAUNCHES += times
        return vit.apply(cfg, m, x)

    return apply


def test_captured_launches_are_taken_back_and_each_replay_adds_them(model, fake_cuda,
                                                                    monkeypatch):
    monkeypatch.setattr(whitebox, "WARMUP_STEPS", 2)
    images, labels = _batch()
    run = whitebox.make_pgd(_bumping_apply(3), vit.VIT_TEST, eps=EPS, alpha=ALPHA, steps=7)
    names = ("EAGER_STEPS", "GRAPH_CAPTURES", "GRAPH_REPLAYS")
    before = [getattr(whitebox, n) for n in names] + [window_attention.FWD_LAUNCHES]
    replays = _Graph.replays
    run(model, images, labels, torch.Generator().manual_seed(0))
    after = [getattr(whitebox, n) for n in names] + [window_attention.FWD_LAUNCHES]
    # 2 warm-up steps (6 launches), a capture (3 counted, 3 taken back), 5 replays (+3 each)
    assert [b - a for a, b in zip(before, after)] == [2, 1, 5, 21]
    assert _Graph.replays - replays == 5
    run(model, images, labels, torch.Generator().manual_seed(1))  # the same key: replays only
    again = [getattr(whitebox, n) for n in names] + [window_attention.FWD_LAUNCHES]
    assert [b - a for a, b in zip(after, again)] == [0, 0, 7, 21]
    assert {k: v for k, v in whitebox.launch_counts().items() if k[0] is window_attention} == {
        (window_attention, n): getattr(window_attention, n)
        for n in ("FWD_LAUNCHES", "BWD_LAUNCHES", "DBIAS_CALLS")}


def _grad_once(graphs, params, xn, labels):
    return graphs.grad(partial(vit.apply, vit.VIT_TEST), params, whitebox.weights_key(params),
                       xn, labels)


def test_graphs_are_keyed_by_shape_and_weights_and_the_least_recent_of_two_goes(
        model, fake_cuda, monkeypatch):
    monkeypatch.setattr(whitebox, "WARMUP_STEPS", 0)
    graphs = whitebox.StepGraphs()
    a, b, c = (torch.rand(n, 32, 32, 3) for n in (2, 3, 4))
    label = {n: torch.zeros(n, dtype=torch.long) for n in (2, 3, 4)}
    captures = whitebox.GRAPH_CAPTURES
    with common.frozen(model):
        for x in (a, b, a, a, c, b):  # c drops b (a was used later); b comes back
            _grad_once(graphs, model, x, label[x.shape[0]])
        assert whitebox.GRAPH_CAPTURES - captures == 4
        assert [k[0][0] for k in graphs.graphs] == [4, 3]
        assert len(graphs.graphs) == whitebox.MAX_GRAPHS
        _grad_once(graphs, model, a, label[2].to(torch.int32))  # another label dtype
        assert whitebox.GRAPH_CAPTURES - captures == 5
        w = model.head.w  # a replaced parameter: another key
        model.head.w = torch.nn.Parameter(w.detach().clone(), requires_grad=False)
        try:
            _grad_once(graphs, model, a, label[2].to(torch.int32))
            assert whitebox.GRAPH_CAPTURES - captures == 6
            _grad_once(graphs, model, a, label[2].to(torch.int32))
            assert whitebox.GRAPH_CAPTURES - captures == 6
        finally:
            model.head.w = w


def test_a_new_model_under_a_reused_key_is_captured_anew(model, fake_cuda, monkeypatch):
    monkeypatch.setattr(whitebox, "WARMUP_STEPS", 0)
    graphs = whitebox.StepGraphs()
    x, labels = torch.rand(2, 32, 32, 3), torch.zeros(2, dtype=torch.long)
    captures = whitebox.GRAPH_CAPTURES
    with common.frozen(model):
        _grad_once(graphs, model, x, labels)
    other = vit.params_from_jax(vit.init(vit.VIT_TEST, torch.Generator().manual_seed(5)),
                                vit.VIT_TEST)
    key = whitebox.weights_key(model)
    # the same key (as a freed module's id and addresses could be reused), another module
    graphs.grad(partial(vit.apply, vit.VIT_TEST), other, key, x, labels)
    assert whitebox.GRAPH_CAPTURES - captures == 2 and len(graphs.graphs) == 1


def test_attacks_made_in_turn_warm_up_on_one_side_stream(model, fake_cuda, monkeypatch):
    """Every graph's warm-up steps on a device run on its one side stream:
    cuBLAS keeps a workspace for each stream it has run on until the process
    ends, so a stream made for each attack would outlive the attack."""
    made = []

    def stream(device=None):
        made.append(SimpleNamespace(wait_stream=lambda other: None))
        return made[-1]

    monkeypatch.setattr(torch.cuda, "Stream", stream)
    images, labels = _batch()
    for k in range(3):
        whitebox.make_pgd(vit.apply, vit.VIT_TEST, eps=EPS, alpha=ALPHA, steps=2)(
            model, images, labels, torch.Generator().manual_seed(k))
    assert len(made) == 1 and whitebox.side_stream(images.device) is made[0]


def _spans(prof) -> list:
    return sorted(((ev.name, ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.name.startswith(obs.SPAN_PREFIX)), key=lambda s: (s[1], -s[2]))


def test_a_graphed_step_opens_step_replay_then_update(model, fake_cuda, monkeypatch):
    monkeypatch.setattr(whitebox, "WARMUP_STEPS", 1)
    images, labels = _batch()
    run = whitebox.make_pgd(vit.apply, vit.VIT_TEST, eps=EPS, alpha=ALPHA, steps=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(model, images, labels, torch.Generator().manual_seed(0))
    spans = _spans(prof)
    phases = ["apvt.attack.replay", "apvt.attack.update"]
    assert [s[0] for s in spans] == ["apvt.attack.start", *(["apvt.attack.step", *phases] * 3)]
    for step in (s for s in spans if s[0] == "apvt.attack.step"):
        inner = [s for s in spans if s[0] in phases and step[1] <= s[1] and s[2] <= step[2]]
        assert [s[0] for s in inner] == phases and inner[0][2] <= inner[1][1]


def test_the_trace_table_gives_a_graphed_steps_idle_to_replay_update_and_step():
    # a step over 0-10000 us: its replay (0-6000), then its update (7000-9000)
    spans = [("apvt.attack.step", 0, 10_000), ("apvt.attack.replay", 0, 6_000),
             ("apvt.attack.update", 7_000, 9_000)]
    kernels = [(0, 4_000), (5_000, 6_500), (8_000, 8_500), (9_500, 9_800)]
    assert trace_table.idle_by_span(kernels, spans) == [
        {"span": "apvt.attack.step", "idle_ms": pytest.approx(1.5), "gaps": 1},
        {"span": "apvt.attack.replay", "idle_ms": pytest.approx(1.0), "gaps": 1},
        {"span": "apvt.attack.update", "idle_ms": pytest.approx(1.0), "gaps": 1}]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_normalizer_values_and_constants_made_once_per_dtype(dtype):
    n = common.Normalizer((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    x = torch.rand(2, 4, 4, 3).to(dtype)
    want = ((x - torch.tensor(n.mean, dtype=dtype)) / torch.tensor(n.std, dtype=dtype))
    assert torch.equal(n(x), want) and n(x).dtype == dtype
    first = common._constants(n.mean, n.std, dtype, False)
    misses = common._constants.cache_info().misses
    common.Normalizer(list(n.mean), list(n.std))(x)  # equal values, another instance
    assert common._constants(n.mean, n.std, dtype, False) is first
    assert common._constants.cache_info().misses == misses
    assert first[0].dtype == dtype and first[0].device.type == "cpu"


# --- on the card -------------------------------------------------------------------

def _card_models(card):
    vcfg = dataclasses.replace(vit.VIT_TEST, hidden_dim=128, num_heads=2, mlp_dim=256,
                               compute_dtype="bfloat16")
    scfg = dataclasses.replace(swin.SWIN_TEST, embed_dim=64, compute_dtype="bfloat16")
    out = []
    for mod, cfg in ((vit, vcfg), (swin, scfg)):
        m = mod.params_from_jax(mod.init(cfg, torch.Generator().manual_seed(0)), cfg)
        for p in m.parameters():  # bf16 weights, as the cells hold them; buffers stay f32
            p.data = p.data.to(torch.bfloat16)
        out.append((mod, cfg, m.to(card)))
    return out


def _counted(fn):
    before = whitebox.launch_counts()
    out = fn()
    return out, {k: v - before[k] for k, v in whitebox.launch_counts().items() if v != before[k]}


@pytest.mark.card
@pytest.mark.parametrize("family", ["vit", "swin"])
def test_on_the_card_graphed_pgd_is_eager_pgd_bit_for_bit(family, card):
    mod, cfg, m = _card_models(card)[0 if family == "vit" else 1]
    kw = dict(eps=EPS, alpha=ALPHA, steps=3)
    batches = [tuple(t.to(card) for t in _batch(8, cfg.image_size, seed)) for seed in (1, 2, 3)]
    run = whitebox.make_pgd(mod.apply, cfg, **kw)
    captures, replays = whitebox.GRAPH_CAPTURES, whitebox.GRAPH_REPLAYS
    for k, (images, labels) in enumerate(batches):  # warm-up steps, then capture and replays
        graphed, got = _counted(lambda: run(m, images, labels, torch.Generator(card).manual_seed(k)))
        with common.frozen(m):
            eager, want = _counted(lambda: whitebox.pgd(
                partial(mod.apply, cfg), m, common.to_unit_floats(images), labels,
                generator=torch.Generator(card).manual_seed(k), **kw))
        diff = float((graphed - eager).abs().max())
        assert torch.equal(graphed, eager), f"batch {k}: largest difference {diff}"
        assert got == want and got, (got, want)
    assert whitebox.GRAPH_CAPTURES - captures == 1
    assert whitebox.GRAPH_REPLAYS - replays == 3 * 3 - whitebox.WARMUP_STEPS


@pytest.mark.card
def test_on_the_card_graphed_pgd_at_577_tokens_streams_every_forward_bit_for_bit(card):
    """ViT-B/16 at 384 px (``google_vit_384``'s config, bf16 weights), three
    PGD-2 batches at B=8: the eager warm-up steps, the capture and the
    replays equal eager PGD bit for bit with equal launch counters, 12
    packed forwards a step, each at N = 577 on the streamed kernel."""
    cfg = vit.VIT_B16_384.with_classes(21)
    assert attention.kernel_variant(torch.bfloat16, cfg.seq_len, cfg.head_dim, "fwd") == "wgmma_stream"
    m = vit.params_from_jax(vit.init(cfg, torch.Generator().manual_seed(0)), cfg)
    for p in m.parameters():
        p.data = p.data.to(torch.bfloat16)
    m = m.to(card)
    kw = dict(eps=EPS, alpha=ALPHA, steps=2)
    run = whitebox.make_pgd(vit.apply, cfg, **kw)
    captures, replays = whitebox.GRAPH_CAPTURES, whitebox.GRAPH_REPLAYS
    for k in range(3):
        images, labels = (t.to(card) for t in _batch(8, cfg.image_size, k + 1))
        graphed, got = _counted(lambda: run(m, images, labels, torch.Generator(card).manual_seed(k)))
        with common.frozen(m):
            eager, want = _counted(lambda: whitebox.pgd(
                partial(vit.apply, cfg), m, common.to_unit_floats(images), labels,
                generator=torch.Generator(card).manual_seed(k), **kw))
        diff = float((graphed - eager).abs().max())
        assert torch.equal(graphed, eager), f"batch {k}: largest difference {diff}"
        assert got == want, (got, want)
        assert got[(attention, "FWD_LAUNCHES")] == 12 * kw["steps"], got
    assert whitebox.GRAPH_CAPTURES - captures == 1
    assert whitebox.GRAPH_REPLAYS - replays == 3 * 2 - whitebox.WARMUP_STEPS


@pytest.mark.card
def test_on_the_card_a_freed_attack_leaves_no_device_memory_behind(card):
    """Three graphed attacks made, run and freed in turn: the device memory
    left after each is the same (a side stream made for each attack left its
    cuBLAS workspaces behind, 64 MiB an attack on the H100)."""
    mod, cfg, m = _card_models(card)[0]
    images, labels = (t.to(card) for t in _batch(8, cfg.image_size, 1))
    left = []
    for k in range(3):
        run = whitebox.make_pgd(mod.apply, cfg, eps=EPS, alpha=ALPHA,
                                steps=whitebox.WARMUP_STEPS + 2)
        run(m, images, labels, torch.Generator(card).manual_seed(k))
        del run
        gc.collect()
        torch.cuda.synchronize(card)
        torch.cuda.empty_cache()
        left.append(torch.cuda.memory_allocated(card))
    assert left[0] == left[1] == left[2], left


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_on_the_card_normalize_copies_pinned_constants_to_the_same_values(card, dtype):
    n = common.IMAGENET
    x = torch.rand(2, 4, 4, 3, device=card).to(dtype)
    want = ((x - torch.tensor(n.mean, dtype=dtype, device=card))
            / torch.tensor(n.std, dtype=dtype, device=card))
    assert torch.equal(n(x), want)
    assert all(t.is_pinned() for t in common._constants(n.mean, n.std, dtype, True))


@pytest.mark.card
def test_on_the_card_a_second_shape_and_a_replaced_parameter_are_captured_anew(card):
    mod, cfg, m = _card_models(card)[0]
    run = whitebox.make_pgd(mod.apply, cfg, eps=EPS, alpha=ALPHA, steps=whitebox.WARMUP_STEPS + 2)
    full, tail = (tuple(t.to(card) for t in _batch(n, cfg.image_size)) for n in (8, 5))
    captures = whitebox.GRAPH_CAPTURES
    for images, labels in (full, tail, full, tail):
        run(m, images, labels, torch.Generator(card).manual_seed(0))
    assert whitebox.GRAPH_CAPTURES - captures == 2
    with torch.no_grad():
        m.head.w = torch.nn.Parameter(m.head.w * 2, requires_grad=False)
    adv = run(m, *full, torch.Generator(card).manual_seed(0))
    assert whitebox.GRAPH_CAPTURES - captures == 3
    with common.frozen(m):
        want = whitebox.pgd(partial(mod.apply, cfg), m, common.to_unit_floats(full[0]), full[1],
                            eps=EPS, alpha=ALPHA, steps=whitebox.WARMUP_STEPS + 2,
                            generator=torch.Generator(card).manual_seed(0))
    assert torch.equal(adv, want)

