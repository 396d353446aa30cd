"""The port's LayerNorm: ``kernels/layer_norm.py`` and ``ops.nn.layer_norm``'s dispatch.

On the CPU: the plain version is the composition ``ops.nn.layer_norm`` ran
before the kernel, bit for bit, and the JAX package's ``layer_norm`` within
the repo's limits (f32 1e-5; bf16 one bf16 ulp); the instantiation each
width takes; the dispatch rule (with ``_on_card`` faked, so that CPU tensors
stand in for the card's: f32 and empty tensors take the plain version, every
other the kernel, which raises on what it does not take); the grid's
occupancy asked of the card once a kernel, width and device; the
``autograd.Function`` with faked launchers,
the parameters' gradient kernel launched only when autograd asks for it; and
the launch counters through a graphed ``vit_test`` PGD attack (``torch.cuda``'s
graph calls replaced by stand-ins), which read as an eager attack's.

Marked ``card``, skipped without one: the kernel against the composition at
every width the models use and at ragged row counts, forward and ``dx``
within one bf16 ulp at every element (below 2^-8 of the tensor's largest
value, one ulp of that floor) and equal on at least 99% of the elements,
``dgamma`` and ``dbeta`` at rtol 1e-5 of the f32 composition's; a CUDA-graph
capture and replay of forward and backward bit for bit the eager call; and
2 depth + 1 launches a ViT forward. ``python -m pytest --noconftest
tests/test_torch_layer_norm.py`` runs the file where JAX is not installed
(the JAX comparison imports it inside its test).
"""

import contextlib
import dataclasses
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import common
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import whitebox
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import layer_norm as kln
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import nn as tnn

WIDTHS = (128, 256, 512, 768, 1024, 2048)  # every LayerNorm width of ViT-B, Swin-B, ConvNeXt-B
ROWS = (1, 3, 37, 4099)  # ragged: a half-warp row pair cut, CTAs past the last row
COUNTERS = ("FWD_LAUNCHES", "BWD_LAUNCHES", "PARAM_GRAD_LAUNCHES")


def _composition(x, scale, bias, eps):
    """``ops.nn.layer_norm`` as it was before the kernel."""
    out = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return out.to(x.dtype)


def _operands(rows, c, dtype, param_dtype, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, c, generator=g) * 2.0 + 0.5).to(dtype)
    scale = (1.0 + 0.5 * torch.randn(c, generator=g)).to(param_dtype)
    bias = (0.5 * torch.randn(c, generator=g)).to(param_dtype)
    dy = torch.randn(rows, c, generator=g).to(dtype)
    return tuple(t.to(device) for t in (x, scale, bias, dy))


def _counts():
    return [getattr(kln, n) for n in COUNTERS]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_plain_version_is_the_composition_bit_for_bit(dtype):
    x, scale, bias, dy = _operands(37, 96, dtype, torch.float32, seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    got = kln.layer_norm_reference(*leaves, 1e-6)
    want_leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    want = _composition(*want_leaves, 1e-6)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(tnn.layer_norm({"scale": scale, "bias": bias}, x), want)
    for a, b in zip(torch.autograd.grad(got, leaves, dy), torch.autograd.grad(want, want_leaves, dy)):
        assert torch.equal(a, b)


def _bf16_ulps(got, want, floor):
    """|got - want| in bf16 ulps at max(|got|, |want|, floor)."""
    m = torch.maximum(torch.maximum(got.abs(), want.abs()), torch.full_like(got, floor))
    _, e = torch.frexp(m)
    return (got - want).abs() / torch.ldexp(torch.ones_like(m), e - 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_plain_version_matches_the_jax_package(dtype):
    import jax.numpy as jnp

    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import nn as jnn

    x, scale, bias, _ = _operands(64, 768, dtype, torch.float32, seed=2)
    got = tnn.layer_norm({"scale": scale, "bias": bias}, x).float()
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = jnn.layer_norm({"scale": jnp.asarray(scale.numpy()), "bias": jnp.asarray(bias.numpy())},
                          jx, eps=1e-6)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    else:
        assert float(_bf16_ulps(got, want, 2.0 ** -8).max()) <= 1.0


@pytest.mark.parametrize("c,want", [
    (8, "lanes16_vec1"), (64, "lanes16_vec1"), (128, "lanes16_vec1"), (136, "lanes32_vec1"),
    (192, "lanes32_vec1"), (256, "lanes32_vec1"), (512, "lanes32_vec2"), (768, "lanes32_vec3"),
    (1024, "lanes32_vec4"), (2048, "lanes32_vec8")])
def test_the_instantiation_a_width_takes(c, want):
    assert kln.kernel_variant(torch.bfloat16, c) == want


@pytest.mark.parametrize("dtype,c,err", [
    (torch.float32, 768, TypeError), (torch.float16, 768, TypeError),
    (torch.bfloat16, 4, ValueError), (torch.bfloat16, 100, ValueError),
    (torch.bfloat16, 264, ValueError), (torch.bfloat16, 384, ValueError),
    (torch.bfloat16, 1280, ValueError), (torch.bfloat16, 1536, ValueError),
    (torch.bfloat16, 2056, ValueError)])
def test_what_no_instantiation_takes_raises(dtype, c, err):
    with pytest.raises(err):
        kln.kernel_variant(dtype, c)


def _fake_fwd(x, scale, bias, eps):
    xf = x.float()
    mean = xf.mean(-1)
    rstd = torch.rsqrt(xf.var(-1, unbiased=False) + eps)
    return kln.layer_norm_reference(x, scale, bias, eps), mean.reshape(-1), rstd.reshape(-1)


def _fake_bwd(x, dy, mean, rstd, scale, params):
    c = x.shape[-1]
    xh = (x.float().reshape(-1, c) - mean[:, None]) * rstd[:, None]
    d = dy.float().reshape(-1, c)
    g = d * scale.float()
    dx = rstd[:, None] * (g - g.mean(-1, keepdim=True) - xh * (g * xh).mean(-1, keepdim=True))
    dx = dx.to(x.dtype).reshape(x.shape)
    if not params:
        return dx, None, None
    return dx, (d * xh).sum(0).to(scale.dtype), d.sum(0).to(scale.dtype)


@pytest.fixture
def faked(monkeypatch):
    """CPU tensors stand in for the card's, and the launchers compute on the CPU."""
    monkeypatch.setattr(kln, "_on_card", lambda x: True)
    monkeypatch.setattr(kln, "_launch_fwd", _fake_fwd)
    monkeypatch.setattr(kln, "_launch_bwd", _fake_bwd)


def test_a_cpu_tensor_takes_the_plain_version():
    x, scale, bias, _ = _operands(4, 768, torch.bfloat16, torch.bfloat16)
    before = _counts()
    assert not kln.takes(x)
    assert torch.equal(tnn.layer_norm({"scale": scale, "bias": bias}, x),
                       _composition(x, scale, bias, 1e-6))
    assert _counts() == before


@pytest.mark.parametrize("case,route", [
    ("bf16", "kernel"), ("bf16_f32_params", "kernel"), ("bf16_3d", "kernel"), ("f32", "plain"),
    ("f16", TypeError), ("width_100", ValueError), ("width_4096", ValueError),
    ("not_contiguous", "kernel"), ("mixed_params", ValueError), ("misaligned", ValueError),
    ("empty", "plain")])
def test_the_dispatch_rule(case, route, faked, monkeypatch):
    """On the card: f32 and empty tensors take the plain version, every other
    tensor the kernel (a view made contiguous first), which raises on what it
    does not take; nothing falls back to the plain version there."""
    c = {"width_100": 100, "width_4096": 4096}.get(case, 768)
    dtype = {"f32": torch.float32, "f16": torch.float16}.get(case, torch.bfloat16)
    x, scale, bias, _ = _operands(6, c, dtype,
                                  torch.float32 if case == "bf16_f32_params" else torch.bfloat16)
    if case == "bf16_3d":
        x = x.reshape(2, 3, c)
    if case == "not_contiguous":
        x = torch.cat([x, x], dim=-1)[:, :c]
    if case == "mixed_params":
        bias = bias.float()
    if case == "misaligned":
        x = torch.cat([torch.zeros(1, dtype=dtype), x.reshape(-1)])[1:].reshape(6, c)
    if case == "empty":
        x = x[:0]
    seen = []
    plain = F.layer_norm
    monkeypatch.setattr(F, "layer_norm", lambda t, *a: seen.append(t) or plain(t, *a))
    before = _counts()
    if not isinstance(route, str):
        with pytest.raises(route):
            tnn.layer_norm({"scale": scale, "bias": bias}, x)
        assert _counts() == before and not seen
        return
    y = tnn.layer_norm({"scale": scale, "bias": bias}, x)
    launched = [b - a for a, b in zip(before, _counts())]
    assert launched == ([1, 0, 0] if route == "kernel" else [0, 0, 0])
    # one F.layer_norm: the plain version's, or the faked kernel's on a contiguous x
    assert len(seen) == 1 and seen[0].is_contiguous()
    if case == "f32":
        assert seen[0] is x  # F.layer_norm on the tensor itself: no cast
    assert y.dtype == x.dtype and y.shape == x.shape
    assert torch.equal(y, _composition(x, scale, bias, 1e-6))


class _WaveLib:
    """The C library's occupancy query, counted."""

    def __init__(self):
        self.asked = []

    def apvt_layer_norm_wave(self, c, code, kernel):
        self.asked.append((c, code, kernel))
        return 1056


class _BwdLib(_WaveLib):
    """The C library's backward entry, recorded."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def apvt_layer_norm_bwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("params", [False, True])
def test_the_backward_launches_the_parameter_gradients_in_its_own_call(params, monkeypatch):
    lib = _BwdLib()
    monkeypatch.setattr(kln, "_WAVES", {})
    monkeypatch.setattr(kln, "_lib", lambda: lib)
    monkeypatch.setattr(kln, "_stream", lambda x: 7)
    x, scale, _, dy = _operands(37, 768, torch.bfloat16, torch.float32)
    mean, rstd = torch.zeros(37), torch.ones(37)
    dx, dscale, dbias = kln._launch_bwd(x, dy, mean, rstd, scale, params)
    assert len(lib.calls) == 1 and dx.shape == x.shape and dx.dtype == x.dtype
    *ptrs, rows, c, code, grid, stream = lib.calls[0]
    assert (rows, c, code, grid, stream) == (37, 768, 0, 10, 7)  # 10 passes of 4 rows
    assert ptrs[:6] == [t.data_ptr() for t in (x, dy, mean, rstd, scale, dx)]
    if params:
        assert all(ptrs[6:]) and ptrs[7:] == [dscale.data_ptr(), dbias.data_ptr()]
        assert dscale.dtype == dbias.dtype == torch.float32 and dscale.shape == (768,)
    else:
        assert ptrs[6:] == [None, None, None] and dscale is None and dbias is None
    assert lib.asked == [(768, 0, 2 if params else 1)]


def test_the_grid_asks_the_card_once_a_kernel_width_and_device(monkeypatch):
    lib = _WaveLib()
    monkeypatch.setattr(kln, "_WAVES", {})
    x = torch.empty(0, 768, dtype=torch.bfloat16)
    grids = [kln._grid(lib, x, rows, c, 1, kernel)
             for rows, c, kernel in [(12608, 768, "fwd"), (12608, 768, "fwd"), (12608, 768, "bwd"),
                                     (12608, 768, "bwd_params"), (8, 768, "fwd"),
                                     (200704, 128, "fwd"), (200704, 128, "fwd")]]
    # min(the wave, row passes): 4 rows a pass at 32 lanes a row, 8 at 16
    assert grids == [1056, 1056, 1056, 1056, 2, 1056, 1056]
    assert lib.asked == [(768, 1, 0), (768, 1, 1), (768, 1, 2), (128, 1, 0)]


@pytest.mark.parametrize("trainable,param_launches", [
    ((), 0), (("scale",), 1), (("bias",), 1), (("scale", "bias"), 1)])
def test_the_function_asks_parameter_gradients_only_when_autograd_does(
        trainable, param_launches, faked):
    x, scale, bias, dy = _operands(9, 256, torch.bfloat16, torch.float32, seed=3)
    p = {"scale": scale.requires_grad_("scale" in trainable),
         "bias": bias.requires_grad_("bias" in trainable)}
    xr = x.clone().requires_grad_(True)
    before = _counts()
    y = tnn.layer_norm(p, xr)
    inputs = [xr] + [p[n] for n in ("scale", "bias") if n in trainable]
    grads = torch.autograd.grad(y, inputs, dy)
    assert [b - a for a, b in zip(before, _counts())] == [1, 1, param_launches]
    want_leaves = [x.clone().requires_grad_(True)] + [p[n].detach().clone().requires_grad_(True)
                                                      for n in ("scale", "bias")]
    want = _composition(*want_leaves, 1e-6)
    assert torch.equal(y, want)
    wants = dict(zip(("x", "scale", "bias"), torch.autograd.grad(want, want_leaves, dy)))
    for name, got in zip(("x", *trainable), grads):
        assert got.dtype == wants[name].dtype
        torch.testing.assert_close(got.float(), wants[name].float(), atol=2e-2 if name == "x"
                                   else 1e-4, rtol=1e-2 if name == "x" else 1e-4)


def test_the_function_saves_the_input_and_row_statistics(faked):
    x, scale, bias, _ = _operands(5, 128, torch.bfloat16, torch.bfloat16)
    xr = x.clone().requires_grad_(True)
    y = tnn.layer_norm({"scale": scale, "bias": bias}, xr)
    saved = y.grad_fn.saved_tensors
    assert saved[0] is xr or torch.equal(saved[0], xr)
    assert [t.dtype for t in saved] == [torch.bfloat16, torch.bfloat16, torch.float32,
                                        torch.float32]
    assert [tuple(t.shape) for t in saved[2:]] == [(5,), (5,)]


class _Graph:
    def replay(self):
        pass


def test_a_graphed_attack_counts_its_layer_norms_as_an_eager_one(faked, monkeypatch):
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
    monkeypatch.setattr(whitebox, "WARMUP_STEPS", 2)
    cfg = dataclasses.replace(vit.VIT_TEST, compute_dtype="bfloat16")
    model = vit.params_from_jax(vit.init(cfg, torch.Generator().manual_seed(0)), cfg)
    g = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (2, 32, 32, 3), generator=g, dtype=torch.uint8)
    labels = torch.randint(0, 10, (2,), generator=g)
    steps, per_pass = 6, 2 * cfg.depth + 1
    kw = dict(eps=8 / 255, alpha=2 / 255, steps=steps)
    before, captures = _counts(), whitebox.GRAPH_CAPTURES
    whitebox.make_pgd(vit.apply, cfg, **kw)(model, images, labels, torch.Generator().manual_seed(0))
    graphed = [b - a for a, b in zip(before, _counts())]
    assert whitebox.GRAPH_CAPTURES - captures == 1
    before = _counts()
    with common.frozen(model):
        whitebox.pgd(partial(vit.apply, cfg), model, common.to_unit_floats(images), labels,
                     generator=torch.Generator().manual_seed(0), **kw)
    eager = [b - a for a, b in zip(before, _counts())]
    assert graphed == eager == [steps * per_pass, steps * per_pass, 0]


def test_profile_pgd_prints_the_layer_norm_launches_a_batch(monkeypatch):
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import profile_pgd

    before = whitebox.launch_counts()
    for name in ("FWD_LAUNCHES", "BWD_LAUNCHES"):
        monkeypatch.setattr(kln, name, getattr(kln, name) + 750)
    line = profile_pgd.launches_line(before, whitebox.launch_counts())
    for want in ("layer_norm.FWD_LAUNCHES 750", "layer_norm.BWD_LAUNCHES 750",
                 "layer_norm.PARAM_GRAD_LAUNCHES 0", "attention.FWD_LAUNCHES 0",
                 "window_attention.BWD_LAUNCHES 0"):
        assert want in line
    assert "dwconv" not in line  # a counter outside the attention and LayerNorm modules, unmoved


# --- on the card -------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def _within_one_ulp(got, want, what):
    """Every element within one bf16 ulp; at least 99% equal."""
    got, want = got.detach().float(), want.detach().float()
    assert bool(torch.isfinite(got).all()), what
    ulps = _bf16_ulps(got, want, 2.0 ** -8 * float(want.abs().max()))
    equal = float((got == want).float().mean())
    assert float(ulps.max()) <= 1.0 and equal >= 0.99, (what, float(ulps.max()), equal)


@pytest.mark.card
@pytest.mark.parametrize("param_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", WIDTHS)
def test_on_the_card_the_kernel_is_the_composition_within_one_ulp(c, param_dtype, card):
    for rows in ROWS:
        x, scale, bias, dy = _operands(rows, c, torch.bfloat16, param_dtype, seed=rows, device=card)
        assert kln.takes(x)
        before = _counts()
        y, mean, rstd = kln.fused_layer_norm_fwd(x, scale, bias, 1e-6)
        dx, _, _ = kln.fused_layer_norm_bwd(x, dy, mean, rstd, scale, False)
        assert [b - a for a, b in zip(before, _counts())] == [1, 1, 0]
        xr = x.clone().requires_grad_(True)
        want = _composition(xr, scale, bias, 1e-6)
        (want_dx,) = torch.autograd.grad(want, xr, dy)
        torch.cuda.synchronize()
        _within_one_ulp(y, want, f"y ({rows}, {c}) {param_dtype}")
        _within_one_ulp(dx, want_dx, f"dx ({rows}, {c}) {param_dtype}")
        xf = x.float()
        torch.testing.assert_close(mean, xf.mean(-1), atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(rstd, torch.rsqrt(xf.var(-1, unbiased=False) + 1e-6),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.card
@pytest.mark.parametrize("c", WIDTHS)
def test_on_the_card_the_parameter_gradients_are_the_f32_compositions(c, card):
    x, scale, bias, dy = _operands(4099, c, torch.bfloat16, torch.float32, seed=7, device=card)
    leaves = [scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)]
    before = _counts()
    y = kln.fused_layer_norm(x.clone().requires_grad_(True), *leaves, 1e-6)
    got = torch.autograd.grad(y, leaves, dy)
    assert [b - a for a, b in zip(before, _counts())] == [1, 1, 1]
    want_leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    want = torch.autograd.grad(_composition(x, *want_leaves, 1e-6), want_leaves, dy)
    for name, a, b in zip(("dscale", "dbias"), got, want):
        assert a.dtype == torch.float32
        # rtol 1e-5 of each value, and of the largest where a sum of 4,099 f32 terms cancels
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()),
                                   msg=lambda m: f"{name} at C = {c}: {m}")


@pytest.mark.card
@pytest.mark.parametrize("trainable", [False, True])
def test_on_the_card_a_graph_replay_is_the_eager_call_bit_for_bit(trainable, card):
    x, scale, bias, dy = _operands(12608, 768, torch.bfloat16, torch.float32, seed=11, device=card)
    static_x = x.clone()

    def step():  # leaves of its own each call, so that a captured call's autograd nodes are its own
        xr = static_x.detach().requires_grad_(True)
        leaves = [t.detach().requires_grad_(trainable) for t in (scale, bias)]
        y = kln.fused_layer_norm(xr, *leaves, 1e-6)
        inputs = [xr, *leaves] if trainable else [xr]
        return (y, *torch.autograd.grad(y, inputs, dy))

    eager = [t.clone() for t in step()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    static_x.copy_(x)
    graph.replay()
    torch.cuda.synchronize()
    assert len(out) == (4 if trainable else 2)
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


@pytest.mark.card
def test_on_the_card_a_vit_forward_takes_two_layer_norms_a_block_and_the_last(card):
    cfg = dataclasses.replace(vit.VIT_TEST, hidden_dim=128, num_heads=2, mlp_dim=256,
                              compute_dtype="bfloat16")
    m = vit.params_from_jax(vit.init(cfg, torch.Generator().manual_seed(0)), cfg).to(card)
    images = torch.rand(4, 32, 32, 3, device=card)
    before = _counts()
    with torch.no_grad():
        vit.apply(cfg, m, images)
    assert [b - a for a, b in zip(before, _counts())] == [2 * cfg.depth + 1, 0, 0]
