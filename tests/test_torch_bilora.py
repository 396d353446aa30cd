"""The port's BiLoRA (``ops/bilora.py``) against the JAX package's.

The spectrum positions are drawn exactly as the JAX package draws them (its
uint32 task seed wraps from task 2 on). ``delta``, ``apply_delta``,
``merge_many`` and the coefficients' gradients through a ``VIT_TEST`` loss
agree within rtol 1e-5 (f32 FFTs of two libraries). The gradient reaches
the coefficients through ``torch.func.functional_call`` with
``module_params``, since a module built from a tree would cut the graph.
Then mirrors of the JAX package's ``tests/test_bilora_sequential.py``.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry as treg
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit as tvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import bilora as tb
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees as ttrees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import vit as jvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import bilora as jb
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

RTOL = 1e-5
TARGETS = ("blocks/attn/q", "blocks/attn/v")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (pytest-xdist workers share
    the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _close(got, want, rtol=RTOL):
    """|got - want| <= rtol x max|want|, elementwise."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rtol * float(np.abs(want).max())


def _coeffs(seed, lead, n, scale=0.1):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((*lead, n)) * scale).astype(np.float32) for k in ("re", "im")}


def _both(adapter):
    """numpy adapter -> (JAX adapter, port adapter of leaf tensors that ask a gradient)."""
    return ({p: {k: jnp.asarray(v) for k, v in f.items()} for p, f in adapter.items()},
            {p: {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in f.items()}
             for p, f in adapter.items()})


@pytest.fixture(scope="module")
def vit_params():
    params = jvit.init(jax.random.key(0), jvit.VIT_TEST)
    flat = {p: torch.from_numpy(np.array(v)) for p, v in jtrees.flatten_with_paths(params).items()}
    return params, ttrees.unflatten_from_paths(flat)


@pytest.mark.parametrize("task_id", [0, 1, 2, 5, 2 ** 31])
def test_positions_equal_jax(task_id):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the JAX seed's uint32 wrap
        want = jb._positions(task_id, 100, 64, 48)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the port computes the wrap without a warning
        got = tb._positions(task_id, 100, 64, 48)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len({(int(r), int(c)) for r, c in got}) == 100


def test_config_defaults_and_init_equal_jax(vit_params):
    params, tparams = vit_params
    assert tb.BiLoRAConfig() == tb.BiLoRAConfig(n_frq=100, alpha=1.0, targets=(), task_id=0)
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(tb.BiLoRAConfig) == fields(jb.BiLoRAConfig)
    jcfg, tcfg = jb.BiLoRAConfig(n_frq=16, targets=TARGETS), tb.BiLoRAConfig(n_frq=16,
                                                                               targets=TARGETS)
    jad, tad = jb.init(params, jcfg), tb.init(tparams, tcfg)
    for p in TARGETS:
        for k in ("re", "im"):
            assert tuple(tad[p][k].shape) == jad[p][k].shape == (2, 16)
            assert not bool(tad[p][k].any())
    assert tb.num_params(tad) == jb.num_params(jad) == 2 * 2 * 2 * 16


def test_delta_and_its_gradients_equal_jax():
    pos = tb._positions(3, 100, 64, 48)
    fac = _coeffs(0, (2,), 100, scale=1.0)
    cot = np.random.default_rng(1).standard_normal((2, 64, 48)).astype(np.float32)

    def jloss(re, im):
        return jnp.sum(jb.delta({"re": re, "im": im}, pos, (2, 64, 48), 1.5) * cot)

    want = jb.delta({k: jnp.asarray(v) for k, v in fac.items()}, pos, (2, 64, 48), 1.5)
    gre, gim = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(fac["re"]), jnp.asarray(fac["im"]))
    tfac = {k: torch.from_numpy(v).requires_grad_() for k, v in fac.items()}
    got = tb.delta(tfac, pos, (2, 64, 48), 1.5)
    _close(got, want)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(tfac["re"].grad, gre)
    _close(tfac["im"].grad, gim)


def test_delta_spectrum_support():
    """A scattered spectrum comes back from fft2 of the delta at its
    positions (and their conjugate mirrors, which Re() folds in)."""
    fac = {"re": torch.tensor([1.0, 0.5]), "im": torch.tensor([0.0, -0.25])}
    d = tb.delta(fac, np.asarray([[0, 0], [2, 3]], np.int32), (8, 8), alpha=1.0)
    spec = np.fft.fft2(d.numpy())
    mask = np.zeros((8, 8), bool)
    mask[0, 0] = mask[2, 3] = mask[6, 5] = True
    assert np.abs(spec)[~mask].max() < 1e-3


def test_apply_delta_and_merge_many_equal_jax(vit_params):
    params, tparams = vit_params
    cfgs = [(jb.BiLoRAConfig(n_frq=16, targets=TARGETS, task_id=t),
             tb.BiLoRAConfig(n_frq=16, targets=TARGETS, task_id=t)) for t in (0, 2)]
    pairs = [_both({p: _coeffs(10 * t + i, (2,), 16) for i, p in enumerate(TARGETS)})
             for t in (0, 2)]
    one_j = jb.apply_delta(params, pairs[0][0], cfgs[0][0])
    one_t = tb.apply_delta(tparams, pairs[0][1], cfgs[0][1])
    both_j = jb.merge_many(params, [p[0] for p in pairs], [c[0] for c in cfgs])
    both_t = tb.merge_many(tparams, [p[1] for p in pairs], [c[1] for c in cfgs])
    for want, got in ((one_j, one_t), (both_j, both_t)):
        jf, tf = jtrees.flatten_with_paths(want), ttrees.flatten_with_paths(got)
        assert set(jf) == set(tf)
        for p in jf:
            _close(tf[p], jf[p])
    # the base is not modified, and the composition moved the targets
    assert torch.equal(tparams["blocks"]["attn"]["q"]["w"],
                       torch.from_numpy(np.array(params["blocks"]["attn"]["q"]["w"])))
    assert float((both_t["blocks"]["attn"]["v"]["w"] - one_t["blocks"]["attn"]["v"]["w"])
                 .detach().abs().max()) > 0


def test_coefficient_gradients_through_vit_equal_jax(vit_params):
    params, tparams = vit_params
    jcfg = jb.BiLoRAConfig(n_frq=16, targets=TARGETS, task_id=2)
    tcfg = tb.BiLoRAConfig(n_frq=16, targets=TARGETS, task_id=2)
    jad, tad = _both({p: _coeffs(i, (2,), 16) for i, p in enumerate(TARGETS)})
    rng = np.random.default_rng(3)
    x = rng.random((4, 32, 32, 3), dtype=np.float32)
    y = np.array([0, 1, 2, 3])

    def jloss(ad):
        logits = jvit.apply(jvit.VIT_TEST, jb.apply_delta(params, ad, jcfg), jnp.asarray(x))
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(4), y])

    jl, jg = jax.value_and_grad(jloss)(jad)
    model = tvit.params_from_jax(tparams, tvit.VIT_TEST)
    model.requires_grad_(False)
    logits = torch.func.functional_call(model, tb.module_params(model, tad, tcfg),
                                        (torch.from_numpy(x),))
    loss = F.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    _close(loss, jl)
    for p in TARGETS:
        for k in ("re", "im"):
            assert float(tad[p][k].grad.abs().max()) > 0
            _close(tad[p][k].grad, jg[p][k])


def test_module_params_follow_a_two_axis_stack():
    """Swin stacks its blocks as (pairs, 2); ``module_params`` feeds the same
    weights as ``apply_delta`` on the tree."""
    entry = treg.get_model("swin_test")
    cfg = entry.config(3)
    tree = entry.init(cfg, torch.Generator().manual_seed(0))
    targets = ("stages/0/blocks/attn/qkv", "stages/1/blocks/mlp/fc1")
    bcfg = tb.BiLoRAConfig(n_frq=8, targets=targets, task_id=1)
    ad = {p: {k: torch.randn(f[k].shape, generator=torch.Generator().manual_seed(i)) * 0.05
              for k in ("re", "im")} for i, (p, f) in enumerate(tb.init(tree, bcfg).items())}
    assert ad[targets[0]]["re"].shape[:2] == (1, 2)
    x = torch.rand(2, cfg.image_size, cfg.image_size, 3, generator=torch.Generator().manual_seed(3))
    model = entry.from_tree(tree, cfg)
    with torch.no_grad():
        got = torch.func.functional_call(model, tb.module_params(model, ad, bcfg), (x,))
        want = entry.apply(cfg, entry.from_tree(tb.apply_delta(tree, ad, bcfg), cfg), x)
    assert torch.equal(got, want)


def test_zero_init_is_identity(vit_params):
    _, tparams = vit_params
    cfg = tb.BiLoRAConfig(n_frq=16, targets=("blocks/attn/q",))
    merged = tb.apply_delta(tparams, tb.init(tparams, cfg), cfg)
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = tvit.params_from_jax(tparams, tvit.VIT_TEST)(x)
        b = tvit.params_from_jax(merged, tvit.VIT_TEST)(x)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_bilora_trains_and_composes():
    """Coefficients train through functional_call; two tasks' deltas sum."""
    entry = treg.get_model("vit_test")
    cfg = entry.config(3)
    tree = entry.init(cfg, torch.Generator().manual_seed(0))
    bcfg1 = tb.BiLoRAConfig(n_frq=8, alpha=1.0, targets=("blocks/attn/q",), task_id=0)
    ad = {p: {k: v.requires_grad_() for k, v in f.items()} for p, f in tb.init(tree, bcfg1).items()}
    model = entry.from_tree(ttrees.map_leaves(lambda t: t.clone(), tree), cfg)
    model.requires_grad_(False)
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([0, 1, 2, 0])

    def loss():
        return F.cross_entropy(torch.func.functional_call(
            model, tb.module_params(model, ad, bcfg1), (x,)), y)

    l0 = loss()
    l0.backward()
    assert sum(float(t.grad.abs().sum()) for f in ad.values() for t in f.values()) > 0
    opt = torch.optim.Adam([t for f in ad.values() for t in f.values()], lr=1e-2)
    for _ in range(10):
        opt.zero_grad()
        loss().backward()
        opt.step()
    assert float(loss().detach()) < float(l0.detach())

    bcfg2 = tb.BiLoRAConfig(n_frq=8, alpha=1.0, targets=("blocks/attn/q",), task_id=1)
    ad2 = {p: {k: v + 0.05 for k, v in f.items()} for p, f in tb.init(tree, bcfg2).items()}
    detached = {p: {k: v.detach() for k, v in f.items()} for p, f in ad.items()}
    both = tb.merge_many(tree, [detached, ad2], [bcfg1, bcfg2])
    one = tb.apply_delta(tree, detached, bcfg1)
    w_base, w_one = tree["blocks"]["attn"]["q"]["w"], one["blocks"]["attn"]["q"]["w"]
    w_both = both["blocks"]["attn"]["q"]["w"]
    assert float((w_both - w_base).abs().max()) > 0
    # summed deltas: task 2's delta is what the composition adds to task 1's merge
    d2 = tb.apply_delta(tree, ad2, bcfg2)["blocks"]["attn"]["q"]["w"] - w_base
    torch.testing.assert_close(w_both - w_one, d2, atol=1e-6, rtol=0)
