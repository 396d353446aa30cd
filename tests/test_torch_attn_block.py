"""The port's attention half-block (``kernels/attn_block.py``: plain versions,
the CPU route of its ``autograd.Function``, the parameter gradients) against
the JAX package's ``kernels/attn_block.py``.

The same numpy inputs (B=2, N=17, C=64, 2 heads: the ``vit_test`` block) go
through the port, the JAX XLA composition ``attn_block_reference`` and the
Pallas kernel ``fused_attn_block`` in interpret mode. Limits are those of the
JAX kernel's own tests: f32 forward 2e-5 / 1e-4 and all eleven gradients
1e-4 / 1e-3; bf16 forward 3e-2 and dx 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import attn_block as tb
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models.vit import _as_tensor
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.kernels import attn_block as jb

B, N, C, H, EPS = 2, 17, 64, 2, 1e-6
NAMES = ("x", "ln_scale", "ln_bias", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")


def _args(seed=21):
    """x, LN rows, and weights with q/k scaled up so that the softmax is far
    from uniform (at 1/sqrt(C) every probability is about 1/N)."""
    rng = np.random.default_rng(seed)
    r = lambda shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    out = [r((B, N, C)), 1.0 + 0.3 * r((C,)), 0.3 * r((C,))]
    for t in "qkvo":
        out += [r((C, C), (0.4 if t in "qk" else 0.125)), r((C,), 0.3)]
    return tuple(out)


def _jax_fn(which):
    return jb.attn_block_reference if which == "ref" else jb.fused_attn_block


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("which", ["ref", "pallas"])
def test_forward_and_all_grads_match_jax_f32(which):
    args = _args()
    fn = _jax_fn(which)
    g = np.random.default_rng(5).standard_normal(args[0].shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda *a: fn(*a, H, EPS), *map(jnp.asarray, args))
        want_grads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    before = tb.PARAM_GRAD_CALLS
    got = tb.attn_block(*targs, H, EPS)
    grads = torch.autograd.grad(got, targs, torch.from_numpy(g))
    assert tb.PARAM_GRAD_CALLS == before + 1
    np.testing.assert_allclose(got.detach().numpy(), _f32(want), atol=2e-5, rtol=1e-4)
    for name, gt, gw in zip(NAMES, grads, want_grads):
        assert gt.shape == gw.shape, name
        np.testing.assert_allclose(gt.numpy(), _f32(gw), atol=1e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("which", ["pallas"])
def test_forward_and_dx_match_jax_bf16(which):
    """Against the Pallas kernel only: the JAX library composition rounds its
    stored scores to bf16 before the softmax, which these peaked scores show."""
    args = _args()
    fn = _jax_fn(which)
    xj = jnp.asarray(args[0], jnp.bfloat16)
    rest = tuple(jnp.asarray(a) for a in args[1:])
    gj = jnp.asarray(np.random.default_rng(6).standard_normal(args[0].shape), jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda a: fn(a, *rest, H, EPS), xj)
        (want_dx,) = vjp(gj)
    xt = _as_tensor(np.asarray(xj)).requires_grad_(True)
    trest = [torch.from_numpy(a) for a in args[1:]]
    before = tb.PARAM_GRAD_CALLS
    got = tb.attn_block(xt, *trest, H, EPS)
    (dx,) = torch.autograd.grad(got, xt, _as_tensor(np.asarray(gj)))
    assert got.dtype == dx.dtype == torch.bfloat16 and got.shape == xt.shape
    assert tb.PARAM_GRAD_CALLS == before  # the input gradient alone recomputes no parameter gradient
    np.testing.assert_allclose(got.detach().float().numpy(), _f32(want), atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(dx.float().numpy(), _f32(want_dx), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plain_version_is_the_forward_plain_versions_gradient(dtype):
    """``attn_block_bwd_reference`` and ``attn_block_param_grads`` against
    autograd through ``attn_block_reference``. bf16: each gradient within
    2% of the largest value among the gradients of its rank (the two routes
    round at different places; the key bias's gradient is zero in exact
    arithmetic)."""
    args = [torch.from_numpy(a) for a in _args(seed=3)]
    args[0] = args[0].to(dtype)
    leaves = [a.clone().requires_grad_(True) for a in args]
    dy = torch.from_numpy(np.random.default_rng(7).standard_normal((B, N, C)).astype(np.float32))
    dy = dy.to(dtype)
    auto = torch.autograd.grad(tb.attn_block_reference(*leaves, H, EPS), leaves, dy)
    dx = tb.attn_block_bwd_reference(*args[:-1], dy, H, EPS)
    grads = tb.attn_block_param_grads(*args, dy, H, EPS, (True,) * 10)
    assert dx.dtype == dtype and all(g.dtype == torch.float32 for g in grads)
    if dtype == torch.float32:
        for got, want in zip((dx, *grads), auto):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
        return
    torch.testing.assert_close(dx.float(), auto[0].float(), atol=5e-2, rtol=5e-2)
    scale = {1: max(float(w.abs().max()) for w in auto[1:] if w.dim() == 1),
             2: max(float(w.abs().max()) for w in auto[1:] if w.dim() == 2)}
    for name, got, want in zip(NAMES[1:], grads, auto[1:]):
        assert float((got - want).abs().max()) <= 2e-2 * scale[want.dim()], name


def test_softmax_is_not_uniform_and_scale_matters():
    """The test inputs can tell a wrong score scale: the largest probability
    of a row is far above 1/N, and the output moves with the scale."""
    args = [torch.from_numpy(a) for a in _args()]
    probs = tb._forward_parts(*args[:9], H, EPS)[-1]
    assert float(probs.amax(-1).mean()) > 5.0 / N
    out = tb.attn_block_reference(*args, H, EPS)
    wrong = tb.attn_block_reference(args[0], args[1], args[2], args[3] * 2.0, *args[4:], H, EPS)
    assert float((out - wrong).abs().max()) > 0.05


def test_param_grads_are_taken_only_where_asked():
    targs = [torch.from_numpy(a) for a in _args(seed=4)]
    targs[9].requires_grad_(True)  # wo only
    before = tb.PARAM_GRAD_CALLS
    (dwo,) = torch.autograd.grad(tb.attn_block(*targs, H, EPS).sum(), targs[9])
    assert tb.PARAM_GRAD_CALLS == before + 1 and dwo.shape == (C, C)
    needs = [False] * 10
    needs[8] = needs[9] = True
    out = tb.attn_block_param_grads(*(t.detach() for t in targs), torch.ones(B, N, C), H, EPS,
                                    needs)
    assert [o is None for o in out] == [True] * 8 + [False, False]
    torch.testing.assert_close(out[8], dwo, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out[9], torch.full((C,), float(B * N)))


@pytest.mark.parametrize("case", ["dtype", "width", "heads", "seq", "smem", "rank", "rows"])
def test_kernel_wrapper_refuses_before_any_build(case, monkeypatch):
    """What the CUDA kernels do not take raises in the wrapper (no nvcc here).
    The shared-memory budget no longer depends on N: the backward takes N =
    240 at C = 768 (the first port's did not), and a budget below what the
    backward kernel needs is refused before any launch."""
    c = 256 if case == "width" else 768
    n = 300 if case == "seq" else (240 if case == "smem" else 197)
    heads = 6 if case == "heads" else c // 64
    x = torch.zeros(2, n, c, dtype=torch.float32 if case == "dtype" else torch.bfloat16)
    if case == "rank":
        x = x[0]
    rows = [torch.zeros(c), torch.zeros(c)]
    for _ in range(4):
        rows += [torch.zeros(c, c), torch.zeros(c)]
    if case == "rows":
        rows[4] = torch.zeros(c + 1)
    with pytest.raises(TypeError if case == "dtype" else ValueError):
        if case == "smem":
            assert tb.supported_shape(n, c, heads)
            with monkeypatch.context() as m:
                m.setattr(tb, "_MAX_SMEM", tb._smem_bytes(n, c, True) - 1)
                assert tb.supported_shape(n, c, heads, backward=False)
                tb.fused_attn_block_bwd(x, *rows[:-1], torch.zeros_like(x), heads, EPS)
        else:
            tb.fused_attn_block_fwd(x, *rows, heads, EPS)
    assert tb.supported_shape(197, 768, 12) and tb.supported_shape(37, 192, 3)
    assert not tb.supported_shape(197, 768, 6) and not tb.supported_shape(257, 768, 12)


@pytest.mark.parametrize("n,c,heads", [(197, 768, 12), (1, 192, 3), (64, 192, 3), (65, 384, 6),
                                       (208, 768, 12), (256, 768, 12)])
def test_kernel_variant_is_the_hopper_kernel_at_every_supported_shape(n, c, heads):
    assert tb.kernel_variant(n, c, heads) == "wgmma"
    assert tb.supported_shape(n, c, heads) and tb.supported_shape(n, c, heads, backward=False)


@pytest.mark.parametrize("n,c,heads", [(257, 768, 12), (0, 192, 3), (197, 768, 6),
                                       (197, 256, 4), (197, 64, 1)])
def test_kernel_variant_refuses_what_the_kernels_do_not_take(n, c, heads):
    with pytest.raises(ValueError):
        tb.kernel_variant(n, c, heads)


def test_smem_budget_is_the_launchers_and_independent_of_n():
    """``_smem_bytes`` mirrors ``HeadsCfg`` in ``csrc/attn_block.cu``: 1024
    bytes of alignment slack, 10 (forward) or 16 (backward) 8 KB tiles, 3 or
    2 ring stages of 40 KB, the row statistics and the ring's barriers."""
    for n in (1, 64, 197, 208, 256):
        for c in tb.KERNEL_DIMS:
            assert tb._smem_bytes(n, c, False) == 206896
            assert tb._smem_bytes(n, c, True) == 217120
    assert tb._smem_bytes(256, 768, True) <= tb._MAX_SMEM


@pytest.mark.parametrize("n", [1, 63, 65, 197])
def test_plain_matches_jax_pallas_kernel_at_the_tile_edges(n):
    """The plain forward and dx against the Pallas kernel (interpret mode)
    at the Hopper kernels' 64-row tile edges, f32, one batch element."""
    rng = np.random.default_rng(n)
    r = lambda shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    args = [r((1, n, C)), 1.0 + 0.3 * r((C,)), 0.3 * r((C,))]
    for t in "qkvo":
        args += [r((C, C), (0.4 if t in "qk" else 0.125)), r((C,), 0.3)]
    g = r((1, n, C))
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda a: jb.fused_attn_block(a, *map(jnp.asarray, args[1:]), H, EPS),
                            jnp.asarray(args[0]))
        (want_dx,) = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a) for a in args]
    got = tb.attn_block_reference(*targs, H, EPS)
    dx = tb.attn_block_bwd_reference(*targs[:-1], torch.from_numpy(g), H, EPS)
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(dx.numpy(), _f32(want_dx), atol=1e-4, rtol=1e-3)
