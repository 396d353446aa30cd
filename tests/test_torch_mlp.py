"""The port's LN-fused MLP (``kernels/mlp.py``: plain versions, the CPU route
of its ``autograd.Function``, the parameter gradients) against the JAX
package's ``kernels/mlp.py``.

The same numpy inputs (d=32, m=128, 70 tokens: the JAX test's shape) go
through the port, the JAX XLA reference ``ln_mlp_reference`` and the Pallas
kernel ``fused_ln_mlp`` in interpret mode. Limits are those of the JAX
kernel's own tests: f32 forward 2e-5 / 1e-4 and all seven gradients
1e-4 / 1e-3; bf16 forward 1e-2 and dx 2e-2; the shared f32 LayerNorm
forward and backward at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch import kernels as tk
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import mlp as tm
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models.vit import _as_tensor
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu import kernels as jk
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.kernels import mlp as jm

D, M, EPS = 32, 128, 1e-6
NAMES = ("x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2")


def _args(seed=11):
    rng = np.random.default_rng(seed)
    r = lambda shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    return (r((2, 35, D)), 1.0 + 0.1 * r((D,)), 0.1 * r((D,)), r((D, M), 0.1), r((M,), 0.1),
            r((M, D), 0.1), r((D,), 0.1))


def _jax_fn(which):
    return jm.ln_mlp_reference if which == "ref" else jm.fused_ln_mlp


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("which", ["ref", "pallas"])
def test_forward_and_all_grads_match_jax_f32(which):
    args = _args()
    fn = _jax_fn(which)
    g = np.random.default_rng(5).standard_normal(args[0].shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda *a: fn(*a, EPS), *map(jnp.asarray, args))
        want_grads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    before = tm.PARAM_GRAD_CALLS
    got = tm.ln_mlp(*targs, EPS)
    grads = torch.autograd.grad(got, targs, torch.from_numpy(g))
    assert tm.PARAM_GRAD_CALLS == before + 1
    np.testing.assert_allclose(got.detach().numpy(), _f32(want), atol=2e-5, rtol=1e-4)
    for name, gt, gw in zip(NAMES, grads, want_grads):
        assert gt.shape == gw.shape, name
        np.testing.assert_allclose(gt.numpy(), _f32(gw), atol=1e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("which", ["ref", "pallas"])
def test_forward_and_dx_match_jax_bf16(which):
    args = _args()
    fn = _jax_fn(which)
    xj = jnp.asarray(args[0], jnp.bfloat16)
    rest = tuple(jnp.asarray(a) for a in args[1:])
    gj = jnp.asarray(np.random.default_rng(6).standard_normal(args[0].shape), jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda a: fn(a, *rest, EPS), xj)
        (want_dx,) = vjp(gj)
    xt = _as_tensor(np.asarray(xj)).requires_grad_(True)
    trest = [torch.from_numpy(a) for a in args[1:]]
    before = tm.PARAM_GRAD_CALLS
    got = tm.ln_mlp(xt, *trest, EPS)
    (dx,) = torch.autograd.grad(got, xt, _as_tensor(np.asarray(gj)))
    assert got.dtype == dx.dtype == torch.bfloat16 and got.shape == xt.shape
    assert tm.PARAM_GRAD_CALLS == before  # the input gradient alone recomputes no parameter gradient
    np.testing.assert_allclose(got.detach().float().numpy(), _f32(want), atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(dx.float().numpy(), _f32(want_dx), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plain_version_is_the_forward_plain_versions_gradient(dtype):
    """``ln_mlp_bwd_reference`` (the backward kernel's plain version) against
    autograd through ``ln_mlp_reference``, token rows (T, D)."""
    args = _args(seed=3)
    x = torch.from_numpy(args[0]).reshape(-1, D).to(dtype).requires_grad_(True)
    rest = [torch.from_numpy(a) for a in args[1:]]
    dy = torch.from_numpy(np.random.default_rng(7).standard_normal((70, D)).astype(np.float32))
    dy = dy.to(dtype)
    (auto,) = torch.autograd.grad(tm.ln_mlp_reference(x, *rest, EPS), x, dy)
    got = tm.ln_mlp_bwd_reference(x.detach(), *rest[:5], dy, EPS)
    tol = dict(atol=1e-5, rtol=1e-4) if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), auto.float(), **tol)


def test_param_grads_are_taken_only_where_asked():
    args = _args(seed=4)
    targs = [torch.from_numpy(a) for a in args]
    targs[3].requires_grad_(True)  # w1 only
    before = tm.PARAM_GRAD_CALLS
    (dw1,) = torch.autograd.grad(tm.ln_mlp(*targs, EPS).sum(), targs[3])
    assert tm.PARAM_GRAD_CALLS == before + 1 and dw1.shape == (D, M)
    x2, dy = targs[0].reshape(-1, D), torch.ones(70, D)
    out = tm.ln_mlp_param_grads(x2, *targs[1:], dy, EPS, (False, False, True, False, False, True))
    assert [o is None for o in out] == [True, True, False, True, True, False]
    torch.testing.assert_close(out[2], dw1, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out[5], torch.full((D,), 70.0))


def test_layer_norm_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 7, D)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(D)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(D)).astype(np.float32)
    dh = rng.standard_normal((5, 7, D)).astype(np.float32)
    want = jk.ln_fwd_f32(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), EPS)
    got = tk.ln_fwd_f32(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), EPS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)
    want_dx = jk.ln_bwd_f32(jnp.asarray(dh), jnp.asarray(scale), want[0], want[1])
    got_dx = tk.ln_bwd_f32(torch.from_numpy(dh), torch.from_numpy(scale), got[0], got[1])
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), atol=1e-6, rtol=1e-6)
    # and it is the gradient of the forward
    xt = torch.from_numpy(x).requires_grad_(True)
    h = tk.ln_fwd_f32(xt, torch.from_numpy(scale), torch.from_numpy(bias), EPS)[2]
    (auto,) = torch.autograd.grad(h, xt, torch.from_numpy(dh))
    torch.testing.assert_close(got_dx, auto, atol=1e-5, rtol=1e-4)


def test_gelu_matches_ops_nn():
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import nn as tnn

    pre = torch.linspace(-6, 6, 257, requires_grad=True)
    torch.testing.assert_close(tm._gelu_f32(pre), tnn.gelu(pre), atol=1e-6, rtol=1e-6)
    (auto,) = torch.autograd.grad(tnn.gelu(pre).sum(), pre)
    torch.testing.assert_close(tm._gelu_grad_f32(pre.detach()), auto, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("case", ["dtype", "width", "hidden", "rows", "device"])
def test_kernel_wrapper_refuses_before_any_build(case):
    """What the CUDA kernels do not take raises in the wrapper (no nvcc here)."""
    d, m = (100, 512) if case == "width" else (128, 200 if case == "hidden" else 512)
    x = torch.zeros(4, d, dtype=torch.float32 if case == "dtype" else torch.bfloat16)
    rows = [torch.zeros(d), torch.zeros(d), torch.zeros(d, m), torch.zeros(m), torch.zeros(m, d),
            torch.zeros(d + (1 if case == "rows" else 0))]
    err = TypeError if case == "dtype" else ValueError
    with pytest.raises(err):
        tm.fused_ln_mlp_fwd(x, *rows, EPS)
    assert 1024 in tm.KERNEL_DIMS and 768 in tm.KERNEL_DIMS


@pytest.mark.parametrize("case", ["dtype", "width", "device"])
def test_layer_norm_prologue_entry_refuses_before_any_build(case):
    """``kernel_ln_rows`` (the kernels' LayerNorm prologue, read by
    ``chip_smoke.py``) checks its operands as the kernels' wrappers do."""
    d = 100 if case == "width" else 128
    x = torch.zeros(4, d, dtype=torch.float32 if case == "dtype" else torch.bfloat16)
    with pytest.raises(TypeError if case == "dtype" else ValueError):
        tm.kernel_ln_rows(x, torch.ones(d), torch.zeros(d), EPS)


def test_diagnose_script_edits_find_their_places():
    """``tools/ln_mlp_diagnose`` times edited copies of ``csrc/ln_mlp.cu``; each
    edit must still find its place in the source (it raises otherwise)."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import _build
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import ln_mlp_diagnose

    text = _build.inlined("ln_mlp.cu")  # the source with the csrc headers it includes
    assert '#include "' not in text
    out = ln_mlp_diagnose.variants(text)
    assert list(out) == ["kernel", "no gelu", "no weight loads", "no mma", "no chunk wait"]
    assert out["kernel"] == text and len({*out.values()}) == 5
    assert "erff(pre" not in out["no gelu"] and "Wgmma<N>::template ss" not in out["no mma"]
    assert "mbar_complete_tx(bar, bytes);" in out["no weight loads"]
    assert "mbar_wait_cluster(&bars->hfull" not in out["no chunk wait"]
    with pytest.raises(RuntimeError, match="found nothing"):
        ln_mlp_diagnose.variants(text.replace("erff(pre", "erf_(pre"))


def test_prologue_diagnose_edits_find_their_places():
    """``tools/ln_prologue_diagnose`` builds copies of ``csrc/ln_mlp.cu`` with
    other rounding points in the LayerNorm prologue; each edit must find its
    place, and its operands are ``chip_smoke.py``'s (same draws, same order)."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import _build
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import ln_prologue_diagnose as lpd

    text = _build.inlined("ln_mlp.cu")
    out = lpd.variants(text)
    assert list(out) == ["kernel", "contracted", "squares and var + eps rounded"]
    assert out["kernel"] == text and len({*out.values()}) == 3
    assert "return xc * rstd * scale + bias;" in out["contracted"]
    assert "sq += v[p][e] * v[p][e];" not in out["squares and var + eps rounded"]
    assert "rsqrtf(__fadd_rn(__fmul_rn(group_sum(sq)" in out["squares and var + eps rounded"]
    with pytest.raises(RuntimeError, match="found nothing"):
        lpd.variants(text.replace("__fmul_rn(xc, rstd)", "__fmul_rn(rstd, xc)"))
    x, p = lpd.operands((6, 128, 256), 100, torch.device("cpu"))
    assert x.dtype == torch.bfloat16 and tuple(p["w1"].shape) == (128, 256)


# --- the wgmma kernels' tile edges (64 token rows a pass) and shape gates ------

T_EDGES = [1, 127, 128, 129]


def _rows_args(t, seed):
    rng = np.random.default_rng(seed)
    r = lambda shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    return (r((t, D)), 1.0 + 0.1 * r((D,)), 0.1 * r((D,)), r((D, M), 0.1), r((M,), 0.1),
            r((M, D), 0.1), r((D,), 0.1)), r((t, D))


@pytest.mark.parametrize("t", T_EDGES)
@pytest.mark.parametrize("ln", [True, False], ids=["ln_mlp", "mlp"])
def test_plain_versions_at_row_tile_edges_match_jax(t, ln):
    """T = 1, 127, 128, 129 token rows through the plain forward and dx of
    both fused MLPs against the JAX package's reference (f32: forward 2e-5 /
    1e-4, dx 1e-4 / 1e-3, the limits of this file)."""
    args, g = _rows_args(t, seed=100 + t)
    if ln:
        jfn = lambda x: jm.ln_mlp_reference(x, *map(jnp.asarray, args[1:]), EPS)
        got = tm.ln_mlp_reference(*map(torch.from_numpy, args), EPS)
        dx = tm.ln_mlp_bwd_reference(*map(torch.from_numpy, args[:6]), torch.from_numpy(g), EPS)
    else:
        jfn = lambda x: _jax_mlp_reference(x, *map(jnp.asarray, args[3:]))
        got = tm.mlp_reference(*map(torch.from_numpy, (args[0], *args[3:])))
        dx = tm.mlp_bwd_reference(*map(torch.from_numpy, (args[0], *args[3:6])),
                                  torch.from_numpy(g))
    want, vjp = jax.vjp(jfn, jnp.asarray(args[0]))
    (want_dx,) = vjp(jnp.asarray(g))
    assert got.shape == dx.shape == (t, D)
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(dx.numpy(), _f32(want_dx), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("d, m, want", [
    (128, 512, "wgmma"), (128, 128, "wgmma"), (256, 1024, "wgmma"), (384, 1536, "wgmma"),
    (384, 640, "wgmma"), (512, 2048, "wgmma"), (768, 3072, "wgmma"), (1024, 4096, "wgmma"),
    (512, 384, "mma_sync"), (768, 384, "mma_sync"), (1024, 128, "mma_sync")])
def test_kernel_variant_by_shape(d, m, want):
    """Every main-path width (ViT-B 768 x 3072, the ConvNeXt-B and Swin-B
    stages 128-1024 x 4) takes the wgmma kernels; from D = 512 on a hidden
    width that is 128 mod 256 keeps the mma.sync ones."""
    assert tm.kernel_variant(d, m) == want
    assert tm.kernel_variant(d, m, "mlp_bwd") == tm.kernel_variant(d, m, "ln_mlp_bwd") == want


@pytest.mark.parametrize("d, want", [(128, "mma_sync"), (256, "wgmma"), (1024, "wgmma")])
def test_ln_fused_forward_at_the_narrowest_width_keeps_mma_sync(d, want):
    """Measured on the card: at D = 128 the wgmma forward with the LayerNorm
    is 3% slower than the kernel it would replace."""
    assert tm.kernel_variant(d, 4 * d, "ln_mlp_fwd") == want


@pytest.mark.parametrize("d, m, msg", [
    (100, 512, "width 100"), (640, 2560, "width 640"), (2048, 8192, "width 2048"),
    (128, 200, "hidden width 200"), (128, 0, "hidden width 0"), (768, 64, "hidden width 64")])
def test_kernel_variant_refuses(d, m, msg):
    with pytest.raises(ValueError, match=msg):
        tm.kernel_variant(d, m)


# --- the fused MLP without LayerNorm (``fused_mlp`` of the JAX package) -------

def _mlp_args(seed=12):
    a = _args(seed)
    return (a[0], *a[3:])  # x, w1, b1, w2, b2


MLP_NAMES = ("x", "w1", "b1", "w2", "b2")


def _jax_mlp_reference(x, w1, b1, w2, b2):
    """The JAX library composition with ``ops.nn`` numerics."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import nn as jnn

    cd = x.dtype
    h = jnn.gelu(jnn.dense({"w": w1, "b": b1}, x, compute_dtype=cd))
    return jnn.dense({"w": w2, "b": b2}, h, compute_dtype=cd)


@pytest.mark.parametrize("which", ["ref", "pallas"])
def test_mlp_forward_and_all_grads_match_jax_f32(which):
    """f32: forward 2e-5 / 1e-4, gradients 1e-4 / 1e-3 against the library
    composition; against the Pallas kernel forward and dx 1e-5 / 1e-4 looser
    in absolute terms (5e-5, 2e-4), because that kernel takes erf from a
    polynomial good to 1.5e-7 where the port, like the library, calls erf."""
    args = _mlp_args()
    fn = _jax_mlp_reference if which == "ref" else jm.fused_mlp
    g = np.random.default_rng(5).standard_normal(args[0].shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(fn, *map(jnp.asarray, args))
        want_grads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    before = tm.MLP_PARAM_GRAD_CALLS
    got = tm.mlp(*targs)
    grads = torch.autograd.grad(got, targs, torch.from_numpy(g))
    assert tm.MLP_PARAM_GRAD_CALLS == before + 1
    f_atol, g_atol = (2e-5, 1e-4) if which == "ref" else (5e-5, 2e-4)
    np.testing.assert_allclose(got.detach().numpy(), _f32(want), atol=f_atol, rtol=1e-4)
    for name, gt, gw in zip(MLP_NAMES, grads, want_grads):
        assert gt.shape == gw.shape, name
        np.testing.assert_allclose(gt.numpy(), _f32(gw), atol=g_atol, rtol=1e-3, err_msg=name)


def test_mlp_forward_and_dx_match_jax_bf16():
    args = _mlp_args()
    xj = jnp.asarray(args[0], jnp.bfloat16)
    rest = tuple(jnp.asarray(a) for a in args[1:])
    gj = jnp.asarray(np.random.default_rng(6).standard_normal(args[0].shape), jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda a: jm.fused_mlp(a, *rest), xj)
        (want_dx,) = vjp(gj)
    xt = _as_tensor(np.asarray(xj)).requires_grad_(True)
    trest = [torch.from_numpy(a) for a in args[1:]]
    before = tm.MLP_PARAM_GRAD_CALLS
    got = tm.mlp(xt, *trest)
    (dx,) = torch.autograd.grad(got, xt, _as_tensor(np.asarray(gj)))
    assert got.dtype == dx.dtype == torch.bfloat16 and got.shape == xt.shape
    assert tm.MLP_PARAM_GRAD_CALLS == before
    np.testing.assert_allclose(got.detach().float().numpy(), _f32(want), atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(dx.float().numpy(), _f32(want_dx), atol=2e-2, rtol=2e-2)


def test_mlp_is_ln_mlp_without_the_layer_norm():
    """One device code, one set of rounding points: the LN-fused plain version
    on x equals the plain MLP on LN(x) rounded to the compute dtype."""
    args = _args(seed=9)
    x = torch.from_numpy(args[0]).to(torch.bfloat16)
    rest = [torch.from_numpy(a) for a in args[1:]]
    h = tk.ln_fwd_f32(x.float(), rest[0], rest[1], EPS)[2].to(torch.bfloat16)
    assert torch.equal(tm.ln_mlp_reference(x, *rest, EPS), tm.mlp_reference(h, *rest[2:]))
    with pytest.raises(ValueError):
        tm.fused_mlp_fwd(torch.zeros(4, 100, dtype=torch.bfloat16), torch.zeros(100, 128),
                         torch.zeros(128), torch.zeros(128, 100), torch.zeros(100))
