"""The port's depthwise 7x7 (``kernels/dwconv.py``, plain version: the CPU
route of its wrapper) against the JAX package's ``kernels/dwconv.py``.

The same numpy inputs go through the port's wrapper (on the CPU it runs the
plain version in forward and backward), the JAX XLA reference ``_ref`` and
the Pallas kernel ``dwconv7`` in interpret mode. Limits are those of the JAX
kernel's own tests: f32 forward 1e-5, gradients 5e-5 / 1e-4; bf16 forward
3e-2, dx 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import dwconv as tdw
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models.vit import _as_tensor
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.kernels import dwconv as jdw

SHAPES = [(2, 10, 9, 8), (1, 14, 14, 32)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((7, 7, shape[-1])).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _jax_fns(which):
    return jdw._ref if which == "ref" else jdw.dwconv7


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("which", ["ref", "pallas"])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_grads_match_jax_f32(shape, which):
    x, w, g = _inputs(shape)
    fn = _jax_fns(which)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
        want_dx, want_dw = vjp(jnp.asarray(g))
    xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    got = tdw.dwconv7(xt, wt)
    before = tdw.DW_CALLS
    dx, dw = torch.autograd.grad(got, (xt, wt), torch.from_numpy(g))
    assert tdw.DW_CALLS == before + 1
    np.testing.assert_allclose(got.detach().numpy(), _f32(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dx.numpy(), _f32(want_dx), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(dw.numpy(), _f32(want_dw), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("which", ["ref", "pallas"])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_dx_match_jax_bf16(shape, which):
    x, w, g = _inputs(shape, seed=1)
    fn = _jax_fns(which)
    xj, wj, gj = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, g))
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda a: fn(a, wj), xj)
        (want_dx,) = vjp(gj)
    xt = _as_tensor(np.asarray(xj)).requires_grad_(True)
    wt, gt = _as_tensor(np.asarray(wj)), _as_tensor(np.asarray(gj))
    got = tdw.dwconv7(xt, wt)
    before = tdw.DW_CALLS
    (dx,) = torch.autograd.grad(got, xt, gt)
    assert got.dtype == dx.dtype == torch.bfloat16
    assert tdw.DW_CALLS == before  # the input gradient alone never recomputes dw
    np.testing.assert_allclose(got.detach().float().numpy(), _f32(want), atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(dx.float().numpy(), _f32(want_dx), atol=5e-2, rtol=5e-2)


def test_filter_is_rounded_to_the_activation_dtype_first():
    """f32 filter, bf16 activations: the taps used are the bf16-rounded ones,
    the same bits the library conv (``w.to(x.dtype)``) sees."""
    x, w, _ = _inputs(SHAPES[0], seed=2)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    w32 = torch.from_numpy(w)
    rounded = w32.to(torch.bfloat16)
    assert not torch.equal(rounded.float(), w32)
    assert torch.equal(tdw.dwconv7(xt, w32), tdw.dwconv7(xt, rounded))
    assert torch.equal(tdw.dwconv7_reference(xt, w32), tdw.dwconv7_reference(xt, rounded.float()))
    want = jdw._ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))  # _ref rounds w itself
    np.testing.assert_allclose(tdw.dwconv7(xt, w32).float().numpy(), _f32(want),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_dx_is_the_forward_with_the_flipped_filter(shape, dtype):
    x, w, g = _inputs(shape, seed=3)
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt, gt = torch.from_numpy(w), torch.from_numpy(g).to(dtype)
    (dx,) = torch.autograd.grad(tdw.dwconv7(xt, wt), xt, gt)
    assert torch.equal(dx, tdw.dwconv7_reference(gt, wt.flip(0, 1)))
    # and it is the plain version's own autograd gradient
    xr = xt.detach().clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(tdw.dwconv7_reference(xr, wt), xr, gt)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(dx.float(), auto.float(), atol=tol, rtol=tol)


def test_plain_version_matches_49_shifted_multiply_adds():
    """The plain version (F.conv2d on widened operands) against the sum the
    kernel computes: 49 shifted products on a zero-padded tensor, row-major."""
    x, w, _ = _inputs(SHAPES[0], seed=4)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    b, h, wd, c = xt.shape
    xp = torch.nn.functional.pad(xt, (0, 0, 3, 3, 3, 3))
    acc = torch.zeros_like(xt)
    for di in range(7):
        for dj in range(7):
            acc = acc + xp[:, di:di + h, dj:dj + wd, :] * wt[di, dj]
    torch.testing.assert_close(tdw.dwconv7_reference(xt, wt), acc, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bad,err", [((2, 5, 5, 12), ValueError), ((5, 5, 8), ValueError)])
def test_kernel_wrapper_refuses_before_any_build(bad, err):
    """Shape and device checks come before the library is loaded (no nvcc here)."""
    x = torch.zeros(*bad)
    with pytest.raises(err):
        tdw.fused_dwconv7_fwd(x, torch.zeros(7, 7, bad[-1]))
    with pytest.raises(ValueError, match="CUDA"):
        tdw.fused_dwconv7_fwd(torch.zeros(1, 4, 4, 8), torch.zeros(7, 7, 8))
