"""The port's window attention (plain version on the CPU) against the JAX
package's ``fused_window_attention`` (Pallas, interpret mode).

Tolerances are those of the JAX kernel's own parity test: forward atol 2e-5,
rtol 1e-4; dqkv and dbias atol 5e-5, rtol 1e-3. The CUDA kernel itself has
no CPU mode: ``chip_smoke.py`` holds it against this plain version on the
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import window_attention as tkw
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.kernels import window_attention as jkw

# (B, nW, n, heads, hd): the window-7 shape of the kernel's path and a
# window-4 shape at another head dim
SHAPES = [(2, 4, 49, 2, 32), (2, 4, 16, 2, 16)]
# the Hopper kernel's tile edges: windows of 16, 49 and 64 tokens (64-row
# tiles, 49 and 16 ragged), one window per image
EDGE_SHAPES = [(2, 1, 16, 2, 32), (2, 1, 49, 2, 32), (2, 1, 64, 2, 32)]
FWD_TOL, GRAD_TOL = dict(atol=2e-5, rtol=1e-4), dict(atol=5e-5, rtol=1e-3)


def _inputs(b, nw, n, h, hd, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, nw, n, 3 * h * hd)).astype(np.float32)
    bias = (rng.standard_normal((h, n, n)) * 0.1).astype(np.float32)
    mask = np.where(rng.random((nw, n, n)) < 0.2, -100.0, 0.0).astype(np.float32)
    do = rng.standard_normal((b, nw, n, h * hd)).astype(np.float32)
    return qkv, bias, mask, do


@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_pallas_kernel_interpret(shape):
    h = shape[3]
    qkv, bias, mask, _ = _inputs(*shape)
    tq, tb = (torch.from_numpy(x).requires_grad_(True) for x in (qkv, bias))
    o_t = tkw.window_attention(tq, tb, torch.from_numpy(mask), h)
    (o_t ** 2).sum().backward()

    def loss(q, b):
        return jnp.sum(jkw.fused_window_attention(q, b, jnp.asarray(mask), h) ** 2)

    with pltpu.force_tpu_interpret_mode():
        o_j = jkw.fused_window_attention(jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(mask), h)
        dq_j, db_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias))
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), **FWD_TOL)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(dq_j), **GRAD_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(db_j), **GRAD_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_and_dbias_equal_autograd(shape):
    h = shape[3]
    qkv, bias, mask, do = (torch.from_numpy(x) for x in _inputs(*shape, seed=1))
    got = tkw.window_attention_bwd_reference(qkv, bias, mask, do, h)
    calls = tkw.DBIAS_CALLS
    dbias = tkw.window_attention_dbias(qkv, bias, mask, do, h)
    assert tkw.DBIAS_CALLS == calls + 1
    tq, tb = qkv.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    torch.autograd.backward(tkw.window_attention_reference(tq, tb, mask, h), do)
    np.testing.assert_allclose(got.numpy(), tq.grad.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(dbias.numpy(), tb.grad.numpy(), **GRAD_TOL)


def test_bf16_plain_rounds_like_the_kernel():
    """bf16 plain forward/backward stay close to the f32 math (the kernel's
    roundings: P and ds to bf16) and keep the input dtype."""
    qkv, bias, mask, do = _inputs(2, 4, 49, 2, 32, seed=2)
    q16, do16 = (torch.from_numpy(x).to(torch.bfloat16) for x in (qkv, do))
    b, m = torch.from_numpy(bias), torch.from_numpy(mask)
    o = tkw.window_attention_reference(q16, b, m, 2)
    assert o.dtype == torch.bfloat16 and o.shape == (2, 4, 49, 64)
    torch.testing.assert_close(o.float(), tkw.window_attention_reference(q16.float(), b, m, 2),
                               atol=3e-2, rtol=3e-2)
    g = tkw.window_attention_bwd_reference(q16, b, m, do16, 2)
    assert g.dtype == torch.bfloat16 and g.shape == q16.shape
    torch.testing.assert_close(
        g.float(), tkw.window_attention_bwd_reference(q16.float(), b, m, do16.float(), 2),
        atol=5e-2, rtol=5e-2)


def test_cpu_dispatch_takes_plain_version():
    qkv, bias, mask, _ = (torch.from_numpy(x) for x in _inputs(1, 2, 16, 2, 32))
    before = (tkw.FWD_LAUNCHES, tkw.BWD_LAUNCHES)
    torch.testing.assert_close(tkw.window_attention(qkv, bias, mask, 2),
                               tkw.window_attention_reference(qkv, bias, mask, 2),
                               rtol=0, atol=0)
    assert (tkw.FWD_LAUNCHES, tkw.BWD_LAUNCHES) == before


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"), ("head_dim", "head dim"), ("tokens", "tokens"),
    ("heads", "divisible"), ("bias_dtype", "float32"), ("mask_shape", "do not fit")])
def test_kernel_refuses_what_it_does_not_take(case, match):
    qkv, bias, mask, _ = (torch.from_numpy(x) for x in _inputs(1, 2, 16, 2, 32))
    args = {"cpu": (qkv, bias, mask, 2),
            "head_dim": (torch.zeros(1, 2, 16, 3 * 2 * 16), bias, mask, 2),
            "tokens": (torch.zeros(1, 1, 81, 3 * 64), torch.zeros(2, 81, 81),
                       torch.zeros(1, 81, 81), 2),
            "heads": (qkv, bias, mask, 5),
            "bias_dtype": (qkv, bias.double(), mask, 2),
            "mask_shape": (qkv, bias, mask[:1], 2)}[case]
    with pytest.raises(ValueError, match=match):
        tkw.fused_window_attention(*args)


@pytest.mark.parametrize("dtype,n,heads,want", [
    (torch.bfloat16, 49, 4, "wgmma"), (torch.bfloat16, 49, 32, "wgmma"),
    (torch.bfloat16, 16, 2, "wgmma"), (torch.bfloat16, 64, 2, "wgmma"),
    (torch.bfloat16, 49, 3, "mma_sync"), (torch.bfloat16, 1, 1, "mma_sync"),
    (torch.float32, 49, 4, "cuda_core"), (torch.float32, 64, 3, "cuda_core")])
def test_kernel_variant_by_shape(dtype, n, heads, want):
    """bf16 with an even head count takes the Hopper kernel (two heads of a
    window are one 128-byte tile row), an odd count the mma.sync one, f32 the
    CUDA cores; the window size does not choose."""
    assert tkw.kernel_variant(dtype, n, heads) == want


@pytest.mark.parametrize("kw,err", [
    (dict(dtype=torch.bfloat16, n=49, heads=4, hd=16), ValueError),
    (dict(dtype=torch.bfloat16, n=0, heads=4), ValueError),
    (dict(dtype=torch.bfloat16, n=65, heads=4), ValueError),
    (dict(dtype=torch.bfloat16, n=49, heads=0), ValueError),
    (dict(dtype=torch.float16, n=49, heads=4), TypeError)])
def test_kernel_variant_refuses_what_no_variant_takes(kw, err):
    with pytest.raises(err):
        tkw.kernel_variant(**kw)
