"""The port's packed attention (plain version on the CPU) against the JAX
package's ``fused_attention_packed`` (Pallas, interpret mode) and
``attention_packed_reference``.

Tolerances are those of the JAX kernel's own parity test: forward atol 2e-5,
rtol 1e-4; gradients atol 5e-5, rtol 1e-3. The CUDA kernel itself has no
CPU mode: ``chip_smoke.py`` holds it against this plain version on the card.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import attention as tka
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.kernels import attention as jka

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(2, 37, 3, 32), (1, 197, 2, 64)]  # (B, N, H, hd)


def _inputs(b, n, h, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, h * hd)).astype(np.float32) for _ in range(4)]


def _torch_grads(fn, q, k, v, heads):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*ts, heads)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_grads(fn, q, k, v, heads):
    loss = lambda q, k, v: jnp.sum(fn(q, k, v, heads) ** 2)
    args = [jnp.asarray(x) for x in (q, k, v)]
    return np.asarray(fn(*args, heads)), [np.asarray(g) for g in
                                          jax.grad(loss, argnums=(0, 1, 2))(*args)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_pallas_kernel_interpret(shape):
    b, n, h, hd = shape
    q, k, v, _ = _inputs(*shape)
    o_t, g_t = _torch_grads(tka.attention_packed, q, k, v, h)
    with pltpu.force_tpu_interpret_mode():
        o_j, g_j = _jax_grads(jka.fused_attention_packed, q, k, v, h)
    np.testing.assert_allclose(o_t, o_j, atol=2e-5, rtol=1e-4)
    for a, bb in zip(g_t, g_j):
        np.testing.assert_allclose(a, bb, atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_reference(shape):
    b, n, h, hd = shape
    q, k, v, _ = _inputs(*shape, seed=1)
    o_t, g_t = _torch_grads(tka.attention_packed_reference, q, k, v, h)
    o_j, g_j = _jax_grads(jka.attention_packed_reference, q, k, v, h)
    np.testing.assert_allclose(o_t, o_j, atol=2e-5, rtol=1e-4)
    for a, bb in zip(g_t, g_j):
        np.testing.assert_allclose(a, bb, atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_equals_autograd_and_jax(shape):
    b, n, h, hd = shape
    q, k, v, do = _inputs(*shape, seed=2)
    got = tka.attention_packed_bwd_reference(*map(torch.from_numpy, (q, k, v, do)), h)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    torch.autograd.backward(tka.attention_packed_reference(*ts, h), torch.from_numpy(do))
    _, vjp = jax.vjp(lambda q, k, v: jka.attention_packed_reference(q, k, v, h),
                     *map(jnp.asarray, (q, k, v)))
    want_j = vjp(jnp.asarray(do))
    for g, t, j in zip(got, ts, want_j):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=5e-5, rtol=1e-3)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=5e-5, rtol=1e-3)


def test_bf16_plain_backward_rounds_like_the_kernel():
    """bf16 plain forward/backward stay close to the f32 math (the kernel's
    roundings: P and dS to bf16) and keep the input dtype."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(2, 37, 3, 32, seed=3))
    o = tka.attention_packed_reference(q, k, v, 3)
    assert o.dtype == torch.bfloat16
    o32 = tka.attention_packed_reference(q.float(), k.float(), v.float(), 3)
    torch.testing.assert_close(o.float(), o32, atol=3e-2, rtol=3e-2)
    grads = tka.attention_packed_bwd_reference(q, k, v, do, 3)
    grads32 = tka.attention_packed_bwd_reference(q.float(), k.float(), v.float(), do.float(), 3)
    for g, g32 in zip(grads, grads32):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), g32, atol=5e-2, rtol=5e-2)


def test_cpu_dispatch_takes_plain_version_and_kernel_refuses_cpu():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 9, 2, 32))
    before = (tka.FWD_LAUNCHES, tka.BWD_LAUNCHES)
    torch.testing.assert_close(tka.attention_packed(q, k, v, 2),
                               tka.attention_packed_reference(q, k, v, 2), rtol=0, atol=0)
    assert (tka.FWD_LAUNCHES, tka.BWD_LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        tka.fused_attention_packed(q, k, v, 2)
    with pytest.raises(ValueError, match="head dim"):
        tka.fused_attention_packed_fwd(q[..., :48], k[..., :48], v[..., :48], 2)
    with pytest.raises(ValueError, match="divisible"):
        tka.fused_attention_packed_fwd(q, k, v, 3)


def test_import_compiles_nothing(tmp_path):
    code = ("import os, sys\n"
            "from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import attention, _build\n"
            "from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit\n"
            "assert _build._LOADED == {} and _build.BUILD_SECONDS == {}\n"
            "assert not os.path.exists(os.environ['APVT_TORCH_BUILD_DIR'])\n"
            "assert 'triton' not in sys.modules\n")
    env = dict(os.environ, APVT_TORCH_BUILD_DIR=str(tmp_path / "build"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(tmp_path),
                   timeout=120)
