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
            "from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import window_attention\n"
            "from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import swin, vit\n"
            "from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.eval import compose\n"
            "assert _build._LOADED == {} and _build.BUILD_SECONDS == {}\n"
            "assert not os.path.exists(os.environ['APVT_TORCH_BUILD_DIR'])\n"
            "assert 'triton' not in sys.modules\n")
    env = dict(os.environ, APVT_TORCH_BUILD_DIR=str(tmp_path / "build"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(tmp_path),
                   timeout=120)


# --- the head-major kernel's side (``fused_attention`` of the JAX package) ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_major_plain_version_matches_jax_fused_attention(dtype):
    """(B, H, N, hd) = (2, 3, 37, 32) through the port's plain versions and the
    JAX Pallas kernel ``fused_attention`` in interpret mode (which pads N to
    128 and masks the keys): f32 1e-5 / 1e-4, gradients 1e-4 / 1e-3; bf16
    3e-2 forward, 5e-2 gradients (the packed kernel's limits)."""
    from jax.experimental.pallas import tpu as pltpu

    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models.vit import _as_tensor
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.kernels import attention as jatt

    rng = np.random.default_rng(31)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, k, v, do = (jnp.asarray(rng.standard_normal((2, 3, 37, 32)).astype(np.float32), jd)
                   for _ in range(4))
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(jatt.fused_attention, q, k, v)
        want_grads = vjp(do)
    tq, tk_, tv, tdo = (_as_tensor(np.asarray(a)) for a in (q, k, v, do))
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk_, tv)]
    got = tka.attention_auto(*leaves)  # the CPU route of the entry point
    grads = torch.autograd.grad(got, leaves, tdo)
    direct = tka.attention_bwd_reference(tq, tk_, tv, tdo)
    f_tol, g_tol = (((1e-5, 1e-4), (1e-4, 1e-3)) if dtype == "float32"
                    else ((3e-2, 3e-2), (5e-2, 5e-2)))
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=f_tol[0], rtol=f_tol[1])
    for g_auto, g_plain, w in zip(grads, direct, want_grads):
        for g in (g_auto, g_plain):
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                       atol=g_tol[0], rtol=g_tol[1])


def test_head_major_and_packed_plain_versions_agree_and_wrapper_refuses():
    rng = np.random.default_rng(32)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, 9, 32)).astype(np.float32))
               for _ in range(3))
    packed = tka.attention_packed_reference(*(tka._merge(t) for t in (q, k, v)), 2)
    assert torch.equal(tka._merge(tka.attention_reference(q, k, v)), packed)
    with pytest.raises(ValueError):  # CPU tensors never reach the kernel
        tka.fused_attention_fwd(q, k, v)
    with pytest.raises(ValueError):
        tka.fused_attention_fwd(q[0], k[0], v[0])


# --- the tile edges of the wgmma kernels (64-row tiles, 64-key blocks, N <= 256), the
# streamed route's first block edges past 256 (257 = 4 x 64 + 1; 385 = 6 x 64 + 1, three
# 128-row CTAs, the last with one busy warpgroup), and ViT-B/16's sequence at 384 px
# (577 = 9 x 64 + 1) ---

EDGES = [1, 63, 64, 65, 128, 197, 208, 256, 257, 385, 577]


def _edge_grads_torch(q, k, v, do, heads, dtype):
    ts = [torch.from_numpy(x).to(dtype) for x in (q, k, v, do)]
    out = tka.attention_packed_reference(*ts[:3], heads)
    return out, tka.attention_packed_bwd_reference(*ts, heads)


def _edge_grads_jax(q, k, v, do, heads, dtype):
    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(lambda q, k, v: jka.attention_packed_reference(q, k, v, heads), *args)
    return out, vjp(jnp.asarray(do).astype(dtype))


@pytest.mark.parametrize("n", EDGES)
def test_plain_f32_at_tile_edges_matches_jax(n):
    """Forward and the three gradients in f32, atol 1e-5 (rtol 1e-4: sums of
    up to 256 terms in another order)."""
    q, k, v, do = _inputs(1, n, 2, 64, seed=10 + n)
    o_t, g_t = _edge_grads_torch(q, k, v, do, 2, torch.float32)
    o_j, g_j = _edge_grads_jax(q, k, v, do, 2, jnp.float32)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5, rtol=1e-4)
    for a, bb in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("n", EDGES)
def test_plain_bf16_at_tile_edges_matches_jax(n):
    """The same in bf16 at the kernels' limits (3e-2 forward, 5e-2 gradients):
    the packages round P and dS at the same places, the matmuls differ."""
    q, k, v, do = _inputs(1, n, 2, 64, seed=30 + n)
    o_t, g_t = _edge_grads_torch(q, k, v, do, 2, torch.bfloat16)
    o_j, g_j = _edge_grads_jax(q, k, v, do, 2, jnp.bfloat16)
    assert o_t.dtype == torch.bfloat16
    np.testing.assert_allclose(o_t.float().numpy(), np.asarray(o_j.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)
    for a, bb in zip(g_t, g_j):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(bb.astype(jnp.float32)),
                                   atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("dtype, n, hd, direction, want", [
    (torch.bfloat16, 197, 64, "fwd", "wgmma"), (torch.bfloat16, 1, 64, "fwd", "wgmma"),
    (torch.bfloat16, 256, 64, "fwd", "wgmma"), (torch.bfloat16, 257, 64, "fwd", "wgmma_stream"),
    (torch.bfloat16, 320, 64, "fwd", "wgmma_stream"),
    (torch.bfloat16, 577, 64, "fwd", "wgmma_stream"),
    (torch.bfloat16, 1025, 64, "fwd", "wgmma_stream"),
    (torch.bfloat16, 577, 32, "fwd", "cuda_core"), (torch.bfloat16, 37, 32, "fwd", "mma_sync"),
    (torch.bfloat16, 300, 32, "fwd", "cuda_core"), (torch.float32, 197, 64, "fwd", "cuda_core"),
    (torch.float32, 37, 32, "fwd", "cuda_core"), (torch.float32, 577, 64, "fwd", "cuda_core"),
    (torch.float32, 1025, 32, "fwd", "cuda_core"),
    # the backward: bf16 with hd 64 takes the streamed roles at every N
    (torch.bfloat16, 1, 64, "bwd", "wgmma_stream"), (torch.bfloat16, 64, 64, "bwd", "wgmma_stream"),
    (torch.bfloat16, 197, 64, "bwd", "wgmma_stream"),
    (torch.bfloat16, 256, 64, "bwd", "wgmma_stream"),
    (torch.bfloat16, 257, 64, "bwd", "wgmma_stream"),
    (torch.bfloat16, 577, 64, "bwd", "wgmma_stream"), (torch.bfloat16, 37, 32, "bwd", "mma_sync"),
    (torch.bfloat16, 577, 32, "bwd", "cuda_core"), (torch.float32, 197, 64, "bwd", "cuda_core")])
def test_kernel_variant_by_shape(dtype, n, hd, direction, want):
    assert tka.kernel_variant(dtype, n, hd, direction) == want
    if direction == "fwd":  # the forward is the default direction
        assert tka.kernel_variant(dtype, n, hd) == want


@pytest.mark.parametrize("n", [1, 64, 197, 209, 385, 577, 1025])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_core_plan_fits_the_card_at_any_length(dtype, hd, n):
    """The CUDA-core launchers' shared memory, forward and backward, fits a
    block's 232,448 bytes and is the same at every N (whole heads on chip
    would stop the f32 backward at N = 208); the CTAs along N cover every row
    once (the backward's, once for each of its two roles)."""
    plan = tka.kernel_plan(dtype, n, hd)
    assert set(plan) == {"fwd", "bwd"}
    for name, kernel in plan.items():
        assert kernel["smem"] <= tka.MAX_SMEM == 232_448
        assert kernel["smem"] == tka.kernel_plan(dtype, 1, hd)[name]["smem"]
        roles = 2 if name == "bwd" else 1
        ctas = kernel["ctas"] // roles
        assert kernel["ctas"] == roles * ctas
        assert ctas * kernel["rows"] >= n > (ctas - 1) * kernel["rows"]
        warps = kernel["threads"] // 32  # each owns an equal block of the CTA's rows
        assert kernel["threads"] == 32 * warps and kernel["rows"] % (2 * warps) == 0


@pytest.mark.parametrize("n", [257, 320, 385, 577, 1025, 4097, 1, 63, 64, 65, 197, 256])
def test_stream_plan_fits_the_card_at_any_length(n):
    """The streamed route's shared memory, forward (N > 256) and backward
    (every N), fits a block's 232,448 bytes and is the same at every N; two
    forward CTAs and three backward CTAs fit an SM's 228 KB; the CTAs along
    N cover every row once (the backward's, once for each of its two roles),
    a warpgroup of 128 threads a 64-row tile. At N <= 256 the plan has the
    backward alone: the forward there is the whole-head ``"wgmma"`` code."""
    plan = tka.kernel_plan(torch.bfloat16, n, 64, variant="wgmma_stream")
    first = tka.kernel_plan(torch.bfloat16, 257, 64, variant="wgmma_stream")
    assert set(plan) == ({"fwd", "bwd"} if n > 256 else {"bwd"})
    assert set(plan) == {d for d in tka.DIRECTIONS
                         if tka.kernel_variant(torch.bfloat16, n, 64, d) == "wgmma_stream"}
    for name, kernel in plan.items():
        assert kernel["smem"] <= tka.MAX_SMEM == 232_448
        assert {k: v for k, v in kernel.items() if k != "ctas"} == \
            {k: v for k, v in first[name].items() if k != "ctas"}
        roles = 2 if name == "bwd" else 1
        ctas = kernel["ctas"] // roles
        assert kernel["ctas"] == roles * ctas
        assert ctas * kernel["rows"] >= n > (ctas - 1) * kernel["rows"]
        assert kernel["rows"] == 64 * kernel["warpgroups"]
        assert kernel["threads"] == 128 * kernel["warpgroups"] and kernel["stages"] >= 2
    assert 2 * first["fwd"]["smem"] <= 228 * 1024 and 3 * plan["bwd"]["smem"] <= 228 * 1024
    # the backward's scratch: lse2 and D of every row, padded to 64-row blocks
    assert tka.stream_work_floats(8, n, 12) == 8 * 12 * -(-n // 64) * 128
    with pytest.raises(ValueError, match="bf16 with hd 64"):
        tka.kernel_plan(torch.float32, n, 64, variant="wgmma_stream")
    with pytest.raises(ValueError, match="no launcher plan"):
        tka.kernel_plan(torch.bfloat16, n, 64, variant="wgmma")


@pytest.mark.parametrize("n", [257, 385])
def test_plain_bf16_at_stream_edges_matches_jax_pallas_kernel_interpret(n):
    """bf16 (1, N, 2, 64) at the streamed route's block edges: the port's plain
    forward and backward against the JAX package's Pallas kernel in interpret
    mode, at the bf16 limits (3e-2 forward, 5e-2 gradients)."""
    q, k, v, do = _inputs(1, n, 2, 64, seed=90 + n)
    o_t, g_t = _edge_grads_torch(q, k, v, do, 2, torch.bfloat16)
    args = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        o_j, vjp = jax.vjp(lambda q, k, v: jka.fused_attention_packed(q, k, v, 2), *args)
        g_j = vjp(jnp.asarray(do).astype(jnp.bfloat16))
    np.testing.assert_allclose(o_t.float().numpy(), np.asarray(o_j.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)
    for a, bb in zip(g_t, g_j):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(bb.astype(jnp.float32)),
                                   atol=5e-2, rtol=5e-2)


def test_backward_from_saved_matches_autograd_at_577_bf16():
    """The streamed route's arithmetic in plain PyTorch (P from the saved
    log-sum-exp, D from dO * O, P and dS rounded to bf16) against autograd
    through the plain forward at ViT-B/16's 384-px length, bf16, (2, 2, 577,
    64), within the bf16 gradient limit 5e-2."""
    rng = np.random.default_rng(577)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 2, 577, 64)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = tka.attention_reference(*leaves)
    want = torch.autograd.grad(o, leaves, do)
    got = tka.attention_bwd_from_saved(q, k, v, do, o.detach(), tka.attention_lse_reference(q, k))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("dtype, n, hd, exc, msg", [
    (torch.bfloat16, 197, 48, ValueError, "head dim 48"),
    (torch.bfloat16, 197, 128, ValueError, "head dim 128"),
    (torch.float16, 197, 64, TypeError, "float16"),
    (torch.bfloat16, 0, 64, ValueError, "sequence length 0")])
def test_kernel_variant_refuses(dtype, n, hd, exc, msg):
    with pytest.raises(exc, match=msg):
        tka.kernel_variant(dtype, n, hd)


@pytest.mark.parametrize("n", [5, 64, 197])
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-5), (torch.bfloat16, 5e-2)])
def test_backward_from_saved_output_and_lse_gives_the_same_gradients(n, dtype, atol):
    """The wgmma backward's arithmetic (P from the saved log-sum-exp, D from
    dO * O) against the recomputing plain backward: equal in f32 up to
    summation order; in bf16 D sees O's rounding, far inside the 5e-2 limit."""
    q, k, v, do = (tka._split(torch.from_numpy(x).to(dtype), 2)
                   for x in _inputs(2, n, 2, 64, seed=50 + n))
    o = tka.attention_reference(q, k, v)
    lse = tka.attention_lse_reference(q, k)
    assert lse.shape == (2, 2, n) and lse.dtype == torch.float32
    got = tka.attention_bwd_from_saved(q, k, v, do, o, lse)
    want = tka.attention_bwd_reference(q, k, v, do)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=1e-4 if atol < 1e-3 else atol)


@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_autograd_function_saves_output_and_lse_and_launches_once_each(monkeypatch, layout):
    """With the launchers replaced by their plain versions (no card here):
    the backward gets the forward's o and lse, the forward is not run again,
    and the gradients are the plain ones."""
    seen = {}

    def fake_fwd(q, k, v, heads):
        qs, ks, vs = (t if heads is None else tka._split(t, heads) for t in (q, k, v))
        o, lse = tka.attention_reference(qs, ks, vs), tka.attention_lse_reference(qs, ks)
        return (o if heads is None else tka._merge(o)), lse

    def fake_bwd(q, k, v, do, o, lse, heads):
        seen["o"], seen["lse"] = o, lse
        ts = [t if heads is None else tka._split(t, heads) for t in (q, k, v, do, o)]
        grads = tka.attention_bwd_from_saved(*ts, lse)
        return grads if heads is None else tuple(tka._merge(g) for g in grads)

    monkeypatch.setattr(tka, "_launch_fwd", fake_fwd)
    monkeypatch.setattr(tka, "_launch_bwd", fake_bwd)
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 9, 2, 64, seed=70))
    if layout == "packed":
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        names = ("FWD_LAUNCHES", "BWD_LAUNCHES")
        out = tka.fused_attention_packed(*ts, 2)
        want = tka.attention_packed_bwd_reference(q, k, v, do, 2)
    else:
        q, k, v, do = (tka._split(t, 2).contiguous() for t in (q, k, v, do))
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        names = ("BHND_FWD_LAUNCHES", "BHND_BWD_LAUNCHES")
        out = tka.fused_attention(*ts)
        want = tka.attention_bwd_reference(q, k, v, do)
    before = tuple(getattr(tka, nm) for nm in names)
    out.backward(do)
    assert tuple(getattr(tka, nm) for nm in names) == (before[0], before[1] + 1)
    assert torch.equal(seen["o"], out.detach()) and seen["lse"].shape == (1, 2, 9)
    for t, w in zip(ts, want):
        torch.testing.assert_close(t.grad, w, atol=1e-5, rtol=1e-4)


def test_diagnose_script_edits_find_their_places():
    """``tools/attention_diagnose`` times edited copies of
    ``csrc/attention_packed.cu``; each edit must still find its place in the
    source (it raises otherwise) and stay inside the variant it edits: the
    CUDA-core code (namespace ``cc``) or the streamed tensor-core code
    (namespace ``wgs``, ``csrc/attn_stream.cuh``)."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import _build
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import attention_diagnose

    text = _build.inlined("attention_packed.cu")
    assert '#include "' not in text and text.count("namespace cc {") == 1
    assert text.count("namespace wgs {") == 1
    out = attention_diagnose.variants(text)
    assert out["kernel"] == text and len({*out.values()}) == len(out) == 26
    assert set(attention_diagnose.EXACT) < set(out)
    for label, src in out.items():  # every other route as it is
        ns = "wgs" if label.startswith("stream:") else "cc"
        head = text.split(f"namespace {ns} {{")[0]
        tail = text.split(f"}}  // namespace {ns}")[1]
        assert src.startswith(head) and src.endswith(tail), label
    assert "__expf(" in out["fast exp"] and "kFwdTR = 8," in out["forward: 8 rows a thread"]
    assert "kFwdStages = 2;" in out["stream: forward 2 ring stages"]
    assert "kBwdWarpgroups = 2;" in out["stream: backward 2 warpgroups a CTA"]
    lane0 = out["stream: lane-0 release"]
    assert lane0.count("if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);") == 4
    assert lane0.count("mbar_init(&empty[s], 4 * nwg);") == 2
    assert "if (!kv) return;" in out["stream: dK/dV role alone"]
    assert "if (false) stream_stats<<<" in out["stream: backward without its pre-pass"]
    halves = out["stream: backward roles in two halves"]
    assert "const bool kv = (int)blockIdx.x < per;" in halves and "r < ZS" not in halves
    first = out["stream: backward first pre-pass"]
    assert "constexpr int kStatThreads = 256;" in first and "uint4 x[kPasses]" not in first
    built = out["stream: backward as first built"]
    assert "kStatThreads = 256;" in built
    assert "const bool kv = (int)blockIdx.x < per;" in built
    shapes = {s[:4]: s[4] for s in attention_diagnose.SHAPES}
    assert shapes[(8, 577, 12, 64)] == "bfloat16"  # the streamed route's shape, and its dtype
    assert shapes[(64, 197, 12, 64)] == "bfloat16"  # the main path's: the streamed backward
    assert tka.kernel_variant(torch.bfloat16, 577, 64) == "wgmma_stream"
    assert tka.kernel_variant(torch.bfloat16, 197, 64, "bwd") == "wgmma_stream"
    with pytest.raises(RuntimeError, match="found nothing"):
        attention_diagnose.variants(text.replace("acc_nn<HD>(acc, X,", "acc_nn<HD>(acc, Xs,"))
    with pytest.raises(RuntimeError, match="found nothing"):
        attention_diagnose.variants(text.replace("constexpr int kBwdStages = 3;",
                                                 "constexpr int kBwdStages = 5;"))


def test_diagnose_times_each_edit_at_its_own_variants_shapes():
    """A shape of ``attention_diagnose.SHAPES`` is timed, in each direction,
    with the kernel and the edits of the variant that direction takes: no
    ``cc`` edit at the bf16 streamed shapes, no ``wgs`` edit at the f32
    shapes, nothing for the whole-head forward at N = 197 (no edit changes
    it), and every edit at some shape."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import _build
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import attention_diagnose

    labels = list(attention_diagnose.variants(_build.inlined("attention_packed.cu")))
    timed, skipped = {}, []
    for b, n, h, hd, dtype_name in attention_diagnose.SHAPES:
        for direction in tka.DIRECTIONS:
            variant = tka.kernel_variant(getattr(torch, dtype_name), n, hd, direction)
            if variant not in attention_diagnose.NAMESPACE:
                skipped.append((n, dtype_name, direction, variant))
                continue
            timed[variant] = attention_diagnose.edits_at(labels, variant)
    assert skipped == [(197, "bfloat16", "fwd", "wgmma")]
    assert set(timed) == {"cuda_core", "wgmma_stream"}
    assert timed["wgmma_stream"][0] == timed["cuda_core"][0] == "kernel"
    assert all(label.startswith("stream:") for label in timed["wgmma_stream"][1:])
    assert not any(label.startswith("stream:") for label in timed["cuda_core"])
    assert set(timed["wgmma_stream"]) | set(timed["cuda_core"]) == set(labels)
    assert len(timed["wgmma_stream"]) == 13 and len(timed["cuda_core"]) == 14


def test_planted_faults_skip_one_block_of_the_streamed_route():
    """``chip_smoke.py --mutants`` builds ``attention_diagnose.planted_faults``:
    each changes one line inside the streamed route (namespace ``wgs``),
    skipping its fourth 64-row block in the forward's second pass, the dQ
    role or the dK/dV role, and keeps every barrier arrive (the forward's
    skipped stage is still released), so that no copy hangs."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import _build
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import attention_diagnose

    text = _build.inlined("attention_packed.cu")
    out = attention_diagnose.planted_faults(text)
    assert len(out) == 3 and len({*out.values()}) == 3
    head = text.split("namespace wgs {")[0]
    tail = text.split("}  // namespace wgs")[1]
    lines = text.splitlines()
    for label, src in out.items():
        assert src.startswith(head) and src.endswith(tail), label
        new = src.splitlines()
        assert len(new) == len(lines)
        changed = [(a, b) for a, b in zip(lines, new) if a != b]
        assert len(changed) == 1, label
        assert src.count("mbar_arrive(") == text.count("mbar_arrive("), label
    fwd, dq, dkv = out.values()
    assert "if (j == 3) release(); else by_width(j, NB, NL" in fwd
    assert "if (j != 3) by_width(j, NB, NL, [&](auto w) {\n        wg::dq_block" in dq
    assert "if (i != 3) by_width(i, NB, NL, [&](auto w) {\n        wg::dkv_block" in dkv
    with pytest.raises(RuntimeError, match="found nothing"):
        attention_diagnose.planted_faults(text.replace("wg::dq_block<", "wg::dq_blk<"))


@pytest.mark.parametrize("layout", ["packed", "head_major"])
@pytest.mark.parametrize("dtype, n, streamed", [
    (torch.bfloat16, 197, True), (torch.bfloat16, 1, True), (torch.bfloat16, 577, True),
    (torch.bfloat16, 37, False), (torch.float32, 197, False)])
def test_launch_bwd_gives_the_streamed_roles_their_scratch(monkeypatch, layout, dtype, n,
                                                           streamed):
    """``_launch_bwd`` with the library replaced by a recorder (no card here):
    wherever the backward's variant is ``"wgmma_stream"`` (bf16, hd 64, at
    ViT-B's N = 197 as past 256) the C entry gets a scratch of
    ``stream_work_floats(b, n, h)`` f32 as its 7th pointer, elsewhere a null
    one; the launch count moves once a call."""
    b, h, hd = 2, 3, 64 if dtype == torch.bfloat16 and n != 37 else 32
    seen, scratch = {}, []

    class Lib:
        def record(self, *args):
            seen["args"] = args
            return 0

        apvt_attn_packed_bwd = apvt_attn_bhnd_bwd = record

    real_empty = torch.empty

    def empty(*size, **kw):
        t = real_empty(*size, **kw)
        if kw.get("dtype") == torch.float32:
            scratch.append(t)
        return t

    monkeypatch.setattr(tka, "_lib", Lib)
    monkeypatch.setattr(tka, "_check", lambda *ts, heads: (b, n, h, hd, tka._DTYPE_CODE[dtype]))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch, "empty", empty)
    shape = (b, n, h * hd) if layout == "packed" else (b, h, n, hd)
    q, k, v, do, o = (real_empty(shape, dtype=dtype) for _ in range(5))
    lse = real_empty((b, h, n), dtype=torch.float32)
    names = ("BWD_LAUNCHES",) if layout == "packed" else ("BHND_BWD_LAUNCHES",)
    before = getattr(tka, names[0])
    if layout == "packed":
        grads = tka.fused_attention_packed_bwd(q, k, v, do, h, o, lse)
    else:
        grads = tka.fused_attention_bwd(q, k, v, do, o, lse)
    assert getattr(tka, names[0]) == before + 1
    assert [g.shape for g in grads] == [shape] * 3
    assert tka.kernel_variant(dtype, n, hd, "bwd") == ("wgmma_stream" if streamed else
                                                      tka.kernel_variant(dtype, n, hd))
    work = seen["args"][6]
    if streamed:
        assert len(scratch) == 1 and work == scratch[0].data_ptr()
        assert scratch[0].numel() == tka.stream_work_floats(b, n, h) == b * h * -(-n // 64) * 128
    else:
        assert scratch == [] and work is None


def test_streamed_backward_without_its_scratch_is_a_named_error():
    """The streamed backward's launcher returns -3 (``kNoScratch``) before any
    launch when it is given no scratch, and the wrapper names that, where a
    null ``work`` would otherwise reach the kernels as an illegal address."""
    src = open(os.path.join(REPO, "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch",
                            "csrc", "attn_stream.cuh")).read()
    launcher = src[src.index("inline int launch_bwd("):]
    assert launcher.index("if (work == nullptr) return kNoScratch;") < launcher.index("<<<")
    assert "constexpr int kNoScratch = -3;" in src
    with pytest.raises(RuntimeError, match="no scratch buffer"):
        tka._raise_on(-3, None, "attention backward")
