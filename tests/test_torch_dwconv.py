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


# --- which device code, and the bf16 kernel's tiles and persistent schedule ---

STAGES = [(64, 56, 56, 128), (64, 28, 28, 256), (64, 14, 14, 512), (64, 7, 7, 1024)]
EDGES = [(3, 1, 1, 8), (2, 57, 55, 72), (5, 15, 13, 136), (65, 7, 7, 1032), (64, 14, 14, 520),
         (2, 10, 9, 8)]


@pytest.mark.parametrize("shape", STAGES + EDGES)
def test_kernel_variant_by_dtype(shape):
    assert tdw.kernel_variant(torch.bfloat16, shape) == "tma_ring"
    assert tdw.kernel_variant(torch.float32, shape) == "staged"


@pytest.mark.parametrize("dtype,shape,err", [
    (torch.float16, (2, 5, 5, 8), TypeError), (torch.bfloat16, (2, 5, 5, 12), ValueError),
    (torch.bfloat16, (5, 5, 8), ValueError), (torch.bfloat16, (0, 5, 5, 8), ValueError)])
def test_kernel_variant_refuses(dtype, shape, err):
    with pytest.raises(err):
        tdw.kernel_variant(dtype, shape)


def test_kernel_wrapper_refuses_a_dtype_before_any_build():
    with pytest.raises(TypeError):
        tdw.fused_dwconv7_fwd(torch.zeros(1, 4, 4, 8, dtype=torch.float16), torch.zeros(7, 7, 8))


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("shape", STAGES + EDGES)
def test_schedule_covers_every_output_once(shape, sms):
    """Every (b, h, w, channel chunk) is computed by exactly one block of one
    work item of one persistent CTA, and the items of the CTAs are exactly
    all items, each once."""
    plan = tdw.kernel_plan(shape, sms)
    b, h, w, c = shape
    hits = np.zeros((b, h, w, plan["chunks"]), np.int32)
    seen = []
    for cta in range(plan["grid"]):
        for i in tdw.cta_items(plan, cta):
            seen.append(i)
            c0, bi, h0, w0 = tdw.decode_item(plan, shape, i)
            assert c0 < c and 0 <= h0 < h and 0 <= w0 < w
            for r0, rows, s0, cols in tdw.item_blocks(plan, shape, h0, w0):
                assert 1 <= rows <= plan["block_rows"] and 1 <= cols <= tdw.BLOCK_COLS
                hits[bi, h0 + r0:h0 + r0 + rows, w0 + s0:w0 + s0 + cols, c0 // tdw.CHUNK] += 1
                # the block's TMA store writes block_rows x 7 pixels; what of
                # them lies inside the image lies inside this tile
                th, tw = plan["tile"]
                assert min(h0 + r0 + plan["block_rows"], h) <= h0 + th
                assert min(w0 + s0 + tdw.BLOCK_COLS, w) <= w0 + tw
    assert seen == list(range(plan["items"]))
    assert (hits == 1).all()


@pytest.mark.parametrize("shape", STAGES + EDGES)
def test_warps_take_each_block_once_round_robin(shape):
    """The kernel's assignment of blocks to its 8 warps (block k of an item
    to warp (base + k) mod 8, base the CTA's earlier blocks): each block one
    warp, and the warps' counts within one block of each other per CTA."""
    plan = tdw.kernel_plan(shape)
    for cta in range(plan["grid"]):
        base, load = 0, [0] * tdw.COMPUTE_WARPS
        for i in tdw.cta_items(plan, cta):
            _, _, h0, w0 = tdw.decode_item(plan, shape, i)
            blocks = len(tdw.item_blocks(plan, shape, h0, w0))
            owners = []
            for warp in range(tdw.COMPUTE_WARPS):
                k = (warp - base) % tdw.COMPUTE_WARPS
                owners += [warp] * len(range(k, blocks, tdw.COMPUTE_WARPS))
                load[warp] += len(range(k, blocks, tdw.COMPUTE_WARPS))
            assert len(owners) == blocks
            base = (base + blocks) % tdw.COMPUTE_WARPS
        assert max(load) - min(load) <= 1


def test_stage_plans():
    """The ConvNeXt-B stages on the H100's 132 SMs: 14 x 28 tiles at stages 1
    and 2, the whole map at 3 and 4 (blocks of two rows, of one in the 7 x 7
    map), a ring of two or more slots within the CTA's shared memory, and at
    least two items per SM."""
    tiles = [(14, 28), (14, 28), (14, 14), (7, 7)]
    for shape, tile, rows in zip(STAGES, tiles, (2, 2, 2, 1)):
        plan = tdw.kernel_plan(shape)
        assert plan["tile"] == tile and plan["block_rows"] == rows
        assert plan["slots"] >= 2 and plan["smem"] <= tdw.SMEM_MAX
        assert plan["items"] >= 2 * tdw.H100_SMS and plan["grid"] == tdw.H100_SMS


def test_diagnose_script_edits_find_their_places():
    """``tools/dwconv_diagnose`` times edited copies of ``csrc/dwconv7.cu``;
    each edit must still find its place in the source (it raises otherwise)."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import _build
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import dwconv_diagnose

    text = _build.inlined("dwconv7.cu")
    assert '#include "' not in text and text.count("namespace sm90 {") == 1
    out = dwconv_diagnose.variants(text)
    assert out["kernel"] == text and len({*out.values()}) == len(out) == 9
    assert set(dwconv_diagnose.EXACT) < set(out)
    assert "tma_store_4d(&omap" not in out["stores from registers"]
    assert "kMaxRows = 4;" in out["4-row blocks, stores from registers"]
    assert "kWarps = 12;" in out["1-row blocks, 12 warps"]
    assert "mbar_arrive(&full[slot]);" in out["no loads after the first"]
    with pytest.raises(RuntimeError, match="found nothing"):
        dwconv_diagnose.variants(text.replace("conv_rows<ROWS>(rows - r0", "conv_rows<ROWS>(r0"))
