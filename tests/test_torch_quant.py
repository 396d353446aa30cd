"""The port's W8A8 path (``ops/quant.py``, ``ops/nn.dense``'s ``w_q``
branch, the models' kernel gates) against the JAX package's.

The int8 operands, the int32 products, f32 division and round-half-even are
exact in both packages, so the op-level checks demand equality. Quantized
``VIT_TEST`` logits are held within 1e-3 x max|logit|: a row whose f32
activations differ in the last bit between the two frameworks may land on
the other side of an int8 rounding boundary. Mirrors of the JAX package's
``tests/test_quant.py`` follow, then the gate repair: a quantized tree with
a kernel field on must take the int8 dense path, bit for bit the fields-off
logits (before the repair the fused paths indexed ``fc1["w"]`` and raised
``KeyError``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import common as tcommon
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import whitebox as twb
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry as treg
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit as tvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora as tlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import nn as tnn
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import quant as tq
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import checkpoint as tck
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees as ttrees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import vit as jvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import lora as jlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import nn as jnn
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import quant as jq
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import checkpoint as jck
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

IDENT = tcommon.Normalizer((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (pytest-xdist workers share
    the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


def _jax_bf16(a: np.ndarray):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _torch_tree(jtree) -> dict:
    """A JAX tree (f32 / int8 leaves) -> nested dict of CPU tensors."""
    flat = jtrees.flatten_with_paths(jtree)
    return ttrees.unflatten_from_paths({p: torch.from_numpy(np.array(v)) for p, v in flat.items()})


def _assert_trees_equal(jtree, ttree):
    jf, tf = jtrees.flatten_with_paths(jtree), ttrees.flatten_with_paths(ttree)
    assert set(jf) == set(tf)
    for p in jf:
        a, b = np.asarray(jf[p]), tf[p].numpy()
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b, err_msg=p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(48, 80), (3, 48, 80)], ids=["2d", "stacked"])
def test_quantize_weight_equals_jax(shape, dtype):
    w = (np.random.default_rng(0).standard_normal(shape) * 0.2).astype(np.float32)
    w[..., 5] = 0.0  # an all-zero output channel takes the 1e-12 floor
    jw = jnp.asarray(w) if dtype == "float32" else _jax_bf16(w)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jw_q, jw_s = jq.quantize_weight(jw)
    tw_q, tw_s = tq.quantize_weight(tw)
    assert tw_q.dtype == torch.int8 and tw_s.dtype == torch.float32
    assert tw_s.shape == shape[:-2] + shape[-1:]
    np.testing.assert_array_equal(np.asarray(jw_q), tw_q.numpy())
    np.testing.assert_array_equal(np.asarray(jw_s), tw_s.numpy())


# (x shape, in, out): the ViT-like case, then one that misses every cuBLASLt
# limit (M <= 16, K and N not multiples of 8), which int_mm pads
MATMUL_CASES = [((2, 50, 64), 64, 96), ((5, 50), 50, 36)]


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xs,d_in,d_out", MATMUL_CASES, ids=["vit_like", "padded"])
def test_int8_matmul_forward_and_dx_equal_jax_vjp(xs, d_in, d_out, x_dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal((d_in, d_out)) * d_in ** -0.5).astype(np.float32)
    g = rng.standard_normal(xs[:-1] + (d_out,)).astype(np.float32)
    w_q, w_s = jq.quantize_weight(jnp.asarray(w))
    jx = jnp.asarray(x) if x_dtype == "float32" else _jax_bf16(x)
    y, vjp = jax.vjp(lambda v: jq.int8_matmul(v, w_q, w_s), jx)
    (dx,) = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).to(getattr(torch, x_dtype)).requires_grad_()
    ty = tq.int8_matmul(tx, torch.from_numpy(np.array(w_q)), torch.from_numpy(np.array(w_s)))
    (tdx,) = torch.autograd.grad(ty, tx, torch.from_numpy(g))
    assert ty.dtype == torch.float32 and tdx.dtype == tx.dtype
    np.testing.assert_array_equal(np.asarray(y), _np(ty))
    np.testing.assert_array_equal(np.asarray(dx.astype(jnp.float32)), _np(tdx))


def test_int_mm_pads_to_an_exact_product():
    rng = np.random.default_rng(2)
    for m, k, n in ((1, 3, 5), (16, 8, 8), (17, 9, 7), (40, 64, 33)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
        want = (a.long() @ b.long()).int()
        for bb in (b, b.t().contiguous().t()):  # row-major and column-major b
            got = tq.int_mm(a, bb)
            assert got.dtype == torch.int32 and torch.equal(got, want), (m, k, n)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_dense_with_w_q_equals_jax(compute):
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((48, 80)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(80) * 0.1).astype(np.float32)
    x = rng.standard_normal((6, 48)).astype(np.float32)
    w_q, w_s = jq.quantize_weight(jnp.asarray(w))
    jp = {"w_q": w_q, "w_s": w_s, "b": jnp.asarray(b)}
    cd = getattr(jnp, compute)
    got_j = jnn.dense(jp, jnp.asarray(x), compute_dtype=cd)
    tp = {"w_q": torch.from_numpy(np.array(w_q)), "w_s": torch.from_numpy(np.array(w_s)),
          "b": torch.from_numpy(b)}
    got_t = tnn.dense(tp, torch.from_numpy(x), compute_dtype=getattr(torch, compute))
    assert got_t.dtype == getattr(torch, compute)
    np.testing.assert_array_equal(np.asarray(got_j.astype(jnp.float32)), _np(got_t).astype(np.float32))
    # and within the W8A8 budget of the float dense (the JAX test's 2%)
    ref = tnn.dense({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x))
    assert float((got_t.float() - ref).abs().max()) <= 0.02 * float(ref.abs().max())


@pytest.fixture(scope="module")
def vit_trees():
    """(JAX tree, JAX quantized tree, port tree, port quantized tree) of VIT_TEST."""
    params = jvit.init(jax.random.key(0), jvit.VIT_TEST)
    tparams = _torch_tree(params)
    return (params, jq.quantize_dense_tree(params, jvit.QUANT_TARGETS_DEFAULT), tparams,
            tq.quantize_dense_tree(tparams, tvit.QUANT_TARGETS_DEFAULT))


def test_quant_targets_default_matches_jax():
    assert tvit.QUANT_TARGETS_DEFAULT == jvit.QUANT_TARGETS_DEFAULT
    assert tq.QUANT_SKIP_KEYS == jq.QUANT_SKIP_KEYS


def test_quantize_dense_tree_equals_jax(vit_trees):
    _, jqp, _, tqp = vit_trees
    _assert_trees_equal(jqp, tqp)
    assert tqp["blocks"]["mlp"]["fc1"]["w_q"].shape == (2, 64, 128)
    assert tqp["blocks"]["mlp"]["fc1"]["w_s"].shape == (2, 128)


def test_quantize_dense_tree_raises_as_jax():
    params = jvit.init(jax.random.key(0), jvit.VIT_TEST)
    tparams = _torch_tree(params)
    msgs = []
    for mod, p in ((jq, params), (tq, tparams)):
        with pytest.raises(KeyError, match="no leaf") as e:
            mod.quantize_dense_tree(p, ("blocks/nope",))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]

    targets = jvit.LORA_TARGETS_DEFAULT
    jl = jlora.LoRAConfig(rank=4, alpha=8.0, targets=targets)
    tl = tlora.LoRAConfig(rank=4, alpha=8.0, targets=targets)
    jad = jlora.init(jax.random.key(1), params, jl)
    tad = {p: {k: torch.from_numpy(np.array(v)) for k, v in f.items()} for p, f in jad.items()}
    msgs = []
    for mod, tree in ((jq, jlora.attach(params, jad, jl)), (tq, tlora.attach(tparams, tad, tl))):
        with pytest.raises(ValueError, match="unmerged LoRA") as e:
            mod.quantize_dense_tree(tree, jvit.QUANT_TARGETS_DEFAULT)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # a merged tree quantizes and runs
    qp = tq.quantize_dense_tree(tlora.merge(tparams, tad, tl), tvit.QUANT_TARGETS_DEFAULT)
    out = tvit.params_from_jax(qp, tvit.VIT_TEST)(torch.zeros(1, 32, 32, 3))
    assert out.shape == (1, tvit.VIT_TEST.num_classes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantized_vit_logits_close_to_jax(seed):
    # observed on this CPU: max |diff| 7.2e-7 against max |logit| 2.53 (seed 2)
    params = jvit.init(jax.random.key(seed), jvit.VIT_TEST)
    jqp = jq.quantize_dense_tree(params, jvit.QUANT_TARGETS_DEFAULT)
    tqp = tq.quantize_dense_tree(_torch_tree(params), tvit.QUANT_TARGETS_DEFAULT)
    x = np.random.default_rng(seed).random((4, 32, 32, 3), dtype=np.float32)
    want = np.asarray(jvit.apply(jvit.VIT_TEST, jqp, jnp.asarray(x)))
    with torch.no_grad():
        got = tvit.params_from_jax(tqp, tvit.VIT_TEST)(torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) <= 1e-3 * float(np.abs(want).max())


def _input_grad(model, x, labels):
    x = x.clone().requires_grad_()
    (g,) = torch.autograd.grad(tcommon.sum_cross_entropy(model(x), labels), x)
    return g


def test_quantized_grad_sign_agreement(vit_trees):
    _, _, tp, tqp = vit_trees
    cfg = tvit.VIT_TEST
    x = torch.from_numpy(np.random.default_rng(4).random((4, 32, 32, 3), dtype=np.float32))
    labels = torch.arange(4) % cfg.num_classes
    gf = _input_grad(tvit.params_from_jax(tp, cfg), x, labels)
    gq = _input_grad(tvit.params_from_jax(tqp, cfg), x, labels)
    agree = float((torch.sign(gf) == torch.sign(gq)).float().mean())
    assert agree > 0.95, f"sign agreement {agree:.3f}"


def test_pgd_on_quantized_tree_invariants(vit_trees):
    cfg = tvit.VIT_TEST
    model = tvit.params_from_jax(vit_trees[3], cfg)
    x = torch.from_numpy(np.random.default_rng(5).random((4, 32, 32, 3), dtype=np.float32))
    run = twb.make_pgd(tvit.apply, cfg, eps=8 / 255, alpha=3 / 255, steps=3, normalize=IDENT)
    adv = run(model, x, torch.zeros(4, dtype=torch.long), torch.Generator().manual_seed(6))
    assert bool(torch.isfinite(adv).all())
    assert float((adv - x).abs().max()) <= 8 / 255 + 1e-6
    assert float(adv.min()) >= 0.0 and float(adv.max()) <= 1.0
    assert float((adv - x).abs().max()) > 1e-4  # moved
    # the int8 leaves stay frozen, w_s's flag comes back
    assert not model.blocks[0].attn.q.w_q.requires_grad and model.blocks[0].attn.q.w_s.requires_grad


def test_int8_leaves_survive_the_module_boundary(vit_trees, tmp_path):
    """w_q through params_from_jax / params_to_jax, model.to(bfloat16), and
    the checkpoint writers of both packages in both directions."""
    _, jqp, _, tqp = vit_trees
    model = tvit.params_from_jax(tqp, tvit.VIT_TEST)
    back = tvit.params_to_jax(model)
    _assert_trees_equal(jqp, ttrees.unflatten_from_paths(back))
    model.to(torch.bfloat16)
    assert model.blocks[1].mlp.fc2.w_q.dtype == torch.int8
    assert torch.equal(model.blocks[1].mlp.fc2.w_q, tqp["blocks"]["mlp"]["fc2"]["w_q"][1])
    assert model.blocks[1].mlp.fc2.w_s.dtype == torch.bfloat16

    jck.save_pytree(jqp, str(tmp_path / "jax.safetensors"), meta={"model": "vit_test"})
    loaded, meta = tck.load_pytree(str(tmp_path / "jax.safetensors"))
    assert meta == {"model": "vit_test"}
    _assert_trees_equal(jqp, loaded)
    tck.save_pytree(tqp, str(tmp_path / "port.safetensors"))
    jloaded, _ = jck.load_pytree(str(tmp_path / "port.safetensors"))
    _assert_trees_equal(jloaded, tqp)


def _bf16_tree(tree):
    return ttrees.map_leaves(lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, tree)


# (registry name, quantize targets from the cfg, the kernel fields to hold against fields off)
GATES = [("vit_test", lambda cfg: tvit.QUANT_TARGETS_DEFAULT,
          ("fuse_attn_block", "fuse_ln_mlp", "use_fused_mlp")),
         ("swin_test", lambda cfg: tuple(f"stages/{s}/blocks/mlp/{f}"
                                         for s in range(len(cfg.depths)) for f in ("fc1", "fc2")),
          ("use_fused_mlp",)),
         ("convnext_test", lambda cfg: tuple(f"stages/{s}/blocks/{f}" for s in range(len(cfg.depths))
                                             for f in ("pwconv1", "pwconv2")),
          ("fuse_ln_mlp",))]


@pytest.mark.parametrize("name,targets,fields", GATES, ids=[g[0] for g in GATES])
def test_quantized_tree_bypasses_the_fused_kernels(name, targets, fields):
    entry = treg.get_model(name)
    cfg = dataclasses.replace(entry.config(4), compute_dtype="bfloat16")
    tree = tq.quantize_dense_tree(entry.init(cfg, torch.Generator().manual_seed(0)), targets(cfg))
    tree = _bf16_tree(tree)
    x = torch.from_numpy(np.random.default_rng(7).random(
        (2, cfg.image_size, cfg.image_size, 3), dtype=np.float32))
    with torch.no_grad():
        want = entry.apply(cfg, entry.from_tree(tree, cfg), x)
        for field in fields:
            fcfg = dataclasses.replace(cfg, **{field: True})
            got = entry.apply(fcfg, entry.from_tree(tree, fcfg), x)
            assert torch.equal(got, want), field
