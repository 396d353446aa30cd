"""The port's ConvNeXt against the JAX package's ``convnext.apply``.

``CONVNEXT_TEST`` (32 px, depths (2, 2), dims (16, 32)). Params come from
JAX ``convnext.init`` with the layer scale redrawn in 0.1-1 and the biases
at std 0.1 (at the 1e-6 init every block is the identity and a test would
see nothing of it), and cross through ``params_from_jax``. Logits must
match at 1e-4 in f32 and 3e-2 in bf16, the image gradient of the summed
cross-entropy at 1e-4 of its largest entry. The kernel fields on the CPU
run the kernels' plain versions and must agree with the fields off, and
with the JAX Pallas kernels in interpret mode, at the JAX flag tests' 2e-2
(``fuse_ln_mlp``) and 3e-2 (``use_dw_kernel``).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import common as tcommon
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import dwconv as tdw
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import mlp as tmlp
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import convnext as tcnx
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry as tregistry
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora as tlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees as ttrees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks import common as jcommon
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import convnext as jcnx
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import registry as jregistry
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import lora as jlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

JCFG, TCFG = jcnx.CONVNEXT_TEST, tcnx.CONVNEXT_TEST
_japply = jax.jit(jcnx.apply, static_argnums=0)


@pytest.fixture(scope="module")
def flat():
    """The JAX init as numpy, layer scale in 0.1-1, biases at std 0.1."""
    params = jax.jit(jcnx.init, static_argnums=1)(jax.random.key(0), JCFG)
    out = {p: np.array(v) for p, v in jtrees.flatten_with_paths(params).items()}
    rng = np.random.default_rng(0)
    for p, v in out.items():
        if p.endswith("gamma"):
            out[p] = rng.uniform(0.1, 1.0, v.shape).astype(np.float32)
        elif p.rsplit("/", 1)[-1] in ("b", "bias"):
            out[p] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return out


def _jparams(flat):
    return jtrees.unflatten_from_paths({p: jnp.asarray(v) for p, v in flat.items()})


def _ttree(flat):
    return ttrees.unflatten_from_paths({p: torch.from_numpy(v) for p, v in flat.items()})


def _images(seed=0, b=2):
    return np.random.default_rng(seed).random((b, 32, 32, 3), dtype=np.float32)


def _logits(cfg, model, x):
    with torch.no_grad():
        return tcnx.apply(cfg, model, torch.from_numpy(x)).numpy()


def _cfgs(**fields):
    return dataclasses.replace(JCFG, **fields), dataclasses.replace(TCFG, **fields)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_logits_match_jax(flat, dtype, tol):
    jcfg, tcfg = _cfgs(compute_dtype=dtype)
    x = _images()
    got = _logits(tcfg, tcnx.params_from_jax(flat, tcfg), x)
    assert got.shape == (2, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(_japply(jcfg, _jparams(flat), x)),
                               atol=tol, rtol=tol)


def test_features_match_jax(flat):
    x = _images(1)
    model = tcnx.params_from_jax(flat, TCFG)
    with torch.no_grad():
        got = tcnx.features(TCFG, model, torch.from_numpy(x)).numpy()
    want = np.asarray(jcnx.features(JCFG, _jparams(flat), x))
    assert got.shape == want.shape == (2, 4, 4, 32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_image_gradient_matches_jax(flat):
    x = _images(4, b=3)
    labels = np.array([0, 3, 1], np.int32)
    jparams = _jparams(flat)

    def jloss(img):
        return jcommon.sum_cross_entropy(jcnx.apply(JCFG, jparams, jcommon.IMAGENET(img)), labels)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))
    model = tcnx.params_from_jax(flat, TCFG)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = tcommon.sum_cross_entropy(tcnx.apply(TCFG, model, tcommon.IMAGENET(xt)),
                                     torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jnp.asarray(x))), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("field,tol", [("fuse_ln_mlp", 2e-2), ("use_dw_kernel", 3e-2)])
def test_kernel_field_on_the_cpu_matches_field_off_and_jax_pallas(flat, field, tol):
    """bf16 on the CPU: the field routes the block through the kernel's wrapper
    (spied), whose plain version agrees with the library composition and
    with the JAX model running its Pallas kernel in interpret mode."""
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    x = _images(2)
    off = _logits(tcfg, tcnx.params_from_jax(flat, tcfg), x)
    on_cfg = dataclasses.replace(tcfg, **{field: True})
    calls = []
    target = (tmlp._LnMlp if field == "fuse_ln_mlp" else tdw._DwConv7)
    with mock.patch.object(target, "forward", staticmethod(
            lambda ctx, *a, _f=target.forward: (calls.append(1), _f(ctx, *a))[1])):
        on = _logits(on_cfg, tcnx.params_from_jax(flat, on_cfg), x)
    assert len(calls) == sum(tcfg.depths), "the field did not route every block to the wrapper"
    np.testing.assert_allclose(on, off, atol=tol, rtol=tol)
    with pltpu.force_tpu_interpret_mode(), \
            mock.patch.object(jax, "default_backend", return_value="tpu"):
        want = np.asarray(jcnx.apply(dataclasses.replace(jcfg, **{field: True}),
                                     _jparams(flat), x))
    np.testing.assert_allclose(on, want, atol=tol, rtol=tol)


def test_kernel_fields_do_nothing_in_f32(flat):
    x = _images(3)
    on_cfg = dataclasses.replace(TCFG, fuse_ln_mlp=True, use_dw_kernel=True)
    with mock.patch.object(tmlp, "ln_mlp", side_effect=AssertionError("ln_mlp in f32")), \
            mock.patch.object(tcnx, "dwconv7", side_effect=AssertionError("dwconv7 in f32")):
        on = _logits(on_cfg, tcnx.params_from_jax(flat, on_cfg), x)
    np.testing.assert_array_equal(on, _logits(TCFG, tcnx.params_from_jax(flat, TCFG), x))


def test_both_fields_image_gradient_on_the_cpu(flat):
    """bf16, both fields on: the backward runs the wrappers' CPU routes (dx
    only: no filter or parameter gradient) and agrees with the fields off."""
    _, tcfg = _cfgs(compute_dtype="bfloat16")
    on_cfg = dataclasses.replace(tcfg, fuse_ln_mlp=True, use_dw_kernel=True)
    x = _images(5)
    labels = torch.tensor([1, 2])
    grads = {}
    before = (tdw.DW_CALLS, tmlp.PARAM_GRAD_CALLS)
    for name, cfg in (("off", tcfg), ("on", on_cfg)):
        model = tcnx.params_from_jax(flat, cfg).requires_grad_(False)
        xt = torch.from_numpy(x).requires_grad_(True)
        tcommon.sum_cross_entropy(tcnx.apply(cfg, model, tcommon.IMAGENET(xt)), labels).backward()
        grads[name] = xt.grad.numpy()
    assert (tdw.DW_CALLS, tmlp.PARAM_GRAD_CALLS) == before
    scale = np.abs(grads["off"]).max()
    assert np.abs(grads["on"] - grads["off"]).max() <= 5e-2 * scale


def _adapter_np(flat, rank=4, seed=5):
    rng = np.random.default_rng(seed)
    out = {}
    for path in jcnx.lora_target_paths(JCFG):
        *lead, di, do = flat[f"{path}/w"].shape
        out[path] = {"a": rng.standard_normal((*lead, di, rank)).astype(np.float32) * 0.1,
                     "b": rng.standard_normal((*lead, rank, do)).astype(np.float32) * 0.1}
    return out


@pytest.mark.parametrize("form", ["merged", "attached"])
def test_logits_match_jax_with_lora(flat, form):
    x = _images(1)
    ad = _adapter_np(flat)
    targets = jcnx.lora_target_paths(JCFG)
    assert targets == tcnx.lora_target_paths(TCFG)
    jlc = jlora.LoRAConfig(rank=4, alpha=16.0, targets=targets)
    tlc = tlora.LoRAConfig(rank=4, alpha=16.0, targets=targets)
    jad = {p: {k: jnp.asarray(v) for k, v in f.items()} for p, f in ad.items()}
    tad = {p: {k: torch.from_numpy(v) for k, v in f.items()} for p, f in ad.items()}
    op_j, op_t = (jlora.merge, tlora.merge) if form == "merged" else (jlora.attach, tlora.attach)
    ttree = op_t(_ttree(flat), tad, tlc)
    if form == "merged":
        want_w = np.asarray(jtrees.get_path(op_j(_jparams(flat), jad, jlc), targets[1])["w"])
        np.testing.assert_allclose(ttrees.get_path(ttree, targets[1])["w"].numpy(), want_w,
                                   atol=1e-6, rtol=1e-6)
    model = tcnx.params_from_jax(ttree, TCFG)
    blk = model.stages[1].blocks[1].pwconv1
    if form == "attached":
        assert float(blk.lora_s.detach()) == tlc.scale and blk.lora_a.shape == (32, 4)
    np.testing.assert_allclose(_logits(TCFG, model, x),
                               np.asarray(_japply(JCFG, op_j(_jparams(flat), jad, jlc), x)),
                               atol=1e-4, rtol=1e-3)


def test_unmerged_lora_takes_the_plain_tail_even_with_fuse_ln_mlp(flat):
    """bf16, ``fuse_ln_mlp`` on, factors attached: the fused wrapper is not
    called (it has no LoRA branch) and the logits equal the field-off ones."""
    _, tcfg = _cfgs(compute_dtype="bfloat16")
    on_cfg = dataclasses.replace(tcfg, fuse_ln_mlp=True)
    tlc = tlora.LoRAConfig(rank=4, alpha=16.0, targets=tcnx.lora_target_paths(tcfg))
    tad = {p: {k: torch.from_numpy(v) for k, v in f.items()} for p, f in _adapter_np(flat).items()}
    tree = tlora.attach(_ttree(flat), tad, tlc)
    x = _images(6)
    with mock.patch.object(tmlp, "ln_mlp", side_effect=AssertionError("fused tail with LoRA")):
        on = _logits(on_cfg, tcnx.params_from_jax(tree, on_cfg), x)
    np.testing.assert_array_equal(on, _logits(tcfg, tcnx.params_from_jax(tree, tcfg), x))


def test_params_round_trip_identity(flat):
    back = tcnx.params_to_jax(tcnx.params_from_jax(flat, TCFG))
    assert set(back) == set(flat)
    for p, v in flat.items():
        assert back[p].shape == v.shape and np.array_equal(back[p].numpy(), v), p


def test_port_init_has_jax_layout(flat):
    tree = tcnx.init(TCFG, torch.Generator().manual_seed(0))
    got = {p: tuple(v.shape) for p, v in ttrees.flatten_with_paths(tree).items()}
    assert got == {p: v.shape for p, v in flat.items()}
    assert float(tree["stages"]["0"]["blocks"]["gamma"][0, 0]) == pytest.approx(1e-6)
    assert tuple(tree["stages"]["1"]["blocks"]["dwconv"]["w"].shape) == (2, 7, 7, 1, 32)


def test_config_fields_match_jax():
    for t, j in ((tcnx.CONVNEXT_B, jcnx.CONVNEXT_B), (tcnx.CONVNEXT_T, jcnx.CONVNEXT_T),
                 (tcnx.CONVNEXT_TEST, jcnx.CONVNEXT_TEST)):
        assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert tcnx.lora_target_paths(t) == jcnx.lora_target_paths(j)
    assert not tcnx.CONVNEXT_B.use_dw_kernel and not tcnx.CONVNEXT_B.fuse_ln_mlp
    assert tcnx.CONVNEXT_B.dims == (128, 256, 512, 1024)
    assert all(d in tmlp.KERNEL_DIMS for d in tcnx.CONVNEXT_B.dims)


@pytest.mark.parametrize("name", ["convnext", "convnext_test"])
def test_registry_entries(name):
    t, j = tregistry.get_model(name), jregistry.get_model(name)
    assert t.family == j.family == "convnext" and t.normalization == j.normalization
    assert t.config(5) == tcnx.ConvNeXtConfig(**{f.name: getattr(j.config(5), f.name)
                                                 for f in dataclasses.fields(tcnx.ConvNeXtConfig)})
    assert t.lora_targets(t.config(5)) == j.lora_targets(j.config(5))


def test_create_model_forward():
    entry, cfg, model = tregistry.create_model("convnext_test", 4, torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = entry.apply(cfg, model, torch.zeros(2, 32, 32, 3))
    assert out.shape == (2, 4) and out.dtype == torch.float32 and torch.isfinite(out).all()
