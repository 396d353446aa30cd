"""The port's ViT against the JAX package's ``vit.apply`` at VIT_TEST size.

Params come from JAX ``vit.init`` and cross through ``params_from_jax``;
logits must match at atol 1e-4, rtol 1e-3 (the JAX kernel's own ViT parity
tolerance).
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
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry as tregistry
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit as tvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora as tlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees as ttrees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks import common as jcommon
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import vit as jvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import lora as jlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

ATOL, RTOL = 1e-4, 1e-3
JCFG, TCFG = jvit.VIT_TEST, tvit.VIT_TEST


@pytest.fixture(scope="module")
def jparams():
    return jvit.init(jax.random.key(0), JCFG)


def _flat_np(tree):
    return {p: np.array(v) for p, v in jtrees.flatten_with_paths(tree).items()}


def _images(seed=0, b=3):
    return np.random.default_rng(seed).random((b, 32, 32, 3), dtype=np.float32)


def _adapter_np(rank=4, seed=5):
    rng = np.random.default_rng(seed)
    d, depth = JCFG.hidden_dim, JCFG.depth
    return {t: {"a": rng.standard_normal((depth, d, rank)).astype(np.float32) * 0.1,
                "b": rng.standard_normal((depth, rank, d)).astype(np.float32) * 0.1}
            for t in jvit.LORA_TARGETS_DEFAULT}


def _logits(model, x):
    with torch.no_grad():
        return tvit.apply(TCFG, model, torch.from_numpy(x)).numpy()


def test_config_fields_match_jax():
    for t, j in ((tvit.VIT_B16, jvit.VIT_B16), (tvit.VIT_TINY, jvit.VIT_TINY),
                 (tvit.VIT_TEST, jvit.VIT_TEST)):
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert (t.seq_len, t.head_dim) == (j.seq_len, j.head_dim)
    assert tvit.LORA_TARGETS_DEFAULT == jvit.LORA_TARGETS_DEFAULT


def test_logits_match_jax_plain(jparams):
    x = _images()
    model = tvit.params_from_jax(_flat_np(jparams), TCFG)
    np.testing.assert_allclose(_logits(model, x), np.asarray(jvit.apply(JCFG, jparams, x)),
                               atol=ATOL, rtol=RTOL)


def test_logits_match_jax_merged_lora(jparams):
    x = _images(1)
    ad = _adapter_np()
    jcfg = jlora.LoRAConfig(rank=4, alpha=16.0, targets=jvit.LORA_TARGETS_DEFAULT)
    tcfg = tlora.LoRAConfig(rank=4, alpha=16.0, targets=tvit.LORA_TARGETS_DEFAULT)
    jm = jlora.merge(jparams, {p: {k: jnp.asarray(v) for k, v in f.items()}
                               for p, f in ad.items()}, jcfg)
    ttree = ttrees.map_leaves(torch.from_numpy, _flat_np(jparams))
    tm = tlora.merge(ttrees.unflatten_from_paths(ttree),
                     {p: {k: torch.from_numpy(v) for k, v in f.items()} for p, f in ad.items()},
                     tcfg)
    model = tvit.params_from_jax(tm, TCFG)
    base = tvit.params_from_jax(_flat_np(jparams), TCFG)
    assert not torch.allclose(model.blocks[0].attn["q"].w, base.blocks[0].attn["q"].w)
    np.testing.assert_allclose(_logits(model, x), np.asarray(jvit.apply(JCFG, jm, x)),
                               atol=ATOL, rtol=RTOL)


def test_logits_match_jax_attached_lora(jparams):
    """The unmerged LoRA branch survives the unstacking into per-layer modules."""
    x = _images(2)
    ad = _adapter_np(rank=2, seed=6)
    jcfg = jlora.LoRAConfig(rank=2, alpha=16.0, targets=jvit.LORA_TARGETS_DEFAULT)
    tcfg = tlora.LoRAConfig(rank=2, alpha=16.0, targets=tvit.LORA_TARGETS_DEFAULT)
    ja = jlora.attach(jparams, {p: {k: jnp.asarray(v) for k, v in f.items()}
                                for p, f in ad.items()}, jcfg)
    ta = tlora.attach(ttrees.unflatten_from_paths(
        ttrees.map_leaves(torch.from_numpy, _flat_np(jparams))),
        {p: {k: torch.from_numpy(v) for k, v in f.items()} for p, f in ad.items()}, tcfg)
    model = tvit.params_from_jax(ta, TCFG)
    assert float(model.blocks[1].attn["v"].lora_s.detach()) == tcfg.scale
    np.testing.assert_allclose(_logits(model, x), np.asarray(jvit.apply(JCFG, ja, x)),
                               atol=ATOL, rtol=RTOL)


def test_logits_match_jax_pallas_kernel_path(jparams):
    """Against the JAX ``use_fused_attention`` path with the Pallas kernel
    (interpret mode; the backend is reported as "tpu" so the kernel, not the
    XLA fallback, is what runs)."""
    x = _images(3, b=2)
    fused = dataclasses.replace(JCFG, use_fused_attention=True)
    with pltpu.force_tpu_interpret_mode(), \
            mock.patch("jax.default_backend", return_value="tpu"):
        want = np.asarray(jvit.apply(fused, jparams, x))
    model = tvit.params_from_jax(_flat_np(jparams), TCFG)
    np.testing.assert_allclose(_logits(model, x), want, atol=ATOL, rtol=RTOL)


def test_image_gradient_matches_jax(jparams):
    x = _images(4, b=4)
    labels = np.array([0, 3, 7, 9], np.int32)
    norm = jcommon.IMAGENET

    def jloss(img):
        return jcommon.sum_cross_entropy(jvit.apply(JCFG, jparams, norm(img)), labels)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    model = tvit.params_from_jax(_flat_np(jparams), TCFG)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = tcommon.sum_cross_entropy(tvit.apply(TCFG, model, tcommon.IMAGENET(xt)),
                                     torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jnp.asarray(x))), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-5, rtol=1e-3)


def test_params_round_trip_identity(jparams):
    flat = _flat_np(jparams)
    back = tvit.params_to_jax(tvit.params_from_jax(flat, TCFG))
    assert set(back) == set(flat)
    for p, v in flat.items():
        assert back[p].shape == v.shape and np.array_equal(back[p].numpy(), v), p


def test_port_init_has_jax_layout():
    tree = tvit.init(TCFG, torch.Generator().manual_seed(0))
    want = {p: v.shape for p, v in jtrees.flatten_with_paths(jvit.init(jax.random.key(0), JCFG)).items()}
    got = {p: tuple(v.shape) for p, v in ttrees.flatten_with_paths(tree).items()}
    assert got == want


@pytest.mark.parametrize("name", ["google_vit", "vit_tiny", "vit_test", "dinov1"])
def test_registry_entries(name):
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import registry as jregistry

    t, j = tregistry.get_model(name), jregistry.get_model(name)
    assert t.family == j.family and t.normalization == j.normalization
    assert t.config(5) == tvit.ViTConfig(**{f.name: getattr(j.config(5), f.name)
                                            for f in dataclasses.fields(tvit.ViTConfig)})
    assert t.lora_targets(t.config(5)) == j.lora_targets(j.config(5))
    assert tregistry.get_normalization(name) == jregistry.get_normalization(name)


def test_create_model_forward():
    entry, cfg, model = tregistry.create_model("vit_test", 4, torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = entry.apply(cfg, model, torch.zeros(2, 32, 32, 3))
    assert out.shape == (2, 4) and out.dtype == torch.float32 and torch.isfinite(out).all()
