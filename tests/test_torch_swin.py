"""The port's Swin against the JAX package's ``swin.apply``.

Two small configs: ``SWIN_TEST`` (window 4, hd 16, n = 16) and a window-7,
hd-32 config (56 px, embed 64, depths (2, 2), heads (2, 4)) that has the
Swin-B window (n = 49) and the shift-3 mask. Params come from JAX
``swin.init`` and cross through ``params_from_jax``; logits must match at
atol 1e-4, rtol 1e-3 and image gradients at atol 1e-5, rtol 1e-3 (the ViT
parity tolerances), all in f32.
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
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import swin as tswin
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora as tlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees as ttrees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks import common as jcommon
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import swin as jswin
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import lora as jlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

ATOL, RTOL = 1e-4, 1e-3
W7 = dict(image_size=56, window=7, embed_dim=64, depths=(2, 2), num_heads=(2, 4),
          num_classes=5, compute_dtype="float32")
_japply = jax.jit(jswin.apply, static_argnums=0)
CONFIGS = {"swin_test": (jswin.SWIN_TEST, tswin.SWIN_TEST),
           "window7": (jswin.SwinConfig(**W7), tswin.SwinConfig(**W7))}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    jcfg, tcfg = CONFIGS[request.param]
    return jcfg, tcfg, jax.jit(jswin.init, static_argnums=1)(jax.random.key(0), jcfg)


def _flat_np(tree):
    return {p: np.array(v) for p, v in jtrees.flatten_with_paths(tree).items()}


def _images(cfg, seed=0, b=2):
    return np.random.default_rng(seed).random((b, cfg.image_size, cfg.image_size, 3),
                                              dtype=np.float32)


def _adapter_np(jcfg, params, rank=4, seed=5):
    rng = np.random.default_rng(seed)
    out = {}
    for path in jswin.lora_target_paths(jcfg):
        *lead, di, do = jtrees.get_path(params, path)["w"].shape
        out[path] = {"a": rng.standard_normal((*lead, di, rank)).astype(np.float32) * 0.1,
                     "b": rng.standard_normal((*lead, rank, do)).astype(np.float32) * 0.1}
    return out


def _logits(tcfg, model, x):
    with torch.no_grad():
        return tswin.apply(tcfg, model, torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("res,window", [(8, 4), (4, 4), (14, 7), (56, 7), (28, 7)])
def test_static_helpers_equal_jax(res, window):
    np.testing.assert_array_equal(tswin._rel_pos_index(window), jswin._rel_pos_index(window))
    np.testing.assert_array_equal(tswin._window_layout_order(res, window),
                                  jswin._window_layout_order(res, window))
    if res > window:
        for t, j in zip(tswin._shift_perms(res, window, window // 2),
                        jswin._shift_perms(res, window, window // 2)):
            np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(tswin._shift_attn_mask(res, window, window // 2),
                                      jswin._shift_attn_mask(res, window, window // 2))


def test_config_fields_match_jax():
    for t, j in ((tswin.SWIN_B, jswin.SWIN_B), (tswin.SWIN_T, jswin.SWIN_T),
                 (tswin.SWIN_TEST, jswin.SWIN_TEST)):
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert [t.stage_dim(s) for s in range(t.num_stages)] == \
               [j.stage_dim(s) for s in range(j.num_stages)]
        assert tswin.lora_target_paths(t) == jswin.lora_target_paths(j)


def test_logits_match_jax(setup):
    jcfg, tcfg, jparams = setup
    x = _images(jcfg)
    model = tswin.params_from_jax(_flat_np(jparams), tcfg)
    np.testing.assert_allclose(_logits(tcfg, model, x), np.asarray(_japply(jcfg, jparams, x)),
                               atol=ATOL, rtol=RTOL)


def test_features_match_jax(setup):
    """The module-level ``features`` (final-norm tokens) against JAX's."""
    jcfg, tcfg, jparams = setup
    x = _images(jcfg, 6)
    model = tswin.params_from_jax(_flat_np(jparams), tcfg)
    with torch.no_grad():
        got = tswin.features(tcfg, model, torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jswin.features, static_argnums=0)(jcfg, jparams, x))
    res = jcfg.stage_res(jcfg.num_stages - 1)
    assert got.shape == want.shape == (2, res * res, jcfg.stage_dim(jcfg.num_stages - 1))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_logits_match_jax_pallas_kernel_path(setup):
    """Against the JAX ``use_fused_attention`` path with the Pallas window
    kernel (interpret mode; the backend is reported as "tpu")."""
    jcfg, tcfg, jparams = setup
    x = _images(jcfg, 3)
    fused = dataclasses.replace(jcfg, use_fused_attention=True)
    with pltpu.force_tpu_interpret_mode(), \
            mock.patch("jax.default_backend", return_value="tpu"):
        want = np.asarray(jswin.apply(fused, jparams, x))
    model = tswin.params_from_jax(_flat_np(jparams), tcfg)
    np.testing.assert_allclose(_logits(tcfg, model, x), want, atol=ATOL, rtol=RTOL)


def test_image_gradient_matches_jax(setup):
    jcfg, tcfg, jparams = setup
    x = _images(jcfg, 4, b=3)
    labels = np.array([0, 3, 1], np.int32)
    norm = jcommon.IMAGENET

    def jloss(img):
        return jcommon.sum_cross_entropy(jswin.apply(jcfg, jparams, norm(img)), labels)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))
    model = tswin.params_from_jax(_flat_np(jparams), tcfg)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = tcommon.sum_cross_entropy(tswin.apply(tcfg, model, tcommon.IMAGENET(xt)),
                                     torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jnp.asarray(x))), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-5, rtol=1e-3)


@pytest.mark.parametrize("form", ["merged", "attached"])
def test_logits_match_jax_with_lora(setup, form):
    jcfg, tcfg, jparams = setup
    x = _images(jcfg, 1)
    ad = _adapter_np(jcfg, jparams)
    targets = jswin.lora_target_paths(jcfg)
    jlc = jlora.LoRAConfig(rank=4, alpha=16.0, targets=targets)
    tlc = tlora.LoRAConfig(rank=4, alpha=16.0, targets=targets)
    jad = {p: {k: jnp.asarray(v) for k, v in f.items()} for p, f in ad.items()}
    tad = {p: {k: torch.from_numpy(v) for k, v in f.items()} for p, f in ad.items()}
    ttree = ttrees.unflatten_from_paths(ttrees.map_leaves(torch.from_numpy, _flat_np(jparams)))
    op_j, op_t = (jlora.merge, tlora.merge) if form == "merged" else (jlora.attach, tlora.attach)
    model = tswin.params_from_jax(op_t(ttree, tad, tlc), tcfg)
    blk = model.stages[1].blocks[1].attn["qkv"]
    if form == "attached":
        assert float(blk.lora_s.detach()) == tlc.scale and blk.lora_a.shape[-1] == 4
    else:
        base = tswin.params_from_jax(_flat_np(jparams), tcfg)
        assert not torch.allclose(blk.w, base.stages[1].blocks[1].attn["qkv"].w)
    np.testing.assert_allclose(_logits(tcfg, model, x),
                               np.asarray(_japply(jcfg, op_j(jparams, jad, jlc), x)),
                               atol=ATOL, rtol=RTOL)


def test_params_round_trip_identity(setup):
    jcfg, tcfg, jparams = setup
    flat = _flat_np(jparams)
    back = tswin.params_to_jax(tswin.params_from_jax(flat, tcfg))
    assert set(back) == set(flat)
    for p, v in flat.items():
        assert back[p].shape == v.shape and np.array_equal(back[p].numpy(), v), p


def test_port_init_has_jax_layout(setup):
    jcfg, tcfg, jparams = setup
    tree = tswin.init(tcfg, torch.Generator().manual_seed(0))
    want = {p: v.shape for p, v in jtrees.flatten_with_paths(jparams).items()}
    got = {p: tuple(v.shape) for p, v in ttrees.flatten_with_paths(tree).items()}
    assert got == want


@pytest.mark.parametrize("name", ["swin", "swin_test"])
def test_registry_entries(name):
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import registry as jregistry

    t, j = tregistry.get_model(name), jregistry.get_model(name)
    assert t.family == j.family == "swin" and t.normalization == j.normalization
    assert t.config(5) == tswin.SwinConfig(**{f.name: getattr(j.config(5), f.name)
                                              for f in dataclasses.fields(tswin.SwinConfig)})
    assert t.lora_targets(t.config(5)) == j.lora_targets(j.config(5))


def test_create_model_forward():
    entry, cfg, model = tregistry.create_model("swin_test", 4, torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = entry.apply(cfg, model, torch.zeros(2, 32, 32, 3))
    assert out.shape == (2, 4) and out.dtype == torch.float32 and torch.isfinite(out).all()


# --- the opt-in fused MLP ---------------------------------------------------------

def _count_mlp(monkeypatch):
    calls = []
    orig = tswin.mlp
    monkeypatch.setattr(tswin, "mlp", lambda *a: (calls.append(a[0].shape[-1]), orig(*a))[1])
    return calls


def test_use_fused_mlp_matches_jax_model_flag(monkeypatch):
    """``swin_test`` in bf16 compute with ``use_fused_mlp`` on in both packages
    (the JAX kernel in interpret mode behind a pretended TPU backend): logits
    within 2e-2, the JAX flag tests' limit in bf16; the port reaches the fused
    MLP once per block, at every stage width."""
    jcfg = dataclasses.replace(jswin.SWIN_TEST, compute_dtype="bfloat16", use_fused_mlp=True)
    tcfg = dataclasses.replace(tswin.SWIN_TEST, compute_dtype="bfloat16", use_fused_mlp=True)
    jparams = jax.jit(jswin.init, static_argnums=1)(jax.random.key(0), jcfg)
    x = _images(jcfg, 11)
    with pltpu.force_tpu_interpret_mode(), mock.patch("jax.default_backend", return_value="tpu"):
        want = np.asarray(jswin.apply(jcfg, jparams, x))
    calls = _count_mlp(monkeypatch)
    model = tswin.params_from_jax(_flat_np(jparams), tcfg)
    np.testing.assert_allclose(_logits(tcfg, model, x), want, atol=2e-2, rtol=2e-2)
    assert len(calls) == sum(tcfg.depths)
    assert sorted(set(calls)) == [tcfg.stage_dim(s) for s in range(tcfg.num_stages)]


def test_use_fused_mlp_stands_aside_for_f32_and_for_lora(monkeypatch):
    jcfg, tcfg = CONFIGS["swin_test"]
    jparams = jax.jit(jswin.init, static_argnums=1)(jax.random.key(0), jcfg)
    x = _images(jcfg, 12)
    calls = _count_mlp(monkeypatch)
    on = dataclasses.replace(tcfg, use_fused_mlp=True)  # f32 compute: the field does nothing
    assert np.array_equal(_logits(on, tswin.params_from_jax(_flat_np(jparams), on), x),
                          _logits(tcfg, tswin.params_from_jax(_flat_np(jparams), tcfg), x))
    assert calls == []
    # bf16 compute, unmerged factors on fc1/fc2 of stage 0: those blocks stay unfused
    on16 = dataclasses.replace(on, compute_dtype="bfloat16")
    base = ttrees.unflatten_from_paths(ttrees.map_leaves(torch.from_numpy, _flat_np(jparams)))
    targets = ("stages/0/blocks/mlp/fc1", "stages/0/blocks/mlp/fc2")
    lcfg = tlora.LoRAConfig(rank=2, targets=targets)
    attached = tlora.attach(base, tlora.init(torch.Generator().manual_seed(0), base, lcfg), lcfg)
    _logits(on16, tswin.params_from_jax(attached, on16), x)
    assert len(calls) == sum(on16.depths[1:]) and on16.stage_dim(0) not in calls
