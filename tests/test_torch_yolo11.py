"""The port's YOLO11-cls against the JAX package's ``yolo11.apply``.

``YOLO11_TEST`` (64 px, the n-scale widths, head width 128). Params come
from JAX ``yolo11.init`` with the BN statistics and affine redrawn (mean and
bias at std 0.1, var and scale in 0.5-1.5: at the init every BN is the
identity and a test would see nothing of its order of operations), and
cross through ``params_from_jax``. Logits and the image gradient of the
summed cross-entropy must match at 1e-4 in f32, also with a rank-4 LoRA on
the C2PSA convs attached unmerged and merged; bf16 logits must lie within
1e-3 + 2e-2 x max|logit| of the f32 JAX logits (measured: 4.9e-4 at
max|logit| 0.1), and of the bf16 JAX logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import common as tcommon
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry as tregistry
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import yolo11 as tyolo
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora as tlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees as ttrees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks import common as jcommon
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import registry as jregistry
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import yolo11 as jyolo
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import lora as jlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

JCFG, TCFG = jyolo.YOLO11_TEST, tyolo.YOLO11_TEST
_japply = jax.jit(jyolo.apply, static_argnums=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: under pytest-xdist the
    workers share the cores, and a pool of one thread per core makes each
    small eager op wait on the other workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def flat():
    """The JAX init as numpy, BN statistics and affine redrawn."""
    params = jax.jit(jyolo.init, static_argnums=1)(jax.random.key(0), JCFG)
    out = {p: np.array(v) for p, v in jtrees.flatten_with_paths(params).items()}
    rng = np.random.default_rng(0)
    for p, v in out.items():
        leaf = p.rsplit("/", 1)[-1]
        if "/bn/" in p and leaf in ("mean", "bias"):
            out[p] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif "/bn/" in p:
            out[p] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


def _jparams(flat):
    return jtrees.unflatten_from_paths({p: jnp.asarray(v) for p, v in flat.items()})


def _ttree(flat):
    return ttrees.unflatten_from_paths({p: torch.from_numpy(v.copy()) for p, v in flat.items()})


def _images(seed=0, b=2):
    return np.random.default_rng(seed).random((b, 64, 64, 3), dtype=np.float32)


def _adapters(flat, rank=4):
    """A rank-4 adapter on the C2PSA convs with non-zero B, as numpy."""
    rng = np.random.default_rng(7)
    out = {}
    for path in tyolo.lora_target_paths(TCFG):
        _, _, d_in, d_out = flat[f"{path}/w"].shape
        out[path] = {"a": (rng.standard_normal((1, 1, d_in, rank)) * d_in ** -0.5).astype(np.float32),
                     "b": (0.05 * rng.standard_normal((1, 1, rank, d_out))).astype(np.float32)}
    return out


@pytest.mark.parametrize("scale", sorted(tyolo.SCALES))
def test_widths_and_bottlenecks_match_jax(scale):
    tcfg, jcfg = tyolo.YOLO11Config(scale=scale), jyolo.YOLO11Config(scale=scale)
    assert tcfg.widths == jcfg.widths and tcfg.n_bottlenecks == jcfg.n_bottlenecks
    assert tyolo.SCALES == jyolo.SCALES
    assert tyolo.lora_target_paths(tcfg) == jyolo.lora_target_paths(jcfg)


def test_init_paths_shapes_and_meta(flat):
    """The port's init has the JAX tree's paths and shapes; on the meta
    device it draws nothing and allocates nothing."""
    got = ttrees.flatten_with_paths(tyolo.init(TCFG, torch.Generator().manual_seed(0)))
    meta = ttrees.flatten_with_paths(tyolo.init(TCFG, device="meta"))
    assert {p: v.shape for p, v in flat.items()} == {p: tuple(v.shape) for p, v in got.items()} \
        == {p: tuple(v.shape) for p, v in meta.items()}
    assert all(v.device.type == "meta" for v in meta.values())
    for p, v in got.items():
        if p.endswith("bn/var") or p.endswith("bn/scale"):
            assert torch.equal(v, torch.ones_like(v)), p
        elif "/bn/" in p or p == "head/linear/b":
            assert torch.equal(v, torch.zeros_like(v)), p


@pytest.mark.parametrize("tree_form", ["flat", "nested"])
def test_params_round_trip_is_the_identity(flat, tree_form):
    tree = flat if tree_form == "flat" else _ttree(flat)
    back = tyolo.params_to_jax(tyolo.params_from_jax(tree, TCFG))
    assert set(back) == set(flat)
    assert all(np.array_equal(back[p].numpy(), flat[p]) for p in flat)
    # the trainers pick the head by its parameter names' "head." prefix
    names = {n for n, _ in tyolo.params_from_jax(flat, TCFG).named_parameters()}
    assert {n for n in names if n.startswith("head.")} == {
        p.replace("/", ".") for p in flat if p.startswith("head/")}


def _loss_and_grad_port(cfg, model, x, labels):
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = tyolo.apply(cfg, model, tcommon.IMAGENET(xt))
    loss = tcommon.sum_cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    return logits.detach().numpy(), xt.grad.numpy()


def _loss_and_grad_jax(cfg, params, x, labels):
    def jloss(img):
        return jcommon.sum_cross_entropy(jyolo.apply(cfg, params, jcommon.IMAGENET(img)), labels)

    logits = np.asarray(_japply(cfg, params, jcommon.IMAGENET(jnp.asarray(x))))
    return logits, np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))


@pytest.mark.parametrize("lora_form", ["none", "unmerged", "merged"])
def test_logits_and_image_gradient_match_jax(flat, lora_form):
    x, labels = _images(1, b=3), np.array([0, 3, 9], np.int32)
    jp, tp = _jparams(flat), _ttree(flat)
    if lora_form != "none":
        ad = _adapters(flat)
        jad = {p: {k: jnp.asarray(v) for k, v in f.items()} for p, f in ad.items()}
        tad = {p: {k: torch.from_numpy(v) for k, v in f.items()} for p, f in ad.items()}
        jl = jlora.LoRAConfig(rank=4, alpha=8.0, targets=tuple(ad), dropout=0.0)
        tl = tlora.LoRAConfig(rank=4, alpha=8.0, targets=tuple(ad), dropout=0.0)
        op = "attach" if lora_form == "unmerged" else "merge"
        jp, tp = getattr(jlora, op)(jp, jad, jl), getattr(tlora, op)(tp, tad, tl)
    model = tyolo.params_from_jax(tp, TCFG)
    if lora_form == "unmerged":
        assert all(f"{p}/lora_a".replace("/", ".") in dict(model.named_parameters())
                   for p in tyolo.lora_target_paths(TCFG))
    got, got_g = _loss_and_grad_port(TCFG, model, x, labels)
    want, want_g = _loss_and_grad_jax(JCFG, jp, x, labels)
    assert got.shape == (3, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_g, want_g, atol=1e-4 * np.abs(want_g).max(), rtol=0)
    if lora_form == "unmerged":  # the adapter moved the logits
        base = _loss_and_grad_port(TCFG, tyolo.params_from_jax(flat, TCFG), x, labels)[0]
        assert np.abs(got - base).max() > 1e-3


def test_features_match_jax(flat):
    x = _images(2)
    with torch.no_grad():
        got = tyolo.features(TCFG, tyolo.params_from_jax(flat, TCFG), torch.from_numpy(x)).numpy()
    want = np.asarray(jyolo.features(JCFG, _jparams(flat), jnp.asarray(x)))
    assert got.shape == want.shape == (2, 2, 2, 256)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_bf16_logits_within_the_stated_limit(flat):
    """bf16 compute (convs, SiLU, attention probabilities and pooling rounded
    to bf16) against the f32 JAX logits: within 1e-3 + 2e-2 x max|logit|."""
    x = _images(3, b=4)
    bcfg = dataclasses.replace(TCFG, compute_dtype="bfloat16")
    with torch.no_grad():
        got = tyolo.apply(bcfg, tyolo.params_from_jax(flat, bcfg), torch.from_numpy(x)).numpy()
    want = np.asarray(_japply(JCFG, _jparams(flat), jnp.asarray(x)))
    assert got.dtype == np.float32
    limit = 1e-3 + 2e-2 * np.abs(want).max()
    assert np.abs(got - want).max() <= limit
    jb = np.asarray(_japply(dataclasses.replace(JCFG, compute_dtype="bfloat16"),
                            _jparams(flat), jnp.asarray(x)))
    assert np.abs(got - jb).max() <= limit


@pytest.mark.parametrize("mode", ["input", "post_a"])
def test_lora_dropout_acts_in_training_mode_only(flat, mode):
    """The training form (seeded dropout streams) changes the adapter
    branch's output in training mode only; in eval mode it is the
    dropout-free model, and the frozen conv path sees the undropped input."""
    tl = tlora.LoRAConfig(rank=4, alpha=8.0, targets=tyolo.lora_target_paths(TCFG),
                          dropout=0.5, dropout_mode=mode)
    tad = {p: {k: torch.from_numpy(v) for k, v in f.items()} for p, f in _adapters(flat).items()}
    x = torch.from_numpy(_images(4))
    plain = tyolo.params_from_jax(tlora.attach(_ttree(flat), tad, tl), TCFG)
    drop = tyolo.params_from_jax(tlora.attach(_ttree(flat), tad, tl, dropout_seed=3), TCFG)
    with torch.no_grad():
        want = plain(x)
        drop.eval()
        assert torch.equal(drop(x), want)
        drop.train()
        got = drop(x)
        zero_b = {p: {"a": f["a"], "b": torch.zeros_like(f["b"])} for p, f in tad.items()}
        base = tyolo.params_from_jax(tlora.attach(_ttree(flat), zero_b, tl, dropout_seed=3), TCFG)
        base.train()
        base_out = base(x)
    assert not torch.equal(got, want)
    assert torch.equal(base_out, tyolo.params_from_jax(flat, TCFG)(x).detach())


def test_registry_has_the_five_reference_families():
    for name in ("google_vit", "swin", "dinov1", "convnext", "yolo11-cls"):
        assert name in tregistry.available_models()
    assert tregistry.available_models() == jregistry.available_models()
    entry = tregistry.get_model("yolo11-cls")
    cfg = entry.config(21)
    assert entry.family == "yolo11" and cfg == tyolo.YOLO11N_CLS
    assert cfg.widths == (16, 32, 64, 64, 128, 128, 128, 256, 256)
    assert tregistry.get_model("yolo11_test").config(3).num_classes == 3
