"""The port's EOT patch, RP2 and corruptions against the JAX package.

The masks and the RP2 config are held exactly. The composite is held at
atol 1e-5 on the same EOT parameters (drawn by the JAX package), with a
shared patch and with a patch per example, and so is its gradient into the
patch. Patch training runs JAX's ``run(params, images, labels, rng, mask)``
and the port's ``run.with_draws`` on the same ``vit_test`` parameters (f32)
with the very minibatch indices and EOT samples JAX draws, rebuilt from the
same key with JAX's own calls. Adam's first step is about ±lr·sign(g),
clipped to [0, 1], so a gradient component within rounding of zero may take
the other side, and later steps scale a gradient's relative f32 noise by lr
(lr × Δg/|g|, large where g1 and g2 nearly cancel). So the patches must
agree on >= 99% of values within 2e-5 · lr: 1e-4 at the patch's default
lr 5, 1e-5 at RP2's lr 0.1 and at 0.5. The loss histories agree within
rtol 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import corruptions as tcor
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import patch as tpatch
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import rp2 as trp2
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit as tvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks import corruptions as jcor
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks import patch as jpatch
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks import rp2 as jrp2
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import vit as jvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

PATCH_FRAC, PATCH_ATOL, LOSS_RTOL = 0.99, 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: under pytest-xdist the
    workers share the cores, and a pool of one thread per core makes each
    small eager op wait on the other workers (10x slower in a full run)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _agree(got, want, frac=PATCH_FRAC, atol=PATCH_ATOL):
    ok = np.abs(np.asarray(got) - np.asarray(want)) <= atol
    assert ok.mean() >= frac, f"only {ok.mean():.4f} of values agree"


def _t(tree):
    return tuple(torch.from_numpy(np.array(a)) for a in tree)


@pytest.fixture(scope="module")
def models():
    jp = jvit.init(jax.random.key(0), jvit.VIT_TEST)
    flat = {p: np.array(v) for p, v in jtrees.flatten_with_paths(jp).items()}
    return jp, tvit.params_from_jax(flat, tvit.VIT_TEST)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.random((10, 32, 32, 3), dtype=np.float32),
            rng.integers(0, jvit.VIT_TEST.num_classes, 10).astype(np.int32))


@pytest.mark.parametrize("shape", ["circle", "square"])
@pytest.mark.parametrize("size", [7, 8, 24])
def test_patch_mask_matches_jax(shape, size):
    cfg = tpatch.PatchConfig(patch_size=size, shape=shape)
    got = tpatch.patch_mask(cfg)
    assert got.dtype == torch.float32 and got.shape == (size, size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpatch.patch_mask(
        jpatch.PatchConfig(patch_size=size, shape=shape))))
    np.testing.assert_array_equal(tpatch.init_patch(cfg).numpy(),
                                  np.asarray(jpatch.init_patch(jpatch.PatchConfig(patch_size=size))))


@pytest.mark.parametrize("size,radius", [(32, 0.45), (224, 0.45), (33, 0.3)])
def test_sign_mask_matches_jax(size, radius):
    got = trp2.sign_mask(size, radius_frac=radius)
    assert got.shape == (size, size, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrp2.sign_mask(size, radius_frac=radius)))


def test_configs_match_jax():
    assert dataclasses.asdict(tpatch.PatchConfig()) == dataclasses.asdict(jpatch.PatchConfig())
    for kw in ({}, dict(patch_size=8, image_size=32, iters=3, learning_rate=0.5, batch_size=4)):
        assert dataclasses.asdict(trp2.rp2_config(**kw)) == dataclasses.asdict(jrp2.rp2_config(**kw))


def _eot(key, n, cfg, size):
    return jpatch._sample_eot(key, n, cfg, size)


@pytest.mark.parametrize("per_example", [False, True])
def test_composite_matches_jax(per_example):
    rng = np.random.default_rng(1)
    images = rng.random((5, 32, 32, 3), dtype=np.float32)
    n_patch = (5, 8, 8, 3) if per_example else (8, 8, 3)
    patch = rng.random(n_patch, dtype=np.float32)
    jcfg = jpatch.PatchConfig(patch_size=8, scale_min=0.2, scale_max=0.9,
                              brightness_range=(0.8, 1.2))
    mask = jpatch.patch_mask(jcfg)
    eot = _eot(jax.random.key(2), 5, jcfg, 32)
    if per_example:
        want = jax.vmap(jpatch._composite_one, in_axes=(0, 0, None, 0, 0, 0, 0, 0))(
            jnp.asarray(images), jnp.asarray(patch), mask, *eot)
    else:
        want = jpatch.composite_batch(jnp.asarray(images), jnp.asarray(patch), mask, eot)
    got = tpatch.composite_batch(torch.from_numpy(images), torch.from_numpy(patch),
                                 torch.from_numpy(np.array(mask)), _t(eot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)

    # the gradient into the patch, of a weighted sum of the output
    w = rng.standard_normal(images.shape).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jpatch.composite_batch(
        jnp.asarray(images), p, mask, eot) * w))(jnp.asarray(patch)) if not per_example else \
        jax.grad(lambda p: jnp.sum(jax.vmap(jpatch._composite_one,
                                            in_axes=(0, 0, None, 0, 0, 0, 0, 0))(
            jnp.asarray(images), p, mask, *eot) * w))(jnp.asarray(patch))
    tp = torch.from_numpy(patch).requires_grad_(True)
    (tpatch.composite_batch(torch.from_numpy(images), tp, torch.from_numpy(np.array(mask)),
                            _t(eot)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), atol=1e-4, rtol=1e-5)


def _jax_train_draws(rng, cfg, n, size):
    """The minibatch indices and EOT samples JAX's trainer draws from ``rng``."""
    out = []
    for r in jax.random.split(rng, cfg.iters):
        r_idx, r_eot = jax.random.split(r)
        idx = jax.random.randint(r_idx, (cfg.batch_size,), 0, n)
        out.append((torch.from_numpy(np.array(idx)).long(),
                    _t(_eot(r_eot, cfg.batch_size, cfg, size))))
    return out


@pytest.mark.parametrize("kind,lr,atol", [("circle", 5.0, 1e-4), ("square", 5.0, 1e-4),
                                           ("rp2", 0.1, PATCH_ATOL), ("rp2", 0.5, PATCH_ATOL)])
def test_make_train_patch_matches_jax(models, data, kind, lr, atol):
    jp, model = models
    images, labels = data
    if kind == "rp2":
        kw = dict(patch_size=8, image_size=32, iters=3, batch_size=4, learning_rate=lr)
        jcfg, tcfg, loc = jrp2.rp2_config(**kw), trp2.rp2_config(**kw), (0.5, 0.5)
    else:
        kw = dict(patch_size=8, shape=kind, iters=3, batch_size=4, scale_min=0.2, scale_max=0.8,
                  learning_rate=lr)
        jcfg, tcfg, loc = jpatch.PatchConfig(**kw), tpatch.PatchConfig(**kw), None
    rng = jax.random.key(5)
    want_patch, want_losses = jpatch.make_train_patch(
        jvit.apply, jvit.VIT_TEST, jcfg, fixed_location=loc)(
        jp, jnp.asarray(images), jnp.asarray(labels), rng)
    run = tpatch.make_train_patch(tvit.apply, tvit.VIT_TEST, tcfg, fixed_location=loc)
    got_patch, got_losses = run.with_draws(
        model, torch.from_numpy(images), torch.from_numpy(labels),
        _jax_train_draws(rng, jcfg, len(images), 32))
    assert got_patch.shape == (8, 8, 3) and got_losses.shape == (3,)
    _agree(got_patch.numpy(), want_patch, atol=atol)
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses), rtol=LOSS_RTOL)
    assert float(got_patch.min()) >= 0 and float(got_patch.max()) <= 1
    # every parameter is trainable again afterwards, as it was built
    assert all(p.requires_grad for p in model.parameters())


def test_make_train_patch_draws_from_the_generator(models, data):
    _, model = models
    images, labels = (torch.from_numpy(a) for a in data)
    run = tpatch.make_train_patch(tvit.apply, tvit.VIT_TEST,
                                  tpatch.PatchConfig(patch_size=8, iters=3, batch_size=4))
    a = run(model, images, labels, torch.Generator().manual_seed(1))
    b = run(model, images, labels, torch.Generator().manual_seed(1))
    c = run(model, images, labels, torch.Generator().manual_seed(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])
    # the square mask is a runtime argument of the same trainer
    sq = run(model, images, labels, torch.Generator().manual_seed(1),
             tpatch.patch_mask(tpatch.PatchConfig(patch_size=8, shape="square")))
    assert not torch.equal(sq[1], a[1])


def _footprint(eot, size, p):
    """Pixels whose inverse-mapped patch coordinate is off the patch by more
    than a margin (so every bilinear weight there is 0)."""
    scale, theta, tx, ty, _ = (t.reshape(-1, 1, 1).double() for t in eot)
    ar = torch.arange(size, dtype=torch.float64)
    dx = ar[None, None, :] - (size - 1) / 2.0 - tx
    dy = ar[None, :, None] - (size - 1) / 2.0 - ty
    k = scale * size / p
    u = (torch.cos(-theta) * dx - torch.sin(-theta) * dy) / k + (p - 1) / 2.0
    v = (torch.sin(-theta) * dx + torch.cos(-theta) * dy) / k + (p - 1) / 2.0
    off = (u <= -1.01) | (u >= p + 0.01) | (v <= -1.01) | (v >= p + 0.01)
    return ~off


@pytest.mark.parametrize("shape", ["circle", "square"])
def test_apply_patch_invariants(shape):
    rng = np.random.default_rng(3)
    u8 = torch.from_numpy(rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8))
    cfg = tpatch.PatchConfig(patch_size=8, shape=shape)
    patch = torch.from_numpy(rng.random((8, 8, 3), dtype=np.float32))
    apply = tpatch.make_apply_patch(cfg)
    out = apply(u8, patch, torch.Generator().manual_seed(4), 0.3)
    clean = u8.float() / 255.0
    assert out.dtype == torch.float32 and out.shape == clean.shape
    assert float(out.min()) >= 0 and float(out.max()) <= 1
    eot = tpatch.apply_eot(torch.Generator().manual_seed(4), 6, cfg, 32, 0.3, "cpu")
    assert torch.equal(eot[0], torch.full((6,), 0.3))
    foot = _footprint(eot, 32, 8)
    assert torch.equal(out[~foot], clean[~foot])  # bit for bit outside the footprint
    changed = (out != clean).any(-1)
    assert changed.any(dim=(1, 2)).all()
    # the same draws make the same output; the scale is a runtime value
    assert torch.equal(out, apply(u8, patch, torch.Generator().manual_seed(4), 0.3))
    big = apply(u8, patch, torch.Generator().manual_seed(4), torch.tensor(0.5))
    assert (big != clean).any(-1).sum() > changed.sum()


def test_sign_constrained_apply_keeps_pixels_outside_the_sign():
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.random((4, 32, 32, 3), dtype=np.float32))
    cfg = trp2.rp2_config(patch_size=8, image_size=32)
    patches = torch.from_numpy(rng.random((4, 8, 8, 3), dtype=np.float32))
    out = trp2.make_sign_constrained_apply(cfg)(images, patches, torch.Generator().manual_seed(0),
                                                cfg.scale_max)
    outside = trp2.sign_mask(32)[..., 0] == 0
    assert torch.equal(out[:, outside], images[:, outside])
    assert float(out.min()) >= 0 and float(out.max()) <= 1
    assert not torch.equal(out, images)
    # each image got its own patch: the same patch for all gives another result
    shared = trp2.make_sign_constrained_apply(cfg)(images, patches[0],
                                                   torch.Generator().manual_seed(0), cfg.scale_max)
    assert torch.equal(shared[0], out[0]) and not torch.equal(shared[1:], out[1:])


def test_train_rp2_patches_pads_each_class_and_skips_small_ones(monkeypatch):
    """Each eligible class trains on its samples repeated to the largest
    class's count (``np.resize``, as JAX); a class below ``min_samples`` gets
    no patch; each class has its own generator seed."""
    calls = []

    def fake_make_train_patch(entry_apply, model_cfg, cfg, *, normalize, fixed_location):
        assert fixed_location == (0.5, 0.5)

        def run(params, images, labels, generator):
            calls.append((images.clone(), labels.clone(), generator.initial_seed()))
            return torch.full((cfg.patch_size,) * 2 + (3,), float(labels[0])), torch.zeros(2)

        return run

    monkeypatch.setattr(trp2, "make_train_patch", fake_make_train_patch)
    rng = np.random.default_rng(0)
    labels = np.array([2, 0, 2, 1, 2, 0, 2, 2], np.int32)  # class 1 has one sample
    images = rng.random((8, 32, 32, 3), dtype=np.float32)
    cfg = trp2.rp2_config(patch_size=8, image_size=32)
    out = trp2.train_rp2_patches(None, None, None, images, labels, device="cpu", cfg=cfg, seed=3,
                                 log=lambda s: None)
    assert sorted(out) == [0, 2]
    assert [int(c[1][0]) for c in calls] == [0, 2]
    for (imgs, lbls, seed), c in zip(calls, (0, 2)):
        take = np.resize(np.nonzero(labels == c)[0], 5)  # the largest class has 5
        np.testing.assert_array_equal(imgs.numpy(), images[take])
        assert lbls.tolist() == [c] * 5 and lbls.dtype == torch.int64
        assert seed == 3 * 100003 + c
        assert out[c].shape == (8, 8, 3) and isinstance(out[c], np.ndarray)
    assert trp2.train_rp2_patches(None, None, None, images, labels, device="cpu", cfg=cfg,
                                  min_samples=6, log=lambda s: None) == {}


def test_train_rp2_patches_on_vit_test(models, data):
    _, model = models
    images, labels = data
    labels = np.array([0, 0, 1, 1, 1, 2, 0, 1, 0, 3], np.int32)
    cfg = trp2.rp2_config(patch_size=8, image_size=32, iters=2, batch_size=4)
    lines = []
    out = trp2.train_rp2_patches(tvit.apply, tvit.VIT_TEST, model, images, labels, device="cpu",
                                 cfg=cfg, log=lines.append)
    assert sorted(out) == [0, 1] and len(lines) == 2
    assert all(0 <= v.min() and v.max() <= 1 and v.dtype == np.float32 for v in out.values())


def test_save_class_patches_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    patches = {0: rng.random((8, 8, 3), dtype=np.float32),
               3: rng.random((8, 8, 3), dtype=np.float32)}
    names = {0: "stop", 3: "yield"}
    cfg_t = trp2.rp2_config(patch_size=8, image_size=32)
    cfg_j = jrp2.rp2_config(patch_size=8, image_size=32)
    trp2.save_class_patches(patches, str(tmp_path / "t"), cfg=cfg_t, class_names=names)
    jrp2.save_class_patches(patches, str(tmp_path / "j"), cfg=cfg_j, class_names=names)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == [
        "rp2_patch_stop.png", "rp2_patch_yield.png"]
    for name in os.listdir(tmp_path / "t"):
        got = np.asarray(Image.open(tmp_path / "t" / name))
        np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "j" / name)))
    mask = tpatch.patch_mask(cfg_t).numpy()
    assert (got[mask == 0] == 0).all()
    trp2.save_class_patches({1: patches[0]}, str(tmp_path / "plain"))
    assert os.listdir(tmp_path / "plain") == ["rp2_patch_class_1.png"]


@pytest.mark.parametrize("name", sorted(tcor.CORRUPTIONS))
def test_corruptions_range_shape_dtype(name):
    assert set(tcor.CORRUPTIONS) == set(jcor.CORRUPTIONS)
    rng = np.random.default_rng(6)
    images = torch.from_numpy(rng.random((4, 16, 16, 3), dtype=np.float32))
    fn = tcor.CORRUPTIONS[name]
    out = fn(images, torch.Generator().manual_seed(0))
    assert out.shape == images.shape and out.dtype == images.dtype
    assert float(out.min()) >= 0 and float(out.max()) <= 1
    assert torch.equal(out, fn(images, torch.Generator().manual_seed(0)))
    assert not torch.equal(out, images)
    want = np.asarray(jcor.CORRUPTIONS[name](jnp.asarray(images.numpy()), jax.random.key(0)))
    assert want.shape == out.shape and want.dtype == out.numpy().dtype
    if name == "salt_and_pepper":  # a pixel is either kept or set to 0 or 1 on every channel
        kept = (out == images).all(-1)
        flipped = out[~kept]
        assert ((flipped == 0).all(-1) | (flipped == 1).all(-1)).all()
        assert 0 < float((~kept).float().mean()) < 0.2
    if name == "brightness":  # one shift per image
        d = out - images
        inner = (images > 0.35) & (images < 0.65)
        for i in range(4):
            vals = d[i][inner[i]]
            assert float(vals.max() - vals.min()) < 1e-6
