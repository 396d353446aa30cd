"""The port's train-time augmentation (``data/augment.py``) against the JAX
package's: the warp with the same affine parameters (1e-5), the composed
affine's special cases, the jitter's ranges. The random streams differ by
design, so draws are compared as distributions, never value by value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data import augment as taug
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.data import augment as jaug

S = 32


def _images(n=3, seed=0):
    return np.random.default_rng(seed).random((n, S, S, 3), dtype=np.float32)


def _affine(theta, crop_w, crop_h, x0, y0, flip):
    t = lambda v, dt=torch.float32: torch.tensor(v, dtype=dt)
    return taug._compose_affine(t(theta), t(crop_w), t(crop_h), t(x0), t(y0),
                                t(flip, torch.bool), S)


@pytest.mark.parametrize("case", ["rotate", "crop", "flip_crop_rotate"])
def test_warp_matches_jax_warp_for_the_same_affine(case):
    """The six numbers of the port's composed affine, handed to the JAX
    ``_warp_one`` (its soft one-hot contraction) and to the port's
    ``grid_sample`` warp: equal at 1e-5, edge decay and zero fill included."""
    n = 3
    theta, cw, ch, x0, y0, flip = {
        "rotate": ([0.2, -0.26, 0.1], [S] * n, [S] * n, [0.0] * n, [0.0] * n, [False] * n),
        "crop": ([0.0] * n, [20.0, 12.5, 32.0], [16.0, 30.0, 9.0], [3.0, 10.2, 0.0],
                 [5.5, 1.0, 11.0], [False] * n),
        "flip_crop_rotate": ([0.15, -0.1, 0.26], [24.0, 17.3, 30.0], [28.0, 21.0, 13.7],
                             [2.0, 7.7, 1.0], [1.5, 4.0, 9.9], [True, False, True]),
    }[case]
    affine = _affine(theta, cw, ch, x0, y0, flip)
    images = _images(n)
    got = taug.warp(torch.from_numpy(images), affine).numpy()
    jaff = tuple(jnp.asarray(a.numpy()) for a in affine)
    want = jax.vmap(lambda im, af: jaug._warp_one(im, af, 15.0))(jnp.asarray(images), jaff)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    assert got.shape == images.shape


def test_identity_config_is_the_identity():
    cfg = taug.AugmentConfig(rotation_deg=0.0, crop_scale=(1.0, 1.0), crop_ratio=(1.0, 1.0),
                             hflip_p=0.0, brightness=0.0, contrast=0.0, saturation=0.0)
    images = torch.from_numpy(_images())
    out = taug.train_augment(images, torch.Generator().manual_seed(0), cfg)
    torch.testing.assert_close(out, images, atol=1e-5, rtol=1e-5)


def test_flip_only_mirrors_the_width_axis():
    cfg = taug.AugmentConfig(rotation_deg=0.0, crop_scale=(1.0, 1.0), crop_ratio=(1.0, 1.0),
                             hflip_p=1.0, brightness=0.0, contrast=0.0, saturation=0.0)
    images = torch.from_numpy(_images())
    out = taug.train_augment(images, torch.Generator().manual_seed(0), cfg)
    torch.testing.assert_close(out, images.flip(2), atol=1e-5, rtol=1e-5)


def test_rotation_zero_fills_the_corners():
    n = 2
    affine = _affine([np.pi / 4] * n, [S] * n, [S] * n, [0.0] * n, [0.0] * n, [False] * n)
    out = taug.warp(torch.ones(n, S, S, 3), affine)
    for r, c in ((0, 0), (0, S - 1), (S - 1, 0), (S - 1, S - 1)):
        assert float(out[:, r, c].abs().max()) == 0.0
    assert float(out[:, S // 2, S // 2].min()) == pytest.approx(1.0)


def test_sampled_affines_have_the_reference_distribution():
    """4000 draws against 4000 draws of the JAX sampler: the mean and spread
    of every affine entry agree within 5 standard errors, and no crop
    upscales (|a| <= 1)."""
    n = 4000
    got = taug._sample_affine(torch.Generator().manual_seed(1), n, S, taug.DEFAULT, "cpu")
    want = jaug._sample_affine(jax.random.key(1), n, S, jaug.DEFAULT)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        se = (g.std() ** 2 / n + w.std() ** 2 / n) ** 0.5
        assert abs(g.mean() - w.mean()) < 5 * se + 1e-6
        assert abs(g.std() - w.std()) < 0.1 * w.std() + 1e-6
    assert all(float(a.abs().max()) <= 1.0 + 1e-6 for a in got[:4])


def test_color_jitter_ranges_and_clamp():
    images = torch.from_numpy(_images(64, seed=2)) * 0.5 + 0.1
    g = torch.Generator().manual_seed(3)
    only_b = taug.AugmentConfig(brightness=0.2, contrast=0.0, saturation=0.0)
    ratio = (taug._color_jitter(images, g, only_b) / images).reshape(64, -1)
    assert float(ratio.min()) >= 0.8 - 1e-5 and float(ratio.max()) <= 1.2 + 1e-5
    assert float((ratio.max(1).values - ratio.min(1).values).max()) < 1e-5  # one factor per image
    assert float(ratio[:, 0].std()) > 0.05  # ... and another per image
    out = taug._color_jitter(torch.from_numpy(_images(8)) * 3 - 1, g, taug.DEFAULT)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    # contrast keeps the mean luma, saturation keeps each pixel's luma
    only_c = taug.AugmentConfig(brightness=0.0, contrast=0.2, saturation=0.0)
    luma = lambda x: 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    torch.testing.assert_close(luma(taug._color_jitter(images, g, only_c)).mean((1, 2)),
                               luma(images).mean((1, 2)), atol=1e-5, rtol=1e-5)
    only_s = taug.AugmentConfig(brightness=0.0, contrast=0.0, saturation=0.2)
    torch.testing.assert_close(luma(taug._color_jitter(images, g, only_s)), luma(images),
                               atol=1e-5, rtol=1e-5)


def test_train_augment_draws_fresh_parameters_per_call():
    images = torch.from_numpy(_images())
    g = torch.Generator().manual_seed(4)
    a, b = taug.train_augment(images, g), taug.train_augment(images, g)
    assert a.shape == images.shape and a.dtype == torch.float32
    assert not torch.equal(a, b)
    again = taug.train_augment(images, torch.Generator().manual_seed(4))
    assert torch.equal(a, again)  # reproducible from the seed
