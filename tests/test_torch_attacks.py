"""The port's attack pieces and FGSM/PGD against the JAX package.

Same params (JAX ``vit.init`` at VIT_TEST size) and the same numpy images
feed both. A pixel's step is the sign of its gradient; where the gradient
is within rounding of zero the two frameworks may pick different signs, so
the attacks must agree on >= 99% of pixels within 1e-6, and every pixel must
stay in the eps-ball.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import common as tcommon
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import whitebox as twb
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit as tvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks import common as jcommon
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks import whitebox as jwb
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import vit as jvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

EPS, ALPHA = 8 / 255, 3 / 255


@pytest.fixture(scope="module")
def models():
    jp = jvit.init(jax.random.key(0), jvit.VIT_TEST)
    flat = {p: np.array(v) for p, v in jtrees.flatten_with_paths(jp).items()}
    return jp, tvit.params_from_jax(flat, tvit.VIT_TEST)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 10, 6).astype(np.int32))


def _agree(got, want, frac=0.99, atol=1e-6):
    ok = np.abs(np.asarray(got) - np.asarray(want)) <= atol
    assert ok.mean() >= frac, f"only {ok.mean():.4f} of pixels agree"


def test_to_unit_floats_matches_jax(batch):
    u8 = batch[0]
    got = tcommon.to_unit_floats(torch.from_numpy(u8))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcommon.to_unit_floats(jnp.asarray(u8))))
    f = torch.rand(2, 3)
    assert tcommon.to_unit_floats(f) is f


def test_linf_project_matches_jax():
    rng = np.random.default_rng(1)
    origin = rng.random((4, 8, 8, 3), dtype=np.float32)
    x = origin + rng.uniform(-0.2, 0.2, origin.shape).astype(np.float32)
    got = tcommon.linf_project(torch.from_numpy(x), torch.from_numpy(origin), EPS)
    want = jcommon.linf_project(jnp.asarray(x), jnp.asarray(origin), EPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_uint8_quantize_truncates_like_jax():
    vals = np.array([[-0.5, 0.0, 0.999, 1.0, 1.7, 3 / 255 - 1e-7, 254.9 / 255]], np.float32)
    got = tcommon.uint8_quantize(torch.from_numpy(vals))
    np.testing.assert_array_equal(got, jcommon.uint8_quantize(vals))
    assert got.dtype == np.uint8 and got.tolist() == [[0, 0, 254, 255, 255, 2, 254]]


def test_sum_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((5, 7)).astype(np.float32) * 3
    labels = np.array([0, 6, 3, 3, 1], np.int32)
    got = tcommon.sum_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(jcommon.sum_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)


def test_fgsm_matches_jax(models, batch):
    jp, model = models
    u8, labels = batch
    want = jwb.make_fgsm(jvit.apply, jvit.VIT_TEST, eps=EPS)(jp, jnp.asarray(u8), jnp.asarray(labels))
    got = twb.make_fgsm(tvit.apply, tvit.VIT_TEST, eps=EPS)(
        model, torch.from_numpy(u8), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == u8.shape
    assert all(not p.requires_grad for p in model.parameters())
    _agree(got.numpy(), want)
    assert float(got.min()) >= 0 and float(got.max()) <= 1


def test_pgd_no_random_start_matches_jax(models, batch):
    jp, model = models
    u8, labels = batch
    kw = dict(eps=EPS, alpha=ALPHA, steps=3, random_start=False)
    want = jwb.make_pgd(jvit.apply, jvit.VIT_TEST, **kw)(
        jp, jnp.asarray(u8), jnp.asarray(labels), jax.random.key(0))
    got = twb.make_pgd(tvit.apply, tvit.VIT_TEST, **kw)(
        model, torch.from_numpy(u8), torch.from_numpy(labels))
    _agree(got.numpy(), want)
    clean = u8.astype(np.float32) / 255.0
    assert np.abs(got.numpy() - clean).max() <= EPS + 1e-6


def test_pgd_random_start_stays_in_ball_and_raises_loss(models, batch):
    _, model = models
    u8, labels = batch
    run = twb.make_pgd(tvit.apply, tvit.VIT_TEST, eps=EPS, alpha=ALPHA, steps=3)
    x, y = torch.from_numpy(u8), torch.from_numpy(labels).long()
    a = run(model, x, y, torch.Generator().manual_seed(3))
    b = run(model, x, y, torch.Generator().manual_seed(3))
    c = run(model, x, y, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    clean = tcommon.to_unit_floats(x)
    assert float((a - clean).abs().max()) <= EPS + 1e-6
    assert float(a.min()) >= 0 and float(a.max()) <= 1
    with torch.no_grad():
        ce = lambda im: float(tcommon.sum_cross_entropy(
            tvit.apply(tvit.VIT_TEST, model, tcommon.IMAGENET(im)), y))
    assert ce(a) > ce(clean)
