"""The port's attack pieces and FGSM/PGD against the JAX package.

Same params (JAX ``vit.init`` at VIT_TEST size; for the ConvNeXt cases JAX
``convnext.init`` at CONVNEXT_TEST size with the layer scale redrawn in
0.1-1) and the same numpy images feed both. A pixel's step is the sign of its gradient; where the gradient
is within rounding of zero the two frameworks may pick different signs, so
the attacks must agree on >= 99% of pixels within 1e-6, and every pixel must
stay in the eps-ball.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import common as tcommon
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import whitebox as twb
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import convnext as tcnx
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit as tvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks import common as jcommon
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks import whitebox as jwb
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import convnext as jcnx
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


def test_to_unit_floats_divides_by_a_tensor_on_the_images_device():
    """CUDA turns a division by a CPU scalar into a product with its
    reciprocal, one ulp off the quotient for 126 of the 256 values, and the
    card's truncated adversarial pixels then land a level off the CPU's
    (5.4% of them in ``chip_smoke.py`` phase 12 before this was repaired):
    the divisor is a tensor on the images' device, and every value is
    numpy's f32 quotient."""
    from torch.overrides import TorchFunctionMode

    divisors = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.Tensor.div, torch.Tensor.__truediv__, torch.div, torch.true_divide):
                divisors.append(args[1])
            return func(*args, **(kwargs or {}))

    u8 = torch.arange(256, dtype=torch.uint8)
    with Record():
        got = tcommon.to_unit_floats(u8)
    assert divisors and all(isinstance(d, torch.Tensor) and d.device == u8.device
                            for d in divisors), divisors
    np.testing.assert_array_equal(got.numpy(), np.arange(256, dtype=np.float32) / np.float32(255))


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
    flags = [p.requires_grad for p in model.parameters()]
    want = jwb.make_fgsm(jvit.apply, jvit.VIT_TEST, eps=EPS)(jp, jnp.asarray(u8), jnp.asarray(labels))
    got = twb.make_fgsm(tvit.apply, tvit.VIT_TEST, eps=EPS)(
        model, torch.from_numpy(u8), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == u8.shape
    # frozen only while the attack ran: the caller's flags are back
    assert [p.requires_grad for p in model.parameters()] == flags
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


@pytest.fixture(scope="module")
def convnext_models():
    jp = jcnx.init(jax.random.key(0), jcnx.CONVNEXT_TEST)
    flat = {p: np.array(v) for p, v in jtrees.flatten_with_paths(jp).items()}
    rng = np.random.default_rng(0)
    for p, v in flat.items():
        if p.endswith("gamma"):
            flat[p] = rng.uniform(0.1, 1.0, v.shape).astype(np.float32)
    jp = jtrees.unflatten_from_paths({p: jnp.asarray(v) for p, v in flat.items()})
    return jp, tcnx.params_from_jax(flat, tcnx.CONVNEXT_TEST)


@pytest.mark.parametrize("attack", ["fgsm", "pgd"])
def test_convnext_attacks_match_jax(convnext_models, batch, attack):
    jp, model = convnext_models
    u8, labels = batch
    if attack == "fgsm":
        want = jwb.make_fgsm(jcnx.apply, jcnx.CONVNEXT_TEST, eps=EPS)(
            jp, jnp.asarray(u8), jnp.asarray(labels))
        got = twb.make_fgsm(tcnx.apply, tcnx.CONVNEXT_TEST, eps=EPS)(
            model, torch.from_numpy(u8), torch.from_numpy(labels))
    else:
        kw = dict(eps=EPS, alpha=ALPHA, steps=3, random_start=False)
        want = jwb.make_pgd(jcnx.apply, jcnx.CONVNEXT_TEST, **kw)(
            jp, jnp.asarray(u8), jnp.asarray(labels), jax.random.key(0))
        got = twb.make_pgd(tcnx.apply, tcnx.CONVNEXT_TEST, **kw)(
            model, torch.from_numpy(u8), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == u8.shape
    _agree(got.numpy(), want)
    clean = u8.astype(np.float32) / 255.0
    assert np.abs(got.numpy() - clean).max() <= EPS + 1e-6
    assert float(got.min()) >= 0 and float(got.max()) <= 1


def test_convnext_pgd_with_kernel_fields_takes_no_parameter_gradient(convnext_models, batch):
    """bf16 with both kernel fields on (their plain versions on the CPU): PGD
    stays in the ball, raises the loss, and asks for the input gradient only."""
    import dataclasses

    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import dwconv as tdw
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import mlp as tmlp

    cfg = dataclasses.replace(tcnx.CONVNEXT_TEST, compute_dtype="bfloat16", use_dw_kernel=True,
                              fuse_ln_mlp=True)
    model = tcnx.params_from_jax(tcnx.params_to_jax(convnext_models[1]), cfg)
    u8, labels = batch
    x, y = torch.from_numpy(u8), torch.from_numpy(labels).long()
    before = (tdw.DW_CALLS, tmlp.PARAM_GRAD_CALLS)
    adv = twb.make_pgd(tcnx.apply, cfg, eps=EPS, alpha=ALPHA, steps=3)(
        model, x, y, torch.Generator().manual_seed(3))
    assert (tdw.DW_CALLS, tmlp.PARAM_GRAD_CALLS) == before
    clean = tcommon.to_unit_floats(x)
    assert float((adv - clean).abs().max()) <= EPS + 1e-6
    with torch.no_grad():
        ce = lambda im: float(tcommon.sum_cross_entropy(
            tcnx.apply(cfg, model, tcommon.IMAGENET(im)), y))
    assert ce(adv) > ce(clean)


def _vit_bf16_block_model(models):
    """VIT_TEST in bf16 with ``fuse_attn_block`` on (its plain versions on the
    CPU go through the same ``autograd.Function`` as the kernels on a card)."""
    import dataclasses

    cfg = dataclasses.replace(tvit.VIT_TEST, compute_dtype="bfloat16", fuse_attn_block=True)
    return cfg, tvit.params_from_jax(tvit.params_to_jax(models[1]), cfg)


@pytest.mark.parametrize("attack", ["fgsm", "pgd"])
def test_attacks_restore_the_callers_requires_grad_flags(models, batch, attack):
    """The attack freezes the module only while it runs: each parameter's
    flag (some on, some off) is as the caller left it afterwards."""
    cfg, model = _vit_bf16_block_model(models)
    params = list(model.parameters())
    for i, p in enumerate(params):
        p.requires_grad_(i % 3 != 0)
    flags = [p.requires_grad for p in params]
    u8, labels = batch
    x, y = torch.from_numpy(u8), torch.from_numpy(labels).long()
    if attack == "fgsm":
        twb.make_fgsm(tvit.apply, cfg, eps=EPS)(model, x, y)
    else:
        twb.make_pgd(tvit.apply, cfg, eps=EPS, alpha=ALPHA, steps=2)(
            model, x, y, torch.Generator().manual_seed(0))
    assert [p.requires_grad for p in params] == flags
    assert any(flags) and not all(flags)


def test_attack_restores_the_flags_when_it_raises(models, batch):
    """An exception inside the attack restores the flags too, and the
    parameters were frozen while the model ran."""
    cfg, model = _vit_bf16_block_model(models)
    seen = []

    def failing_apply(c, m, images):
        seen.append([p.requires_grad for p in m.parameters()])
        raise RuntimeError("boom")

    u8, labels = batch
    x, y = torch.from_numpy(u8), torch.from_numpy(labels).long()
    for make in (lambda: twb.make_fgsm(failing_apply, cfg, eps=EPS),
                 lambda: twb.make_pgd(failing_apply, cfg, eps=EPS, alpha=ALPHA, steps=2)):
        with pytest.raises(RuntimeError, match="boom"):
            make()(model, x, y)
        assert all(p.requires_grad for p in model.parameters())
    assert seen and not any(any(flags) for flags in seen)


def test_vit_block_and_swin_attacks_take_no_parameter_or_bias_gradient(models, batch):
    """Through a ``vit_test`` attack with ``fuse_attn_block`` and a
    ``swin_test`` attack (bf16), no parameter-gradient recompute of the
    half-block and no bias-gradient recompute of window attention."""
    import dataclasses

    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import attn_block as tab
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import window_attention as twin
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import swin as tswin

    u8, labels = batch
    x, y = torch.from_numpy(u8), torch.from_numpy(labels).long()
    vcfg, vmodel = _vit_bf16_block_model(models)
    scfg = dataclasses.replace(tswin.SWIN_TEST, compute_dtype="bfloat16")
    smodel = tswin.params_from_jax(tswin.init(scfg, torch.Generator().manual_seed(1)), scfg)
    before = (tab.PARAM_GRAD_CALLS, twin.DBIAS_CALLS)
    for apply, cfg, model in ((tvit.apply, vcfg, vmodel), (tswin.apply, scfg, smodel)):
        adv = twb.make_pgd(apply, cfg, eps=EPS, alpha=ALPHA, steps=2)(
            model, x, y, torch.Generator().manual_seed(3))
        assert float((adv - tcommon.to_unit_floats(x)).abs().max()) <= EPS + 1e-6
        twb.make_fgsm(apply, cfg, eps=EPS)(model, x, y)
    assert (tab.PARAM_GRAD_CALLS, twin.DBIAS_CALLS) == before
    # the module is trainable again afterwards, as it was built
    assert all(p.requires_grad for p in vmodel.parameters())


class _RecordingPool:
    """A stand-in executor: records when each encode is submitted and when
    its result is awaited, and runs the encode at that wait."""

    def __init__(self, log):
        self.log = log

    def submit(self, fn, item):
        log = self.log
        log.append(("submit", item[1]))

        class _Future:
            def result(self):
                log.append(("wait", item[1]))
                return fn(item)

        return _Future()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_generate_overlaps_batch_k_attack_with_batch_k_minus_1_encode(tmp_path, monkeypatch):
    """Batch k's attack is launched before batch k-1's encodes are awaited; at
    most one batch is pending; every file is written before the metadata;
    names and metadata order are those of the serial writer."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import generate as tgen
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data import io as tio
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data.loader import Batch

    rng = np.random.default_rng(0)
    names = [["a.png", "b.png"], ["a.png", "c.png"], ["d.png", "pad.png"]]
    batches = [Batch(images=rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8),
                     labels=np.zeros(2, np.int32),
                     valid=np.array([1.0, 1.0 if k < 2 else 0.0], np.float32), filenames=fs)
               for k, fs in enumerate(names)]
    log = []
    monkeypatch.setattr(tgen, "ThreadPoolExecutor", lambda max_workers: _RecordingPool(log))
    saved = tio.save_metadata

    def save_metadata(df, path):
        log.append(("metadata", None))
        saved(df, path)

    monkeypatch.setattr(tio, "save_metadata", save_metadata)

    def attack(params, images, labels, gen):
        log.append(("attack", None))
        return images.float() / 255.0

    clean = tio.Table(tio.METADATA_COLUMNS, ((f"/clean/{n}", "s", "x", "x")
                                             for n in ("a.png", "b.png", "a.png", "c.png",
                                                       "d.png")))
    meta = tgen.generate_adversarial_split(attack, None, batches, out_dir=str(tmp_path),
                                           clean_metadata=clean, device="cpu")
    kinds = [k for k, _ in log]
    attacks = [i for i, k in enumerate(kinds) if k == "attack"]
    assert len(attacks) == 3
    written = ({"a.png", "b.png"}, {"a__1.png", "c.png"}, {"d.png"})
    for k, files in enumerate(written):
        submits = [i for i, (kind, n) in enumerate(log) if kind == "submit" and n in files]
        waits = [i for i, (kind, n) in enumerate(log) if kind == "wait" and n in files]
        assert len(submits) == len(waits) == len(files)
        # submitted after its own attack, not awaited before the next one was launched
        assert all(attacks[k] < i for i in submits)
        if k + 1 < len(attacks):
            assert all(i < attacks[k + 1] for i in submits), log
            assert all(i > attacks[k + 1] for i in waits), log
        # at most one batch pending: awaited before the attack after next
        if k + 2 < len(attacks):
            assert all(i < attacks[k + 2] for i in waits), log
    assert kinds[-1] == "metadata" and kinds.count("wait") == kinds.count("submit") == 5
    assert sorted(p.name for p in (tmp_path / "images").iterdir()) == [
        "a.png", "a__1.png", "b.png", "c.png", "d.png"]
    assert [os.path.basename(p) for p in meta["image_path"]] == [
        "a.png", "b.png", "a__1.png", "c.png", "d.png"]
    assert (tmp_path / "metadata.csv").exists()


def test_from_uint8_equals_jax():
    images = np.random.default_rng(11).integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    got = tcommon.from_uint8(images)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jcommon.from_uint8(images))
    np.testing.assert_array_equal(tcommon.uint8_quantize(got), images)
