"""The port's AutoAttack suite against the JAX package.

On a ``vit_test`` briefly trained in JAX on separable blobs (the recipe of
``tests/test_autoattack.py``, so the attacks have a real decision boundary
to cross), carried to the port by ``vit.params_from_jax`` (f32). The static
schedules are held exactly, the losses at 1e-6, the Linf projection at 1e-5.
APGD-CE, APGD-T (on the 10-class ``vit_test``, see ``wide``), FAB-T and
Square run in both packages with the very random draws JAX makes, rebuilt from the same key with JAX's own calls. A step is
the sign of a gradient (APGD) or a comparison of two losses (Square, FAB's
adversarial check): where a gradient is within rounding of zero or two
losses within rounding of each other the packages may part, so their
outputs must agree on >= 99% of pixels within 1e-5 (APGD's best losses
within rtol 1e-3), and every output must stay in its ball and in [0, 1].
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import autoattack as taa
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import patch as tpatch
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks.autoattack import apgd as tapgd
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks.autoattack import fab as tfab
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks.autoattack import square as tsq
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks.common import Normalizer as TNorm
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit as tvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks.autoattack import apgd as japgd
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks.autoattack import fab as jfab
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks.autoattack import square as jsq
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.attacks.common import Normalizer as JNorm
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import registry as jreg
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import vit as jvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

JIDENT = JNorm((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
TIDENT = TNorm((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
EPS = 16 / 255
FRAC, ATOL = 0.99, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: under pytest-xdist the
    workers share the cores, and a pool of one thread per core makes each
    small eager op wait on the other workers (10x slower in a full run)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _agree(got, want, frac=FRAC, atol=ATOL):
    ok = np.abs(np.asarray(got) - np.asarray(want)) <= atol
    assert ok.mean() >= frac, f"only {ok.mean():.4f} of values agree"


def _check_ball(x_adv, x, eps):
    x_adv, x = np.asarray(x_adv), np.asarray(x)
    assert np.abs(x_adv - x).max() <= eps + 1e-5
    assert x_adv.min() >= -1e-6 and x_adv.max() <= 1 + 1e-6


def _np(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def toy():
    """vit_test trained 40 Adam steps in JAX on class-coloured blocks; the
    port's model carries the same parameters."""
    import optax

    entry = jreg.get_model("vit_test")
    cfg = entry.config(3)
    params = entry.init(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    n = 30
    images = rng.random((n, 32, 32, 3), np.float32) * 0.2
    labels = np.arange(n) % 3
    for i in range(n):  # class-coloured center block
        images[i, 8:24, 8:24, labels[i]] += 0.7
    images = np.clip(images, 0, 1)
    x, y = jnp.asarray(images), jnp.asarray(labels)
    tx = optax.adam(3e-3)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt, x, y):
        def loss(p):
            return optax.softmax_cross_entropy_with_integer_labels(
                entry.apply(cfg, p, x), y).mean()
        up, opt = tx.update(jax.grad(loss)(params), opt, params)
        return optax.apply_updates(params, up), opt

    for _ in range(40):
        params, opt = step(params, opt, x, y)
    acc = float(jnp.mean(jnp.argmax(entry.apply(cfg, params, x), -1) == y))
    assert acc > 0.9, f"toy model failed to train: acc={acc}"
    tcfg = tvit.VIT_TEST.with_classes(3)
    flat = {p: np.array(v) for p, v in jtrees.flatten_with_paths(params).items()}
    model = tvit.params_from_jax(flat, tcfg)
    return dict(jentry=entry, jcfg=cfg, jp=params, tcfg=tcfg, model=model,
                x=images[:12], y=labels[:12].astype(np.int32))


def _t(toy):
    return torch.from_numpy(toy["x"]), torch.from_numpy(toy["y"])


@pytest.mark.parametrize("n_iter", [1, 2, 5, 10, 20, 37, 100, 250])
def test_checkpoint_iters_and_schedule_match_jax(n_iter):
    assert tapgd.checkpoint_iters(n_iter) == japgd.checkpoint_iters(n_iter)
    sched = tapgd._schedule(n_iter)
    assert len(sched) == n_iter and sum(d for cp, d in sched if cp) <= n_iter
    assert [k for k, (cp, _) in enumerate(sched) if cp] == [
        w for w in japgd.checkpoint_iters(n_iter) if w > 0]


@pytest.mark.parametrize("n", [4, 60, 100, 5000])
def test_p_schedule_and_sides_match_jax(n):
    assert [tsq.p_schedule(i, n, 0.8) for i in range(n)] == [
        jsq.p_schedule(i, n, 0.8) for i in range(n)]
    import math
    want = [max(1, min(31, int(round(math.sqrt(jsq.p_schedule(i, n, 0.8) * 32 * 32)))))
            for i in range(n)]
    assert tsq.square_sides(n, 0.8, 32, 32) == want


def _logits(seed, ties=False):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((9, 7)).astype(np.float32) * 3
    if ties:
        z = np.round(z)  # many ties between classes
    return z, rng.integers(0, 7, 9).astype(np.int32), rng.integers(0, 7, 9).astype(np.int32)


@pytest.mark.parametrize("ties,classes", [(False, 7), (True, 7), (False, 3), (False, 2)])
def test_losses_match_jax(ties, classes):
    """Also with fewer classes than the DLR ranks (JAX clamps the index)."""
    z, y, t = _logits(1, ties)
    z, y, t = z[:, :classes], y % classes, t % classes
    tz, ty, tt = (torch.from_numpy(a) for a in (z, y, t))
    for got, want in ((tapgd.ce_loss(tz, ty), japgd.ce_loss(jnp.asarray(z), jnp.asarray(y))),
                      (tapgd.dlr_loss(tz, ty), japgd.dlr_loss(jnp.asarray(z), jnp.asarray(y))),
                      (tapgd.dlr_targeted_loss(tz, ty, tt),
                       japgd.dlr_targeted_loss(jnp.asarray(z), jnp.asarray(y), jnp.asarray(t))),
                      (tsq.margin_loss(tz, ty), jsq.margin_loss(jnp.asarray(z), jnp.asarray(y)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_target_order_breaks_ties_as_jax():
    """With tied logits the targets are those of a stable ascending sort,
    flipped (``jnp.argsort(logits)[:, ::-1]``); ``argsort(descending=True)``
    would give another order."""
    z = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 1.0],
                  [2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                  [0.5, 0.5, -1.0, 4.0, 0.5, -1.0]], np.float32)
    labels = np.array([2, 0, 3], np.int32)
    want = np.asarray(jnp.argsort(jnp.asarray(z), axis=-1)[:, ::-1])
    got = tapgd.target_order(torch.from_numpy(z))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not torch.equal(got, torch.argsort(torch.from_numpy(z), dim=-1, descending=True))
    order = jnp.asarray(want)
    for k in range(5):
        jt = order[:, 1:][jnp.arange(3), k]
        jt = jnp.where(jt == jnp.asarray(labels), order[:, 0], jt)
        np.testing.assert_array_equal(
            tapgd.target_class(got, torch.from_numpy(labels), k).numpy(), np.asarray(jt))


def test_projection_linf_matches_jax():
    rng = np.random.default_rng(0)
    b, d = 8, 3072
    x = rng.random((b, d)).astype(np.float32)
    w = rng.normal(size=(b, d)).astype(np.float32)
    w[3, : d // 2] = 0.0  # zero weights on half the coordinates
    wx = (w * x).sum(-1)
    phi_max = np.sum(np.abs(w) * np.where(w > 0, 1 - x, x), -1)
    gap = np.array([0.5, 10.0, -1.0, 3.0, 0.0, 0.2 * phi_max[5], 2 * phi_max[6], 1e3],
                   np.float32)  # rows 2 and 4 already crossed, 6 and 7 unreachable
    bb = wx + gap
    got = tfab.projection_linf(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bb))
    want = np.asarray(jfab.projection_linf(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bb)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert (got[2] == 0).all() and (got[4] == 0).all()
    z = x + got.numpy()
    assert z.min() >= -1e-6 and z.max() <= 1 + 1e-6


def test_apgd_ce_matches_jax(toy):
    cfg = dict(eps=EPS, n_iter=12, loss="ce")
    key = jax.random.key(0)
    want_x, want_f = japgd.make_apgd(toy["jentry"].apply, toy["jcfg"], japgd.APGDConfig(**cfg),
                                     normalize=JIDENT)(toy["jp"], toy["x"], toy["y"], key)
    start = japgd.random_start(key, jnp.asarray(toy["x"]), EPS)
    run = tapgd.make_apgd(tvit.apply, toy["tcfg"], tapgd.APGDConfig(**cfg), normalize=TIDENT)
    x, y = _t(toy)
    got_x, got_f = run.from_start(toy["model"], x, y, _np(start))
    _agree(got_x.numpy(), want_x)
    # the best losses, at points that part in < 1% of pixels
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=1e-3)
    _check_ball(got_x, toy["x"], EPS)
    # the ascent happened
    with torch.no_grad():
        clean = tapgd.ce_loss(tvit.apply(toy["tcfg"], toy["model"], x), y)
    assert float((got_f - clean).mean()) > 0
    # the public entry draws its start from the generator
    a = run(toy["model"], x, y, torch.Generator().manual_seed(1))[0]
    assert torch.equal(a, run(toy["model"], x, y, torch.Generator().manual_seed(1))[0])
    _check_ball(a, toy["x"], EPS)


def test_apgd_random_start_is_uniform_in_ball():
    x = torch.full((4, 8, 8, 3), 0.5)
    s = tapgd.random_start(torch.Generator().manual_seed(0), x, 8 / 255)
    d = (s - x).abs().reshape(4, -1)
    assert float(d.max()) <= 8 / 255 + 1e-7 and float(d.max()) > 0
    assert bool((d.amax(1) < 8 / 255 - 1e-9).all())


@pytest.fixture(scope="module")
def wide(toy):
    """``vit_test`` with its 10 classes (random weights from key 0) on the
    toy images, labelled by its own predictions. With 3 classes a target
    that is the least likely class makes the targeted DLR loss constant
    (-(z_y - z_t) / (z_1 - z_3) = -1): its gradient is rounding noise."""
    jp = jvit.init(jax.random.key(0), jvit.VIT_TEST)
    flat = {p: np.array(v) for p, v in jtrees.flatten_with_paths(jp).items()}
    model = tvit.params_from_jax(flat, tvit.VIT_TEST)
    x = torch.from_numpy(toy["x"])
    with torch.no_grad():
        y = tvit.apply(tvit.VIT_TEST, model, x).argmax(-1).to(torch.int32)
    return jp, model, y.numpy()


def test_apgd_targeted_matches_jax(toy, wide):
    jp, model, labels = wide
    cfg = dict(eps=EPS, n_iter=8, n_target_classes=3)
    key = jax.random.key(1)
    want = japgd.make_apgd_targeted(jvit.apply, jvit.VIT_TEST, japgd.APGDConfig(**cfg),
                                    normalize=JIDENT)(jp, toy["x"], labels, key)
    run = tapgd.make_apgd_targeted(tvit.apply, tvit.VIT_TEST, tapgd.APGDConfig(**cfg),
                                   normalize=TIDENT)
    x, y = torch.from_numpy(toy["x"]), torch.from_numpy(labels)
    starts = lambda k: _np(japgd.random_start(jax.random.fold_in(key, k),  # noqa: E731
                                              jnp.asarray(toy["x"]), EPS))
    got = run.with_starts(model, x, y, starts)
    _agree(got.numpy(), want)
    _check_ball(got, toy["x"], EPS)
    assert (got.numpy() != toy["x"]).reshape(12, -1).any(1).sum() >= 6  # most examples flipped
    _check_ball(run(model, x, y, torch.Generator().manual_seed(0)), toy["x"], EPS)


def test_fab_targeted_matches_jax(toy):
    cfg = dict(eps=0.5, n_iter=5, n_target_classes=2)
    want = jfab.make_fab_targeted(toy["jentry"].apply, toy["jcfg"], jfab.FABConfig(**cfg),
                                  normalize=JIDENT)(toy["jp"], toy["x"], toy["y"],
                                                    jax.random.key(0))
    x, y = _t(toy)
    got = tfab.make_fab_targeted(tvit.apply, toy["tcfg"], tfab.FABConfig(**cfg),
                                 normalize=TIDENT)(toy["model"], x, y)
    _agree(got.numpy(), want)
    _check_ball(got, toy["x"], 0.5)
    # the same examples were broken inside the radius, the rest kept their pixels
    moved_t = (got.numpy() != toy["x"]).reshape(12, -1).any(1)
    moved_j = (np.asarray(want) != toy["x"]).reshape(12, -1).any(1)
    np.testing.assert_array_equal(moved_t, moved_j)


def _jax_square_draws(key, b, h, w, c, n_queries):
    stripes = _np(jax.random.uniform(jax.random.fold_in(key, 0), (b, 1, w, c),
                                     minval=-1.0, maxval=1.0))

    def query_draws(i, s):
        r_py, r_px, r_delta = jax.random.split(jax.random.fold_in(key, i + 1), 3)
        return (_np(jax.random.randint(r_py, (b, 1, 1), 0, max(h - s, 1))).long(),
                _np(jax.random.randint(r_px, (b, 1, 1), 0, max(w - s, 1))).long(),
                _np(jax.random.uniform(r_delta, (b, 1, 1, c), minval=-1.0, maxval=1.0)))

    return stripes, query_draws


@pytest.mark.parametrize("every", [7, 100])
def test_square_matches_jax(toy, every):
    cfg = dict(eps=EPS, n_queries=30, exit_check_every=every)
    key = jax.random.key(3)
    want = jsq.make_square(toy["jentry"].apply, toy["jcfg"], jsq.SquareConfig(**cfg),
                           normalize=JIDENT)(toy["jp"], toy["x"], toy["y"], key)
    run = tsq.make_square(tvit.apply, toy["tcfg"], tsq.SquareConfig(**cfg), normalize=TIDENT)
    x, y = _t(toy)
    got = run.with_draws(toy["model"], x, y, *_jax_square_draws(key, 12, 32, 32, 3, 30))
    _agree(got.numpy(), want)
    _check_ball(got, toy["x"], EPS)


def test_square_checks_the_margins_once_per_chunk(toy, monkeypatch):
    """The host reads the margins at chunk boundaries only, and a chunked run
    equals the unchunked one bit for bit (a query on an adversarial example is
    a no-op)."""
    x, y = _t(toy)
    reads = []
    real_bool = torch.Tensor.__bool__

    def counting_bool(t):
        reads.append(1)
        return real_bool(t)

    outs = []
    for every in (1, 7, 60):
        run = tsq.make_square(tvit.apply, toy["tcfg"],
                              tsq.SquareConfig(eps=EPS, n_queries=60, exit_check_every=every),
                              normalize=TIDENT)
        reads.clear()
        monkeypatch.setattr(torch.Tensor, "__bool__", counting_bool)
        outs.append(run(toy["model"], x, y, torch.Generator().manual_seed(3)))
        monkeypatch.setattr(torch.Tensor, "__bool__", real_bool)
        assert len(reads) <= -(-60 // every)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def _suite(toy, **kw):
    kw = {"eps": EPS, "n_iter": 6, "n_target_classes": 2, "square_queries": 20, **kw}
    return taa.make_autoattack(tvit.apply, toy["tcfg"], taa.AutoAttackConfig(**kw),
                               normalize=TIDENT)


def test_suite_reduces_robust_accuracy(toy):
    x, y = _t(toy)
    x_adv = _suite(toy)(toy["model"], x, y, torch.Generator().manual_seed(0))
    _check_ball(x_adv, toy["x"], EPS)
    clean = taa.robust_accuracy(tvit.apply, toy["tcfg"], toy["model"], x, y, normalize=TIDENT)
    rob = taa.robust_accuracy(tvit.apply, toy["tcfg"], toy["model"], x_adv, y, normalize=TIDENT)
    assert rob <= clean and rob < 0.9


def test_suite_compaction_edges(toy):
    """An odd batch with rows already misclassified: those rows are never
    attacked and come back bit for bit; each stage's bucket is its exact
    survivor count."""
    x, y = _t(toy)
    x13, y13 = torch.cat([x, x[:1]]), torch.cat([y, y[:1]]).clone()
    y13[[1, 5, 9]] = (y13[[1, 5, 9]] + 1) % 3
    with torch.no_grad():
        pre = tvit.apply(toy["tcfg"], toy["model"], x13).argmax(-1) != y13
    assert pre.any()
    suite = _suite(toy, n_iter=4, square_queries=12)
    x_adv = suite(toy["model"], x13, y13, torch.Generator().manual_seed(0))
    _check_ball(x_adv, x13, EPS)
    assert torch.equal(x_adv[pre], x13[pre])
    rob = taa.robust_accuracy(tvit.apply, toy["tcfg"], toy["model"], x_adv, y13, normalize=TIDENT)
    assert rob <= 1.0 - float(pre.float().mean()) + 1e-6
    first, bucket = next(iter(suite.stats))
    assert first == "apgd-ce" and bucket == int((~pre).sum())
    buckets = [k[1] for k in suite.stats]
    assert buckets == sorted(buckets, reverse=True) and all(b > 0 for b in buckets)


def test_suite_stage_selection(toy):
    x, y = _t(toy)
    one = _suite(toy, attacks=("square",))
    _check_ball(one(toy["model"], x, y), toy["x"], EPS)
    assert [k[0] for k in one.stats] == ["square"]
    with pytest.raises(ValueError):
        _suite(toy, attacks=("bogus",))


def test_suite_stats_attribution(toy):
    """One entry per call, keyed by (stage, survivors): the same clean
    pattern twice gives the first stage's key two entries."""
    x, y = _t(toy)
    suite = _suite(toy, n_iter=3, square_queries=8)
    assert suite.stats == {}
    suite(toy["model"], x, y, torch.Generator().manual_seed(0))
    suite(toy["model"], x, y, torch.Generator().manual_seed(1))
    assert suite.stats
    for (name, bucket), ts in suite.stats.items():
        assert name in ("apgd-ce", "apgd-t", "fab-t", "square")
        assert isinstance(bucket, int) and 0 < bucket <= 12
        assert all(t > 0 for t in ts)
    first_key = next(k for k in suite.stats if k[0] == "apgd-ce")
    assert len(suite.stats[first_key]) == 2


def _bf16_block_model(toy):
    cfg = dataclasses.replace(toy["tcfg"], compute_dtype="bfloat16", fuse_attn_block=True)
    return cfg, tvit.params_from_jax(tvit.params_to_jax(toy["model"]), cfg)


def _attacks(cfg):
    """Each new attack as ``fn(model, x, y)``."""
    pc = tpatch.PatchConfig(patch_size=8, iters=2, batch_size=4)
    return {
        "patch": lambda m, x, y: tpatch.make_train_patch(tvit.apply, cfg, pc)(m, x, y)[0],
        "apgd-ce": lambda m, x, y: tapgd.make_apgd(
            tvit.apply, cfg, tapgd.APGDConfig(eps=EPS, n_iter=2))(m, x, y)[0],
        "apgd-t": lambda m, x, y: tapgd.make_apgd_targeted(
            tvit.apply, cfg, tapgd.APGDConfig(eps=EPS, n_iter=2, n_target_classes=1))(m, x, y),
        "fab-t": lambda m, x, y: tfab.make_fab_targeted(
            tvit.apply, cfg, tfab.FABConfig(eps=EPS, n_iter=2, n_target_classes=1))(m, x, y),
        "square": lambda m, x, y: tsq.make_square(
            tvit.apply, cfg, tsq.SquareConfig(eps=EPS, n_queries=3))(m, x, y),
        "suite": lambda m, x, y: taa.make_autoattack(
            tvit.apply, cfg, taa.AutoAttackConfig(eps=EPS, n_iter=2, n_target_classes=1,
                                                  square_queries=3))(m, x, y),
    }


@pytest.mark.parametrize("name", ["patch", "apgd-ce", "apgd-t", "fab-t", "square", "suite"])
def test_attacks_restore_flags_and_take_no_parameter_gradient(toy, name, monkeypatch):
    """With ``fuse_attn_block`` (bf16; its plain version on the CPU through the
    kernel's ``autograd.Function``) no attack makes a parameter-gradient
    call, and each parameter's ``requires_grad`` flag is as the caller left
    it, also when the attack raises."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import attn_block as tab

    cfg, model = _bf16_block_model(toy)
    params = list(model.parameters())
    for i, p in enumerate(params):
        p.requires_grad_(i % 3 != 0)
    flags = [p.requires_grad for p in params]
    x, y = _t(toy)
    before = (tab.PARAM_GRAD_CALLS, tab.FWD_LAUNCHES)
    _attacks(cfg)[name](model, x, y)
    assert tab.PARAM_GRAD_CALLS == before[0]
    assert [p.requires_grad for p in params] == flags

    seen = []

    def failing_apply(c, m, images):
        seen.append(any(p.requires_grad for p in m.parameters()))
        raise RuntimeError("boom")

    monkeypatch.setattr(tvit, "apply", failing_apply)
    with pytest.raises(RuntimeError, match="boom"):
        _attacks(cfg)[name](model, x, y)
    assert seen == [False] and [p.requires_grad for p in params] == flags
