"""The port's training modules against the JAX package at ``vit_test`` size:
optimizers against optax on a fixed gradient sequence (1e-6), the train step
against the JAX train step from the same checkpoint (f32, 1e-4), the padding
mask, the resume files, and the two trainers (``train_base_model``: resume,
best checkpoint preserved, save throttle; ``train_lora_adapter``: base
frozen, adapter directories that the JAX reader loads)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data import synthetic as tsynth
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data.loader import Loader, MetadataIndex
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry as treg
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit as tvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora as tlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.train import loop as tloop
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.train import optim as toptim
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.train import steps as tsteps
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import checkpoint as tck
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import observability as tobs
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees as ttrees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils.vocab import LabelVocabulary
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import vit as jvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import peft_io as jpeft
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.train import optim as joptim
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.train import steps as jsteps
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import observability as jobs
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

JCFG, TCFG = jvit.VIT_TEST, tvit.VIT_TEST


@pytest.mark.parametrize("which", ["adamw_steplr", "lora_adam"])
def test_optimizer_matches_optax_on_a_fixed_gradient_sequence(which):
    """Seven updates with gradients from a numpy seed; the StepLR boundary
    falls inside (2 steps per epoch, decay every epoch), and the lr of an
    update is the schedule at the count of updates made before it."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(7)]
    kw = dict(weight_decay=0.05, step_size_epochs=1, gamma=0.5, steps_per_epoch=2)
    tx = joptim.adamw_steplr(1e-2, **kw) if which == "adamw_steplr" else joptim.lora_adam(1e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in p0.items()}
    opt, sched = (toptim.adamw_steplr(tp.values(), 1e-2, **kw) if which == "adamw_steplr"
                  else toptim.lora_adam(tp.values(), 1e-2))
    assert (sched is None) == (which == "lora_adam")
    for step, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k].copy())
        if sched is not None:
            for group in opt.param_groups:
                group["lr"] = sched(step)
        opt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6,
                                       rtol=1e-6, err_msg=f"{k} after update {step}")
    if sched is not None:
        assert [sched(c) for c in (0, 1, 2, 5, 6)] == pytest.approx(
            [1e-2, 1e-2, 5e-3, 2.5e-3, 1.25e-3])


def _problem(seed=0):
    params = jvit.init(jax.random.key(seed), JCFG)
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    labels = (np.arange(8) % JCFG.num_classes).astype(np.int32)
    return params, images, labels


def _port_model(jparams, cfg=TCFG):
    return tvit.params_from_jax(
        {p: np.array(v) for p, v in jtrees.flatten_with_paths(jparams).items()}, cfg)


def test_train_step_matches_jax_for_three_steps():
    """No augmentation, no dropout, Adam(1e-3), uint8 images, ImageNet
    normalization on the device: per-step loss, correct count and every
    parameter after three updates (f32; 1e-4)."""
    jparams, images, labels = _problem()
    valid = np.ones(8, np.float32)
    tx = optax.adam(1e-3)
    jstep = jsteps.make_train_step(lambda p, x: jvit.apply(JCFG, p, x), tx)
    jstate = jsteps.TrainState.create(jax.tree.map(jnp.copy, jparams), tx)
    model = _port_model(jparams)
    state = tsteps.TrainState.create(model, None, lambda ps: (torch.optim.Adam(list(ps), lr=1e-3), None))
    tstep = tsteps.make_train_step(lambda m, x: tvit.apply(TCFG, m, x), model)
    for _ in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(valid))
        state, tm = tstep(state, torch.from_numpy(images), torch.from_numpy(labels),
                          torch.from_numpy(valid))
        assert all(isinstance(v, torch.Tensor) for v in tm.values())  # sums stay on the device
        for k in ("loss_sum", "correct", "count"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-4, rtol=1e-4, err_msg=k)
    assert state.step == int(jstate.step) == 3
    got = tvit.params_to_jax(model)
    for p, v in jtrees.flatten_with_paths(jstate.params).items():
        if p == "blocks/attn/k/b":
            # a bias on every key leaves the softmax as it is: this gradient is
            # zero in exact arithmetic, each framework's is its own rounding
            # noise, and Adam scales noise to full steps. Both stay within
            # three steps of lr of the zero init.
            assert np.abs(got[p].numpy()).max() <= 3e-3 + 1e-6 >= np.abs(np.asarray(v)).max()
            continue
        np.testing.assert_allclose(got[p].numpy(), np.asarray(v), atol=1e-4, rtol=1e-4, err_msg=p)


def test_padding_rows_are_excluded():
    jparams, images, labels = _problem()
    valid = torch.tensor([1, 1, 1, 1, 0, 0, 0, 0], dtype=torch.float32)
    sums = []
    for garbage in (False, True):
        model = _port_model(jparams)
        state = tsteps.TrainState.create(model, None, lambda ps: (torch.optim.SGD(list(ps), lr=0.0), None))
        step = tsteps.make_train_step(lambda m, x: tvit.apply(TCFG, m, x), model)
        x = torch.from_numpy(images.copy())
        if garbage:
            x[4:] = 186
        _, m = step(state, x, torch.from_numpy(labels), valid)
        assert float(m["count"]) == 4.0
        sums.append(float(m["loss_sum"]))
    assert sums[0] == pytest.approx(sums[1], rel=1e-5)
    with pytest.raises(ValueError):
        tsteps.make_train_step(lambda m, x: m(x), None, augment=lambda x, g: x)


def test_train_state_freezes_what_is_not_named():
    jparams, _, _ = _problem()
    model = _port_model(jparams)
    state = tsteps.TrainState.create(model, ["head.w", "head.b"], lambda ps: toptim.lora_adam(ps, 1e-3))
    assert set(state.trainable) == {"head.w", "head.b"}
    assert [n for n, p in model.named_parameters() if p.requires_grad] == ["head.w", "head.b"]
    with pytest.raises(KeyError):
        tsteps.TrainState.create(model, ["head.nope"], lambda ps: toptim.lora_adam(ps, 1e-3))


def test_resume_file_continues_a_run_exactly(tmp_path):
    """Two updates, save, load into a fresh state, one more update: the same
    parameters as three updates in a row, and the same update count and lr."""
    jparams, images, labels = _problem()
    batch = (torch.from_numpy(images), torch.from_numpy(labels), torch.ones(8))
    make = lambda ps: toptim.adamw_steplr(ps, 1e-3, steps_per_epoch=1, step_size_epochs=2, gamma=0.5)

    def run(n, state, model):
        step = tsteps.make_train_step(lambda m, x: tvit.apply(TCFG, m, x), model)
        for _ in range(n):
            step(state, *batch)

    straight = _port_model(jparams)
    s0 = tsteps.TrainState.create(straight, None, make)
    run(3, s0, straight)

    first = _port_model(jparams)
    s1 = tsteps.TrainState.create(first, None, make)
    run(2, s1, first)
    prefix = str(tmp_path / "resume")
    assert not tck.train_state_exists(prefix)
    tck.save_train_state(s1, prefix, meta={"epoch": 1})
    assert tck.train_state_exists(prefix)
    second = _port_model(jvit.init(jax.random.key(9), JCFG))  # other weights: the file must win
    s2 = tsteps.TrainState.create(second, None, make)
    meta = tck.load_train_state(prefix, s2)
    assert meta["epoch"] == 1 and s2.step == 2
    run(1, s2, second)
    assert s2.optimizer.param_groups[0]["lr"] == s0.optimizer.param_groups[0]["lr"] == 5e-4
    for (n, a), (_, b) in zip(straight.named_parameters(), second.named_parameters()):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6, msg=n)
    lora_state = tsteps.TrainState.create(_port_model(jparams), ["head.w"], make)
    with pytest.raises(ValueError):
        tck.load_train_state(prefix, lora_state)


def test_metrics_logger_writes_the_jax_keys(tmp_path):
    recs = {}
    for name, mod in (("port", tobs), ("jax", jobs)):
        path = str(tmp_path / f"{name}.jsonl")
        with mod.MetricsLogger(path) as m:
            m.log("train_start", model="vit_test", epochs=2)
            m.log("epoch", step=1, train_loss=np.float32(0.5), seconds=1.25)
        recs[name] = [json.loads(line) for line in open(path)]
    for a, b in zip(recs["port"], recs["jax"]):
        assert {k: v for k, v in a.items() if k != "ts"} == {k: v for k, v in b.items() if k != "ts"}
        assert isinstance(a["ts"], float)
    tobs.assert_finite({"a": {"b": torch.ones(3)}, "n": torch.arange(3)})
    with pytest.raises(FloatingPointError, match="a/b: 1/3"):
        tobs.assert_finite({"a": {"b": torch.tensor([1.0, float("nan"), 2.0])}})


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train") / "d")
    tsynth.make_synthetic_dataset(root, n_per_class=4, image_size=32)
    vocab = LabelVocabulary.from_classes(tsynth.DEFAULT_CLASSES)
    mk = lambda s, **kw: Loader(MetadataIndex(f"{root}/{s}/metadata.csv", vocab), batch_size=10,
                                image_size=32, resize=32, **kw)
    return vocab, mk


def _base(vocab, seed=0):
    entry = treg.get_model("vit_test")
    return entry, entry.init(entry.config(len(vocab)), torch.Generator().manual_seed(seed))


def test_train_base_model_resume(data, tmp_path):
    """Stopping after epoch 0 and restarting with resume=True continues from
    epoch 1 with the optimizer state intact; the result files are there."""
    vocab, mk = data
    entry, params = _base(vocab)
    out = str(tmp_path / "out")
    kw = dict(out_dir=out, device="cpu", log=lambda s: None, augment=True, seed=3)
    tloop.train_base_model(entry, params, mk("train", shuffle=True), mk("val"), None, vocab,
                           epochs=1, **kw)
    assert os.path.exists(os.path.join(out, "resume.state.safetensors"))
    logs = []
    summary = tloop.train_base_model(entry, params, mk("train", shuffle=True), mk("val"),
                                     mk("test"), vocab, epochs=2, resume=True,
                                     **{**kw, "log": logs.append})
    assert any("resuming from epoch 1 (step 2)" in s for s in logs)
    assert [h["epoch"] for h in summary["history"]] == [1]
    assert 0.0 <= summary["test_accuracy"] <= 1.0
    for f in ("class_mappings.txt", "metrics.jsonl", "training_results.csv",
              "vit_test_best_model_finetuned.safetensors", "vit_test_final_model.safetensors"):
        assert os.path.exists(os.path.join(out, f)), f
    assert len(open(os.path.join(out, "training_results.csv")).read().splitlines()) == 3
    events = [json.loads(line)["event"] for line in open(os.path.join(out, "metrics.jsonl"))]
    assert events == ["train_start", "epoch", "train_start", "epoch"]
    # the caller's tree was not trained in place
    fresh = _base(vocab)[1]
    assert all(torch.equal(a, b) for a, b in zip(ttrees.flatten_with_paths(params).values(),
                                                 ttrees.flatten_with_paths(fresh).values()))


def test_trainers_have_no_device_default(data, tmp_path):
    """The trainers run where the caller says and nowhere by default: leaving
    ``device`` out is an error, not a quiet run on the CPU."""
    vocab, mk = data
    entry, params = _base(vocab)
    cfg = entry.config(len(vocab))
    lcfg = tlora.LoRAConfig(rank=4, targets=entry.lora_targets(cfg))
    with pytest.raises(TypeError, match="device"):
        tloop.train_base_model(entry, params, mk("train"), mk("val"), None, vocab,
                               out_dir=str(tmp_path / "a"))
    with pytest.raises(TypeError, match="device"):
        tloop.train_lora_adapter(entry, params, lcfg, mk("train"), mk("val"), vocab,
                                 out_dir=str(tmp_path / "b"))
    with pytest.raises(TypeError, match="device"):
        tloop.fit(lambda m, x: m, None, None, [], None, epochs=0, num_classes=len(vocab),
                  normalize=None, snapshot=dict)
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()


def test_resume_preserves_best_checkpoint(data, tmp_path):
    """A resumed run must not replace a better best checkpoint from before
    the restart with worse parameters from after it."""
    vocab, mk = data
    entry, params = _base(vocab)
    out = str(tmp_path / "out")
    kw = dict(out_dir=out, device="cpu", log=lambda s: None, augment=False)
    s1 = tloop.train_base_model(entry, params, mk("train"), mk("val"), None, vocab, epochs=1, **kw)
    assert os.path.exists(os.path.join(out, "resume.best.safetensors"))
    # make every later epoch worse than the first: a huge learning rate
    s2 = tloop.train_base_model(entry, params, mk("train"), mk("val"), None, vocab, epochs=3,
                                resume=True, lr=10.0, **kw)
    assert s2["best_val_accuracy"] >= s1["best_val_accuracy"] - 1e-9
    if s2["best_epoch"] == 0:  # the carried best won: the saved file is the first run's
        best, _ = tck.load_pytree(os.path.join(out, "vit_test_best_model_finetuned.safetensors"))
        kept, _ = tck.load_pytree(os.path.join(out, "resume.best.safetensors"))
        assert all(torch.equal(a, b) for a, b in zip(ttrees.flatten_with_paths(best).values(),
                                                     ttrees.flatten_with_paths(kept).values()))


def test_resume_save_throttle(data, tmp_path, monkeypatch):
    """With a large ``resume_save_s`` only the first epoch after the start and
    the final epoch save; with 0 every epoch saves; the throttled final save
    still carries a best checkpoint."""
    vocab, mk = data
    entry, params = _base(vocab)
    calls = []
    orig = tck.save_train_state
    monkeypatch.setattr(tloop.checkpoint, "save_train_state",
                        lambda *a, **k: (calls.append(k["meta"]["epoch"]), orig(*a, **k))[1])
    kw = dict(epochs=3, device="cpu", log=lambda s: None, augment=False)
    tloop.train_base_model(entry, params, mk("train"), mk("val"), None, vocab,
                           out_dir=str(tmp_path / "throttled"), resume_save_s=3600.0, **kw)
    assert calls == [0, 2]
    assert os.path.exists(str(tmp_path / "throttled" / "resume.best.safetensors"))
    calls.clear()
    tloop.train_base_model(entry, params, mk("train"), mk("val"), None, vocab,
                           out_dir=str(tmp_path / "eager"), resume_save_s=0.0, **kw)
    assert calls == [0, 1, 2]


def test_saved_checkpoint_reproduces_in_memory_logits_in_both_packages(data, tmp_path):
    """The best checkpoint the port writes gives, loaded by the port and by
    the JAX package, the logits of the tree it was saved from (1e-4)."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import checkpoint as jck

    vocab, mk = data
    entry, params = _base(vocab)
    out = str(tmp_path / "out")
    summary = tloop.train_base_model(entry, params, mk("train"), mk("val"), None, vocab,
                                     out_dir=out, device="cpu", epochs=2, lr=1e-3,
                                     log=lambda s: None, augment=False)
    cfg = entry.config(len(vocab))
    x = np.random.default_rng(0).random((3, 32, 32, 3), dtype=np.float32)
    tree, meta = tck.load_pytree(summary["checkpoint"])
    assert meta["best_epoch"] == summary["best_epoch"] and meta["classes"] == list(vocab.classes)
    with torch.no_grad():
        got = entry.apply(cfg, entry.from_tree(tree, cfg), torch.from_numpy(x)).numpy()
    jtree, _ = jck.load_pytree(summary["checkpoint"])
    want = np.asarray(jvit.apply(JCFG.with_classes(len(vocab)), jtree, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    start = entry.apply(cfg, entry.from_tree(params, cfg), torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - start).max() > 1e-3  # it is a trained tree


@pytest.mark.parametrize("mode", ["input", "post_a"])
def test_train_lora_adapter_base_frozen_and_loads_in_jax(mode, data, tmp_path):
    vocab, mk = data
    entry, params = _base(vocab)
    before = {p: v.clone() for p, v in ttrees.flatten_with_paths(params).items()}
    cfg = entry.config(len(vocab))
    lcfg = tlora.LoRAConfig(rank=4, alpha=16.0, targets=entry.lora_targets(cfg), dropout=0.1,
                            dropout_mode=mode)
    out = str(tmp_path / "lora")
    res = tloop.train_lora_adapter(entry, params, lcfg, mk("train", shuffle=True), mk("val"),
                                   vocab, out_dir=out, device="cpu", epochs=2, lr=5e-3,
                                   log=lambda s: None)
    assert all(torch.equal(v, before[p]) for p, v in ttrees.flatten_with_paths(params).items())
    assert [h["epoch"] for h in res["history"]] == [0, 1]
    assert res["history"][1]["train_loss"] < res["history"][0]["train_loss"]
    best = res["best_trainable"]
    assert set(best) == {"adapter", "head"} and set(best["adapter"]) == set(lcfg.targets)
    assert all(float(f["b"].abs().max()) > 0 for f in best["adapter"].values())
    assert not torch.equal(best["head"]["w"], params["head"]["w"])
    for tag in ("best", "final"):
        ad, jcfg, head = jpeft.load_peft_adapter(os.path.join(out, f"rank4_{tag}_adapter"))
        assert (jcfg.rank, jcfg.alpha, jcfg.dropout) == (4, 16.0, 0.1)
        assert set(ad) == set(lcfg.targets) and head["w"].shape == (TCFG.hidden_dim, len(vocab))
    for p, fac in best["adapter"].items():
        np.testing.assert_array_equal(np.asarray(ad[p]["a"]).shape, fac["a"].shape)
    ad_best, _, head_best = jpeft.load_peft_adapter(res["adapter_dir"])
    for p, fac in best["adapter"].items():
        np.testing.assert_allclose(np.asarray(ad_best[p]["b"]), fac["b"].numpy(), atol=0, rtol=0)
    np.testing.assert_allclose(np.asarray(head_best["b"]), best["head"]["b"].numpy(), atol=0, rtol=0)

    # inside the trainer: what is frozen stays bitwise, what is trained moves
    model, state, snapshot = tloop.lora_trainer(entry, cfg, params, lcfg, lr=5e-3, train_head=True,
                                                seed=1, device=torch.device("cpu"))
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n not in state.trainable}
    assert len(state.trainable) == 2 * 4 * TCFG.depth + 2 and "blocks.0.attn.q.lora_s" in frozen
    tloop.fit(lambda m, x: entry.apply(cfg, m, x), model, state, mk("train"), None, epochs=1,
              num_classes=len(vocab), normalize=None, snapshot=snapshot, device="cpu", log=lambda s: None)
    named = dict(model.named_parameters())
    assert all(torch.equal(t, named[n]) for n, t in frozen.items())
    assert not model.training


def test_profile_trace_writes_a_trace_and_is_inert_without_a_dir(tmp_path):
    with tobs.profile_trace("") as prof:
        assert prof is None
    with tobs.profile_trace(str(tmp_path / "trace")) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert any(ev.name == "aten::mm" for ev in prof.events())
    (written,) = os.listdir(tmp_path / "trace")
    assert written.endswith(".pt.trace.json")
    assert json.load(open(tmp_path / "trace" / written))["traceEvents"]
