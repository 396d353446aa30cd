"""Training the Swin, ConvNeXt and YOLO11-cls backbones in the port against
the JAX package (``swin_test``, ``convnext_test``, ``yolo11_test``, f32).

* Three train steps (Adam 1e-3, no augmentation, uint8 images normalized
  on the device) against the JAX train step from the same params: the loss
  sums per step and every parameter after three updates at 1e-4. Swin's
  fused ``qkv/b`` holds the key bias in its middle third: a bias on every
  key leaves the softmax as it is, so its gradient is zero in exact
  arithmetic and each framework's is its own rounding noise, which Adam
  scales to full steps. That third is bounded by three steps of lr from the
  zero init; the q and v thirds are compared.
* ``train_lora_adapter``: the caller's base bitwise unchanged, every frozen
  parameter bitwise unchanged inside the trainer, the adapter directory
  read by the JAX reader (YOLO11's nested head under ``framework_head.``),
  the trained adapter merged into the base equal to the unmerged model.
* The CLI's five stages in the port alone (``synth-data`` -> ``train`` ->
  ``attack`` -> ``train-lora`` -> ``eval-compose``): Swin from a JAX-written
  tree, ConvNeXt from a JAX-written tree of another class count (a new,
  zero-initialized classifier), YOLO11 from an ultralytics-named ``.pth``
  through ``load_pretrained``; then the JAX CLI's ``eval-compose`` over the
  YOLO11 run's files gives the port's matrix.
"""

import importlib
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
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import hf_import as thf
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry as treg
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora as tlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.train import loop as tloop
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.train import steps as tsteps
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import checkpoint as tck
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees as ttrees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils.vocab import LabelVocabulary
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import registry as jreg
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import peft_io as jpeft
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.train import steps as jsteps
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import checkpoint as jck
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

# the CLI modules (each package's ``cli`` exports the function ``main`` under the same name)
tcli = importlib.import_module(
    "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.cli.main")
jcli = importlib.import_module(
    "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.cli.main")

BACKBONES = ["swin_test", "convnext_test", "yolo11_test"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: under pytest-xdist the
    workers share the cores, and a pool of one thread per core makes each
    small eager op wait on the other workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_flat(name, classes, seed=0):
    entry = jreg.get_model(name)
    params = entry.init(jax.random.key(seed), entry.config(classes))
    return {p: np.array(v) for p, v in jtrees.flatten_with_paths(params).items()}


@pytest.mark.parametrize("name", BACKBONES)
def test_train_step_matches_jax_for_three_steps(name):
    je, te = jreg.get_model(name), treg.get_model(name)
    jc, tc = je.config(10), te.config(10)
    flat = _jax_flat(name, 10)
    rng = np.random.default_rng(1)
    s = tc.image_size
    images = rng.integers(0, 256, (8, s, s, 3), dtype=np.uint8)
    labels = (np.arange(8) % 10).astype(np.int32)
    valid = np.ones(8, np.float32)
    tx = optax.adam(1e-3)
    jstep = jsteps.make_train_step(lambda p, x: je.apply(jc, p, x), tx)
    jstate = jsteps.TrainState.create(jtrees.unflatten_from_paths(
        {p: jnp.asarray(v) for p, v in flat.items()}), tx)
    model = te.from_tree(flat, tc)
    state = tsteps.TrainState.create(
        model, None, lambda ps: (torch.optim.Adam(list(ps), lr=1e-3), None))
    tstep = tsteps.make_train_step(lambda m, x: te.apply(tc, m, x), model)
    for _ in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(valid))
        state, tm = tstep(state, torch.from_numpy(images), torch.from_numpy(labels),
                          torch.from_numpy(valid))
        for k in ("loss_sum", "correct", "count"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-4, rtol=1e-4, err_msg=k)
    assert state.step == int(jstate.step) == 3
    # every leaf is trained (YOLO11's BN statistics too, as in JAX)
    assert sum(p.numel() for p in state.trainable.values()) == sum(v.size for v in flat.values())
    got = te.to_tree(model)
    for p, v in jtrees.flatten_with_paths(jstate.params).items():
        g, w = got[p].numpy(), np.asarray(v)
        if name == "swin_test" and p.endswith("attn/qkv/b"):
            c = w.shape[-1] // 3
            for sl in (slice(0, c), slice(2 * c, 3 * c)):
                np.testing.assert_allclose(g[..., sl], w[..., sl], atol=1e-4, rtol=1e-4, err_msg=p)
            key_g, key_w = g[..., c:2 * c], w[..., c:2 * c]
            assert np.abs(key_g).max() <= 3e-3 + 1e-6 >= np.abs(key_w).max(), p
            continue
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=p)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_backbones") / "d")
    tsynth.make_synthetic_dataset(root, n_per_class=4, image_size=32)
    vocab = LabelVocabulary.from_classes(tsynth.DEFAULT_CLASSES)

    def mk(split, size, **kw):
        return Loader(MetadataIndex(f"{root}/{split}/metadata.csv", vocab), batch_size=10,
                      image_size=size, resize=size, **kw)

    return vocab, mk


@pytest.mark.parametrize("name", BACKBONES)
def test_train_lora_adapter_base_frozen_and_loads_in_jax(name, data, tmp_path):
    vocab, mk = data
    entry = treg.get_model(name)
    cfg = entry.config(len(vocab))
    params = entry.init(cfg, torch.Generator().manual_seed(0))
    before = {p: v.clone() for p, v in ttrees.flatten_with_paths(params).items()}
    lcfg = tlora.LoRAConfig(rank=4, alpha=16.0, targets=entry.lora_targets(cfg), dropout=0.1)
    out = str(tmp_path / "lora")
    size = cfg.image_size
    res = tloop.train_lora_adapter(entry, params, lcfg, mk("train", size, shuffle=True),
                                   mk("val", size), vocab, out_dir=out, device="cpu", epochs=2,
                                   lr=5e-3, log=lambda s: None)
    assert all(torch.equal(v, before[p]) for p, v in ttrees.flatten_with_paths(params).items())
    best = res["best_trainable"]
    assert set(best) == {"adapter", "head"} and set(best["adapter"]) == set(lcfg.targets)
    assert all(float(f["b"].abs().max()) > 0 for f in best["adapter"].values())
    head_paths = {p for p in before if p.startswith("head/")}
    assert {f"head/{p}" for p in ttrees.flatten_with_paths(best["head"])} == head_paths
    ad, jcfg, head = jpeft.load_peft_adapter(res["adapter_dir"])
    assert (jcfg.rank, jcfg.alpha, jcfg.dropout) == (4, 16.0, 0.1) and set(ad) == set(lcfg.targets)
    for p, fac in best["adapter"].items():
        for k in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(ad[p][k]), fac[k].numpy(), err_msg=p)
    got_head = jtrees.flatten_with_paths(head)
    for p, v in ttrees.flatten_with_paths(best["head"]).items():
        np.testing.assert_array_equal(np.asarray(got_head[p]), v.numpy(), err_msg=p)

    # inside the trainer: what is frozen stays bitwise, what is trained moves;
    # the trained adapter merged into the base is the unmerged model
    model, state, snapshot = tloop.lora_trainer(entry, cfg, params, lcfg, lr=5e-3,
                                                train_head=True, seed=1, device=torch.device("cpu"))
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n not in state.trainable}
    trained0 = {n: p.detach().clone() for n, p in state.trainable.items()}
    assert sum(p.numel() for p in state.trainable.values()) == sum(
        f[k].numel() for f in best["adapter"].values() for k in "ab") + sum(
        before[p].numel() for p in head_paths)
    tloop.fit(lambda m, x: entry.apply(cfg, m, x), model, state, mk("train", size), None,
              epochs=1, num_classes=len(vocab), normalize=None, snapshot=snapshot, device="cpu",
              log=lambda s: None)
    named = dict(model.named_parameters())
    assert all(torch.equal(t, named[n]) for n, t in frozen.items())
    assert all(not torch.equal(t, named[n]) for n, t in trained0.items())
    trained = snapshot()
    merged = dict(tlora.merge(params, trained["adapter"], lcfg))
    merged["head"] = trained["head"]
    x = torch.rand(3, size, size, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        np.testing.assert_allclose(entry.apply(cfg, entry.from_tree(merged, cfg), x).numpy(),
                                   entry.apply(cfg, model, x).numpy(), atol=1e-4, rtol=1e-4)


def test_rehead_replaces_only_the_classifier():
    """``train --checkpoint`` with a tree of another class count: a new,
    zero-initialized classifier; YOLO11's nested head keeps its conv."""
    for name, path in (("yolo11_test", "head/linear"), ("convnext_test", "head")):
        entry = treg.get_model(name)
        tree = entry.init(entry.config(10), torch.Generator().manual_seed(0))
        assert tcli._rehead(tree, 10) is tree
        new = ttrees.flatten_with_paths(tcli._rehead(tree, 4))
        src = ttrees.flatten_with_paths(tree)
        assert set(new) == set(src)
        for p, v in new.items():
            if p.startswith(path + "/"):
                assert v.shape[-1] == 4 and v.dtype == src[p].dtype and not v.any(), p
            else:
                assert torch.equal(v, src[p]), p


def _pth_ultralytics(path, classes):
    cfg = treg.get_model("yolo11_test").config(classes)
    torch.save(thf.ultralytics_from_yolo11_params(
        treg.get_model("yolo11_test").init(cfg, torch.Generator().manual_seed(4)), cfg), path)


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """The five stages in the port alone for each backbone, over one
    synthetic dataset (5 classes): ``train`` from a JAX-written tree of 5
    classes (Swin), of 10 classes (ConvNeXt), and from an ultralytics
    ``.pth`` of 10 classes (YOLO11)."""
    root = tmp_path_factory.mktemp("pipelines")
    data = str(root / "data")
    C = ["--device", "cpu"]
    assert tcli.main([*C, "synth-data", "--output_dir", data, "--n_per_class", "3",
                      "--image_size", "40"]) == 0
    out = {}
    for name, classes in (("swin_test", 5), ("convnext_test", 10), ("yolo11_test", 10)):
        (root / name).mkdir()
        d = {k: str(root / name / k) for k in ("t", "adv", "loras", "eval")}
        if name == "yolo11_test":
            start = str(root / name / "yolo11n-cls.pth")
            _pth_ultralytics(start, classes)
        else:
            start = str(root / name / "start.safetensors")
            entry = jreg.get_model(name)
            jck.save_pytree(entry.init(jax.random.key(3), entry.config(classes)), start)
        size = treg.get_model(name).config(5).image_size
        assert tcli.main([*C, "train", "--data_root", data, "--model", name,
                          "--output_dir", d["t"], "--checkpoint", start, "--epochs", "1",
                          "--batch_size", "8", "--resize", str(size),
                          "--learning_rate", "1e-3"]) == 0
        ck = os.path.join(d["t"], name, "all", f"{name}_best_model_finetuned.safetensors")
        assert tcli.main([*C, "attack", "--data_root", data, "--model", name, "--model_path", ck,
                          "--output_dir", d["adv"], "--steps", "2", "--batch_size", "8",
                          "--splits", "train", "test"]) == 0
        assert tcli.main([*C, "train-lora", "--data_root", data, "--model", name,
                          "--model_path", ck, "--adv_root", d["adv"], "--output_dir", d["loras"],
                          "--attacks", "fgsm", "pgd", "--ranks", "4", "--epochs", "1",
                          "--batch_size", "8"]) == 0
        compose = ["eval-compose", "--data_root", data, "--model", name, "--model_path", ck,
                   "--adv_root", d["adv"], "--lora_root", d["loras"], "--rank", "4",
                   "--batch_size", "8"]
        assert tcli.main([*C, *compose, "--output_dir", d["eval"]]) == 0
        out[name] = {**d, "ck": ck, "start": start, "compose": compose}
    return out


@pytest.mark.parametrize("name", BACKBONES)
def test_five_stages_run_in_the_port_alone(name, pipelines):
    run = pipelines[name]
    tree, meta = tck.load_pytree(run["ck"])
    assert meta["classes"] == list(tsynth.DEFAULT_CLASSES)
    flat = ttrees.flatten_with_paths(tree)
    cls_w = flat["head/linear/w" if name == "yolo11_test" else "head/w"]
    assert cls_w.shape[-1] == 5 and bool(cls_w.any())  # trained from the re-initialized head
    if name == "swin_test":  # the start tree had these classes: trained from it
        start, _ = jck.load_pytree(run["start"])
        assert not np.array_equal(np.asarray(start["head"]["w"]), cls_w.numpy())
    for attack in ("fgsm", "pgd"):
        d = os.path.join(run["loras"], name, "all", attack)
        assert json.load(open(os.path.join(d, "results.json")))["rank4"]["rank"] == 4
        ad, _, head = jpeft.load_peft_adapter(os.path.join(d, "rank4_best_adapter"))
        assert set(ad) == set(treg.get_model(name).lora_targets(treg.get_model(name).config(5)))
        assert ("linear" in head) == (name == "yolo11_test")
    got = json.load(open(os.path.join(run["eval"], "test_results.json")))
    assert list(got) == ["base", "lora_fgsm", "lora_pgd", "fgsm+pgd"]
    assert all(list(per) == ["clean", "fgsm", "pgd"] for per in got.values())
    assert all(m["support"] == 15 for per in got.values() for m in per.values())


def test_yolo11_eval_compose_matches_jax_cli(pipelines, tmp_path):
    """The JAX CLI's ``eval-compose`` over the YOLO11 run's checkpoint,
    adversarial PNGs and adapters (nested heads): the port's matrix
    (accuracy and support equal, F1 and loss within rtol 1e-4)."""
    run = pipelines["yolo11_test"]
    assert jcli.main(["--platform", "cpu", *run["compose"],
                      "--output_dir", str(tmp_path / "jax")]) == 0
    got = json.load(open(os.path.join(run["eval"], "test_results.json")))
    want = json.load(open(tmp_path / "jax" / "test_results.json"))
    assert list(got) == list(want)
    for variant, per_ds in want.items():
        assert list(got[variant]) == list(per_ds)
        for ds, m in per_ds.items():
            g = got[variant][ds]
            assert g["accuracy"] == m["accuracy"] and g["support"] == m["support"]
            np.testing.assert_allclose(g["f1"], m["f1"], rtol=1e-4)
            np.testing.assert_allclose(g["loss"], m["loss"], rtol=1e-4)
