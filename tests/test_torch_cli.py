"""The port's CLI (``synth-data``, ``train``, ``attack``, ``train-lora``,
``eval-compose``) against the JAX CLI.

Both CLIs attack the same checkpoint, written by the JAX package, on the
CPU (``vit_test``, ``swin_test`` and ``convnext_test``). The JAX loader is pinned to its PIL
decode backend (``APVT_NATIVE=0``) so both sides see the same pixels; FGSM
PNGs must then agree on >= 99% of pixels within 1 LSB (a near-zero gradient
may take the other sign). ``eval-compose`` runs in both CLIs over the same
checkpoint, adversarial PNGs and JAX-written adapters: accuracies equal,
F1 and loss within rtol 1e-4.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
from PIL import Image

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.cli import main as tmain
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.cli import main as jmain
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import convnext as jcnx
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import swin as jswin
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import vit as jvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import lora as jlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import peft_io as jpeft
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import checkpoint as jck
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import native as jnative
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils.vocab import LabelVocabulary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Port synth-data, a JAX checkpoint, then both CLIs' attack stage."""
    root = tmp_path_factory.mktemp("cli")
    data = str(root / "data")
    assert tmain(["--device", "cpu", "synth-data", "--output_dir", data,
                  "--n_per_class", "3", "--image_size", "40"]) == 0
    vocab = LabelVocabulary.from_metadata_frames(
        [pd.read_csv(os.path.join(data, s, "metadata.csv")) for s in ("train", "val", "test")])
    ck_dir = root / "ck" / "vit_test" / "all"
    ck = str(ck_dir / "vit_test_best_model_finetuned.safetensors")
    params = jvit.init(jax.random.key(3), jvit.VIT_TEST.with_classes(len(vocab)))
    jck.save_pytree(params, ck, meta={"epoch": 1})
    vocab.save(str(ck_dir / "class_mappings.txt"))

    common = ["attack", "--data_root", data, "--model", "vit_test", "--model_path", ck,
              "--splits", "test", "--batch_size", "8"]
    port_out, jax_out = str(root / "adv_port"), str(root / "adv_jax")
    assert tmain(["--device", "cpu", *common, "--output_dir", port_out,
                  "--attacks", "fgsm", "pgd", "--steps", "2"]) == 0
    with _jax_pil_decode():
        assert jmain(["--platform", "cpu", *common, "--output_dir", jax_out,
                      "--attacks", "fgsm"]) == 0
    return {"data": data, "port": port_out, "jax": jax_out, "ck": ck, "params": params}


def _split_dir(out, attack):
    return os.path.join(out, "vit_test", "all", "test", attack)


def test_attack_directory_contract_and_metadata(runs):
    for attack in ("fgsm", "pgd"):
        d = _split_dir(runs["port"], attack)
        assert os.path.isdir(os.path.join(d, "images"))
        meta = pd.read_csv(os.path.join(d, "metadata.csv"))
        assert list(meta.columns) == ["image_path", "source", "original_class", "unified_class"]
        assert len(meta) == 15
        assert all(os.path.exists(p) for p in meta["image_path"])
    got = pd.read_csv(os.path.join(_split_dir(runs["port"], "fgsm"), "metadata.csv"))
    want = pd.read_csv(os.path.join(_split_dir(runs["jax"], "fgsm"), "metadata.csv"))
    assert [os.path.basename(p) for p in got["image_path"]] == \
        [os.path.basename(p) for p in want["image_path"]]
    pd.testing.assert_frame_equal(got.drop(columns="image_path"), want.drop(columns="image_path"))


def test_fgsm_pngs_match_jax_cli(runs):
    got_dir = os.path.join(_split_dir(runs["port"], "fgsm"), "images")
    want_dir = os.path.join(_split_dir(runs["jax"], "fgsm"), "images")
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    got = np.stack([np.asarray(Image.open(os.path.join(got_dir, n))) for n in names]).astype(int)
    want = np.stack([np.asarray(Image.open(os.path.join(want_dir, n))) for n in names]).astype(int)
    assert got.shape == want.shape == (15, 32, 32, 3)
    assert (np.abs(got - want) <= 1).mean() >= 0.99


def test_pgd_pngs_stay_in_the_eps_ball(runs):
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data.loader import Loader, MetadataIndex
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils.vocab import LabelVocabulary as TVocab

    vocab = TVocab.from_classes(pd.read_csv(
        os.path.join(runs["data"], "test", "metadata.csv"))["unified_class"])
    idx = MetadataIndex(os.path.join(runs["data"], "test", "metadata.csv"), vocab,
                        root_dir=runs["data"])
    clean = {n: im for b in Loader(idx, batch_size=15, image_size=32, resize=37)
             for n, im in zip(b.filenames, b.images)}
    d = os.path.join(_split_dir(runs["port"], "pgd"), "images")
    for n in sorted(os.listdir(d)):
        adv = np.asarray(Image.open(os.path.join(d, n))).astype(int)
        # truncation to uint8 can move a pixel one step further than eps
        assert np.abs(adv - clean[n].astype(int)).max() <= 8 + 1, n


def test_synth_data_matches_jax(runs, tmp_path):
    jax_data = str(tmp_path / "jdata")
    assert jmain(["--platform", "cpu", "synth-data", "--output_dir", jax_data,
                  "--n_per_class", "3", "--image_size", "40"]) == 0
    for split in ("train", "val", "test"):
        got = pd.read_csv(os.path.join(runs["data"], split, "metadata.csv"))
        want = pd.read_csv(os.path.join(jax_data, split, "metadata.csv"))
        pd.testing.assert_frame_equal(got, want)
        for p in got["image_path"][:4]:
            np.testing.assert_array_equal(
                np.asarray(Image.open(os.path.join(runs["data"], split, p))),
                np.asarray(Image.open(os.path.join(jax_data, split, p))))


def test_module_entry_point_help():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "apvt_lora_torch.cli", "attack", "--help"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--model_path" in out.stdout and "--param_dtype" in out.stdout


def test_create_adv_metadata_matches_jax():
    """Basename pairing with duplicate basenames disambiguated by the writer."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data import io as tio
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.data import io as jio

    clean = pd.DataFrame({"image_path": ["a/x.png", "b/x.png", "a/y.png", "c/z.png"],
                          "source": ["s1", "s2", "s1", "s2"],
                          "original_class": ["0", "1", "0", "2"],
                          "unified_class": ["p", "q", "p", "r"]})
    written, origs = ["x.png", "x__1.png", "z.png"], ["x.png", "x.png", "z.png"]
    got = tio.create_adv_metadata(clean, written, "/adv", originals=origs)
    pd.testing.assert_frame_equal(got, jio.create_adv_metadata(clean, written, "/adv",
                                                               originals=origs))
    assert list(got["image_path"]) == ["/adv/x.png", "/adv/x__1.png", "/adv/z.png"]
    with pytest.raises(ValueError, match="parallel"):
        tio.create_adv_metadata(clean, written, "/adv", originals=origs[:2])


def test_attack_refuses_non_safetensors(runs, tmp_path):
    """A checkpoint other than a .safetensors tree goes through the importers
    (an HF directory, .bin, the reference's .pth): a missing one is named."""
    with pytest.raises(FileNotFoundError, match="m.pth"):
        tmain(["--device", "cpu", "attack", "--data_root", runs["data"], "--model",
               "vit_test", "--model_path", str(tmp_path / "m.pth")])


@contextlib.contextmanager
def _jax_pil_decode():
    """Pin the JAX loader to its PIL decode backend, as the port decodes (a
    native library an earlier test of this worker loaded stays cached, so
    the switch alone is not enough)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("APVT_NATIVE", "0")
    mp.setattr(jnative, "_LIB", None)
    try:
        yield
    finally:
        mp.undo()


def _jax_checkpoint(root, data, model, init):
    vocab = LabelVocabulary.from_metadata_frames(
        [pd.read_csv(os.path.join(data, s, "metadata.csv")) for s in ("train", "val", "test")])
    ck_dir = root / "ck" / model / "all"
    ck = str(ck_dir / f"{model}_best_model_finetuned.safetensors")
    params = init(len(vocab))
    jck.save_pytree(params, ck, meta={"epoch": 1})
    vocab.save(str(ck_dir / "class_mappings.txt"))
    return ck, params


@pytest.fixture(scope="module")
def swin_runs(runs, tmp_path_factory):
    """``attack --model swin_test`` through both CLIs on the same data."""
    root = tmp_path_factory.mktemp("cli_swin")
    ck, params = _jax_checkpoint(root, runs["data"], "swin_test", lambda c: jswin.init(
        jax.random.key(4), jswin.SWIN_TEST.with_classes(c)))
    common = ["attack", "--data_root", runs["data"], "--model", "swin_test", "--model_path", ck,
              "--splits", "test", "--batch_size", "8"]
    port_out, jax_out = str(root / "adv_port"), str(root / "adv_jax")
    assert tmain(["--device", "cpu", *common, "--output_dir", port_out,
                  "--attacks", "fgsm", "pgd", "--steps", "2"]) == 0
    with _jax_pil_decode():
        assert jmain(["--platform", "cpu", *common, "--output_dir", jax_out,
                      "--attacks", "fgsm"]) == 0
    return {"root": root, "ck": ck, "params": params, "port": port_out, "jax": jax_out}


def test_swin_attack_fgsm_pngs_match_jax_cli(swin_runs):
    split = lambda out: os.path.join(out, "swin_test", "all", "test", "fgsm")
    names = sorted(os.listdir(os.path.join(split(swin_runs["jax"]), "images")))
    assert len(names) == 15
    load = lambda out: np.stack([np.asarray(Image.open(os.path.join(split(out), "images", n)))
                                 for n in names]).astype(int)
    got, want = load(swin_runs["port"]), load(swin_runs["jax"])
    assert got.shape == want.shape == (15, 32, 32, 3)
    assert (np.abs(got - want) <= 1).mean() >= 0.99
    pd.testing.assert_frame_equal(
        pd.read_csv(os.path.join(split(swin_runs["port"]), "metadata.csv")).drop(columns="image_path"),
        pd.read_csv(os.path.join(split(swin_runs["jax"]), "metadata.csv")).drop(columns="image_path"))
    pgd_meta = pd.read_csv(os.path.join(swin_runs["port"], "swin_test", "all", "test", "pgd",
                                        "metadata.csv"))
    assert len(pgd_meta) == 15 and all(os.path.exists(p) for p in pgd_meta["image_path"])


def _convnext_init(classes):
    """JAX ``convnext.init`` with the layer scale redrawn in 0.1-1 (at the
    1e-6 init the blocks are the identity and the attack sees none of them)."""
    params = jcnx.init(jax.random.key(5), jcnx.CONVNEXT_TEST.with_classes(classes))
    rng = np.random.default_rng(5)
    flat = jtrees.flatten_with_paths(params)
    for p, v in flat.items():
        if p.endswith("gamma"):
            flat[p] = jnp.asarray(rng.uniform(0.1, 1.0, v.shape), jnp.float32)
    return jtrees.unflatten_from_paths(flat)


@pytest.fixture(scope="module")
def convnext_runs(runs, tmp_path_factory):
    """``attack --model convnext_test`` through both CLIs on the same data."""
    root = tmp_path_factory.mktemp("cli_convnext")
    ck, params = _jax_checkpoint(root, runs["data"], "convnext_test", _convnext_init)
    common = ["attack", "--data_root", runs["data"], "--model", "convnext_test",
              "--model_path", ck, "--splits", "test", "--batch_size", "8"]
    port_out, jax_out = str(root / "adv_port"), str(root / "adv_jax")
    assert tmain(["--device", "cpu", *common, "--output_dir", port_out,
                  "--attacks", "fgsm", "pgd", "--steps", "2"]) == 0
    with _jax_pil_decode():
        assert jmain(["--platform", "cpu", *common, "--output_dir", jax_out,
                      "--attacks", "fgsm"]) == 0
    return {"root": root, "ck": ck, "params": params, "port": port_out, "jax": jax_out}


def test_convnext_attack_fgsm_pngs_match_jax_cli(convnext_runs):
    split = lambda out: os.path.join(out, "convnext_test", "all", "test", "fgsm")
    names = sorted(os.listdir(os.path.join(split(convnext_runs["jax"]), "images")))
    assert len(names) == 15
    load = lambda out: np.stack([np.asarray(Image.open(os.path.join(split(out), "images", n)))
                                 for n in names]).astype(int)
    got, want = load(convnext_runs["port"]), load(convnext_runs["jax"])
    assert got.shape == want.shape == (15, 32, 32, 3)
    assert (np.abs(got - want) <= 1).mean() >= 0.99
    pd.testing.assert_frame_equal(
        pd.read_csv(os.path.join(split(convnext_runs["port"]), "metadata.csv")).drop(columns="image_path"),
        pd.read_csv(os.path.join(split(convnext_runs["jax"]), "metadata.csv")).drop(columns="image_path"))
    pgd_meta = pd.read_csv(os.path.join(convnext_runs["port"], "convnext_test", "all", "test",
                                        "pgd", "metadata.csv"))
    assert len(pgd_meta) == 15 and all(os.path.exists(p) for p in pgd_meta["image_path"])


def test_fused_block_flag_sets_fuse_ln_mlp(convnext_runs, swin_runs, runs, tmp_path, monkeypatch):
    """``--fused_block`` is accepted for ConvNeXt and sets ``fuse_ln_mlp`` on
    the config the model is built with (in f32 on the CPU the field changes
    no number, so the PNGs equal the run without the flag); for a backbone
    without a fused-block field (Swin) it is an error, as in the JAX CLI, and
    so is ``--fused_mlp`` for ConvNeXt."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry as tregistry

    seen = []
    entry = tregistry.get_model("convnext_test")
    monkeypatch.setitem(tregistry._REGISTRY, "convnext_test", dataclasses.replace(
        entry, from_tree=lambda flat, cfg: (seen.append(cfg), entry.from_tree(flat, cfg))[1]))
    common = ["--device", "cpu", "attack", "--data_root", runs["data"], "--model", "convnext_test",
              "--model_path", convnext_runs["ck"], "--splits", "test", "--batch_size", "8",
              "--attacks", "fgsm"]
    assert tmain([*common, "--output_dir", str(tmp_path / "fused"), "--fused_block"]) == 0
    assert [c.fuse_ln_mlp for c in seen] == [True] and not seen[0].use_dw_kernel
    assert tmain([*common, "--output_dir", str(tmp_path / "plain")]) == 0
    assert [c.fuse_ln_mlp for c in seen] == [True, False]
    for n in sorted(os.listdir(tmp_path / "plain" / "convnext_test" / "all" / "test" / "fgsm" / "images")):
        a, b = (np.asarray(Image.open(tmp_path / d / "convnext_test" / "all" / "test" / "fgsm" /
                                      "images" / n)) for d in ("fused", "plain"))
        np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit, match="fused_block"):
        tmain(["--device", "cpu", "attack", "--data_root", runs["data"], "--model", "swin_test",
               "--model_path", swin_runs["ck"], "--splits", "test", "--fused_block"])
    with pytest.raises(SystemExit, match="fused_mlp"):
        tmain([*common, "--output_dir", str(tmp_path / "no"), "--fused_mlp"])


def test_vit_kernel_flags_follow_the_jax_order(runs, tmp_path, monkeypatch):
    """For the ViT family ``--fused_block`` sets ``fuse_attn_block`` (the
    first fused-block field the config has, as in the JAX CLI), never
    ``fuse_ln_mlp``; ``--fused_mlp`` sets ``use_fused_mlp``."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry as tregistry

    seen = []
    entry = tregistry.get_model("vit_test")
    monkeypatch.setitem(tregistry._REGISTRY, "vit_test", dataclasses.replace(
        entry, from_tree=lambda flat, cfg: (seen.append(cfg), entry.from_tree(flat, cfg))[1]))
    common = ["--device", "cpu", "attack", "--data_root", runs["data"], "--model", "vit_test",
              "--model_path", runs["ck"], "--splits", "test", "--batch_size", "8",
              "--attacks", "fgsm"]
    for i, flags in enumerate((["--fused_block"], ["--fused_mlp"], [])):
        assert tmain([*common, "--output_dir", str(tmp_path / str(i)), *flags]) == 0
    assert [(c.fuse_attn_block, c.fuse_ln_mlp, c.use_fused_mlp) for c in seen] == [
        (True, False, False), (False, False, True), (False, False, False)]


def test_cli_refuses_to_run_without_a_card(tmp_path):
    """No CUDA device and no ``--device cpu``: every stage stops with an error
    that names ``--device cpu`` (``--device cuda`` is the default)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for argv in (["synth-data", "--output_dir", str(tmp_path / "d")],
                 ["--device", "cuda:0", "train", "--data_root", str(tmp_path)],
                 ["attack", "--data_root", str(tmp_path), "--model_path", "x.safetensors"]):
        with pytest.raises(SystemExit, match="--device cpu"):
            tmain(argv)
    assert not (tmp_path / "d").exists()


@pytest.fixture(scope="module")
def pipeline(runs, tmp_path_factory):
    """The five stages in the port alone on ``vit_test``: ``train`` (from a
    checkpoint the JAX package wrote) -> ``attack`` -> ``train-lora`` ->
    ``eval-compose``, over the module's synthetic dataset."""
    root = tmp_path_factory.mktemp("pipeline")
    C, data = ["--device", "cpu"], runs["data"]
    out = {k: str(root / k) for k in ("t", "adv", "loras", "eval")}
    assert tmain([*C, "train", "--data_root", data, "--model", "vit_test", "--output_dir", out["t"],
                  "--checkpoint", runs["ck"], "--epochs", "2", "--batch_size", "8",
                  "--resize", "32", "--learning_rate", "1e-3"]) == 0
    ck = os.path.join(out["t"], "vit_test", "all", "vit_test_best_model_finetuned.safetensors")
    assert tmain([*C, "attack", "--data_root", data, "--model", "vit_test", "--model_path", ck,
                  "--output_dir", out["adv"], "--steps", "2", "--batch_size", "8"]) == 0
    assert tmain([*C, "train-lora", "--data_root", data, "--model", "vit_test", "--model_path", ck,
                  "--adv_root", out["adv"], "--output_dir", out["loras"], "--attacks", "fgsm", "pgd",
                  "--ranks", "4", "--epochs", "1", "--batch_size", "8"]) == 0
    common = ["eval-compose", "--data_root", data, "--model", "vit_test", "--model_path", ck,
              "--adv_root", out["adv"], "--lora_root", out["loras"], "--rank", "4",
              "--batch_size", "8"]
    assert tmain([*C, *common, "--output_dir", out["eval"]]) == 0
    return {**out, "ck": ck, "compose_args": common, "root": root}


def test_pipeline_runs_in_the_port_alone(pipeline, runs):
    """Every stage's files are where the next stage (of either package) looks."""
    t_dir = os.path.dirname(pipeline["ck"])
    for f in ("class_mappings.txt", "training_results.csv", "metrics.jsonl",
              "vit_test_final_model.safetensors", "resume.state.safetensors"):
        assert os.path.exists(os.path.join(t_dir, f)), f
    for split in ("train", "val", "test"):
        for attack in ("fgsm", "pgd"):
            meta = pd.read_csv(os.path.join(pipeline["adv"], "vit_test", "all", split, attack,
                                            "metadata.csv"))
            assert len(meta) == 15
    for attack in ("fgsm", "pgd"):
        d = os.path.join(pipeline["loras"], "vit_test", "all", attack)
        assert json.load(open(os.path.join(d, "results.json")))["rank4"]["rank"] == 4
        for tag in ("best", "final"):
            assert os.path.exists(os.path.join(d, f"rank4_{tag}_adapter", "adapter_config.json"))
    assert set(json.load(open(os.path.join(pipeline["loras"], "global_results.json")))) == {
        "fgsm", "pgd"}
    got = json.load(open(os.path.join(pipeline["eval"], "test_results.json")))
    assert list(got) == ["base", "lora_fgsm", "lora_pgd", "fgsm+pgd"]
    assert all(m["support"] == 15 for per in got.values() for m in per.values())
    # the trained checkpoint differs from the JAX-written one it started from
    start, _ = jck.load_pytree(runs["ck"])
    trained, _ = jck.load_pytree(pipeline["ck"])
    assert not np.array_equal(np.asarray(start["head"]["w"]), np.asarray(trained["head"]["w"]))
    # any other checkpoint goes through the importers: a missing one is named
    with pytest.raises(FileNotFoundError, match="weights.pth"):
        tmain(["--device", "cpu", "train", "--data_root", runs["data"], "--model", "vit_test",
               "--checkpoint", "weights.pth"])


def test_train_lora_exits_nonzero_when_a_pair_fails(pipeline, runs, tmp_path, monkeypatch):
    """A failing (attack, rank) pair does not end the sweep (the other pair's
    adapter is written and the error recorded), but the stage's exit code is 1."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.train import loop as tloop

    orig = tloop.train_lora_adapter

    def flaky(entry, tree, lcfg, *a, **k):
        if lcfg.rank == 3:
            raise RuntimeError("kernel launch failed")
        return orig(entry, tree, lcfg, *a, **k)

    monkeypatch.setattr(tloop, "train_lora_adapter", flaky)
    out = str(tmp_path / "loras")
    assert tmain(["--device", "cpu", "train-lora", "--data_root", runs["data"], "--model",
                  "vit_test", "--model_path", pipeline["ck"], "--adv_root", pipeline["adv"],
                  "--output_dir", out, "--attacks", "fgsm", "--ranks", "3", "4", "--epochs", "1",
                  "--batch_size", "8"]) == 1
    res = json.load(open(os.path.join(out, "vit_test", "all", "fgsm", "results.json")))
    assert res["rank3"] == {"error": "kernel launch failed"} and res["rank4"]["rank"] == 4
    assert os.path.exists(os.path.join(out, "vit_test", "all", "fgsm", "rank4_best_adapter"))


def test_jax_cli_accepts_the_ports_checkpoint_and_adapters(pipeline, tmp_path):
    """The JAX ``eval-compose`` over the checkpoint the port trained, the
    port's adversarial PNGs and the adapter directories the port's
    ``train-lora`` wrote: the same matrix as the port's own ``eval-compose``
    (accuracy and support equal, F1 and loss within rtol 1e-4)."""
    with _jax_pil_decode():
        assert jmain(["--platform", "cpu", *pipeline["compose_args"],
                      "--output_dir", str(tmp_path / "jax")]) == 0
    got = json.load(open(os.path.join(pipeline["eval"], "test_results.json")))
    want = json.load(open(tmp_path / "jax" / "test_results.json"))
    assert list(got) == list(want)
    for variant, per_ds in want.items():
        for ds, m in per_ds.items():
            g = got[variant][ds]
            assert g["accuracy"] == m["accuracy"] and g["support"] == m["support"]
            np.testing.assert_allclose(g["f1"], m["f1"], rtol=1e-4)
            np.testing.assert_allclose(g["loss"], m["loss"], rtol=1e-4)


def _jax_adapters(lora_root, model, params, targets, head_dim, classes, seed):
    """fgsm/pgd rank-4 adapters with heads, written by the JAX peft_io."""
    rng = np.random.default_rng(seed)
    flat = jtrees.flatten_with_paths(params)
    for attack in ("fgsm", "pgd"):
        ad = {}
        for path in targets:
            *lead, di, do = flat[f"{path}/w"].shape
            ad[path] = {"a": jnp.asarray(rng.standard_normal((*lead, di, 4)), jnp.float32) * 0.3,
                        "b": jnp.asarray(rng.standard_normal((*lead, 4, do)), jnp.float32) * 0.3}
        head = {"w": rng.standard_normal((head_dim, classes)).astype(np.float32),
                "b": rng.standard_normal(classes).astype(np.float32)}
        jpeft.save_peft_adapter(ad, jlora.LoRAConfig(rank=4, alpha=16.0, targets=targets),
                                os.path.join(lora_root, model, "all", attack,
                                             "rank4_best_adapter"), head=head)


@pytest.mark.parametrize("model", ["vit_test", "swin_test", "convnext_test"])
def test_eval_compose_matches_jax_cli(model, runs, swin_runs, convnext_runs, tmp_path):
    """Both CLIs' composability matrices over the same checkpoint, the port's
    adversarial PNGs and adapters written by the JAX package: accuracy and
    support equal, F1 and loss within rtol 1e-4."""
    if model == "swin_test":
        ck, params, adv = swin_runs["ck"], swin_runs["params"], swin_runs["port"]
        targets, head_dim = jswin.lora_target_paths(jswin.SWIN_TEST), 64
    elif model == "convnext_test":
        ck, params, adv = convnext_runs["ck"], convnext_runs["params"], convnext_runs["port"]
        targets, head_dim = jcnx.lora_target_paths(jcnx.CONVNEXT_TEST), 32
    else:
        ck, params, adv = runs["ck"], runs["params"], runs["port"]
        targets, head_dim = jvit.LORA_TARGETS_DEFAULT, 64
    loras = str(tmp_path / "loras")
    classes = np.asarray(jtrees.flatten_with_paths(params)["head/w"]).shape[1]
    _jax_adapters(loras, model, params, targets, head_dim, classes, seed=11)
    common = ["eval-compose", "--data_root", runs["data"], "--model", model, "--model_path", ck,
              "--adv_root", adv, "--lora_root", loras, "--rank", "4", "--batch_size", "8"]
    assert tmain(["--device", "cpu", *common, "--output_dir", str(tmp_path / "port")]) == 0
    with _jax_pil_decode():
        assert jmain(["--platform", "cpu", *common, "--output_dir", str(tmp_path / "jax")]) == 0
    got = json.load(open(tmp_path / "port" / "test_results.json"))
    want = json.load(open(tmp_path / "jax" / "test_results.json"))
    assert list(got) == list(want) == ["base", "lora_fgsm", "lora_pgd", "fgsm+pgd"]
    for variant, per_ds in want.items():
        assert list(got[variant]) == list(per_ds) == ["clean", "fgsm", "pgd"]
        for ds, m in per_ds.items():
            g = got[variant][ds]
            assert g["accuracy"] == m["accuracy"] and g["support"] == m["support"] == 15
            np.testing.assert_allclose(g["f1"], m["f1"], rtol=1e-4)
            np.testing.assert_allclose(g["loss"], m["loss"], rtol=1e-4)
