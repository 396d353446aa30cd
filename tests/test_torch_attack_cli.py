"""The port's ``patch-attack``, ``rp2-attack`` and ``autoattack`` stages
against the JAX CLI, and their outputs through ``train-lora`` and
``eval-compose``.

Both CLIs run the three stages on the same ``synth-data`` set and the same
JAX-written ``vit_test`` checkpoint on the CPU, with tiny budgets. Their
flags and defaults, output directories, file names, ``metadata.csv`` rows,
RP2 patch files and ``--stats_json`` keys must be the same; the random
draws differ between the packages, so pixels are compared only where no
attack touches them (outside RP2's sign mask). The port's AutoAttack stats
are keyed by exact survivor counts, JAX's by power-of-two buckets.
"""

import argparse
import importlib
import json
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import rp2 as trp2
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import vit as jvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import checkpoint as jck
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils.vocab import LabelVocabulary

# the CLI modules (each package's ``cli`` exports the function ``main`` under the same name)
tcli = importlib.import_module(
    "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.cli.main")
jcli = importlib.import_module(
    "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.cli.main")
STAGES = ("patch-attack", "rp2-attack", "autoattack")
# the JAX flags the port leaves out by design (its --device replaces --platform)
JAX_ONLY = {"fused_attention", "unroll_layers"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: under pytest-xdist the
    workers share the cores, and a pool of one thread per core makes each
    small eager op wait on the other workers (10x slower in a full run)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("attack_cli")
    data = str(root / "data")
    assert tcli.main(["--device", "cpu", "synth-data", "--output_dir", data,
                      "--n_per_class", "2", "--image_size", "40"]) == 0
    vocab = LabelVocabulary.from_metadata_frames(
        [pd.read_csv(os.path.join(data, s, "metadata.csv")) for s in ("train", "val", "test")])
    ck_dir = root / "ck" / "vit_test" / "all"
    ck = str(ck_dir / "vit_test_best_model_finetuned.safetensors")
    jck.save_pytree(jvit.init(jax.random.key(3), jvit.VIT_TEST.with_classes(len(vocab))), ck,
                    meta={"epoch": 1})
    vocab.save(str(ck_dir / "class_mappings.txt"))
    common = ["--data_root", data, "--model", "vit_test", "--model_path", ck, "--batch_size", "8"]
    stages = {
        "patch-attack": ["--max_iter", "2", "--patch_sample_size", "8", "--patch_size", "8"],
        "rp2-attack": ["--max_iter", "2", "--patch_size", "8", "--splits", "train", "test",
                       "--patch_train_split", "train"],
        "autoattack": ["--n_iter", "2", "--square_queries", "4", "--splits", "train", "test"],
    }
    out = {"data": data, "ck": ck, "common": common, "root": root}
    for side, main, dev in (("port", tcli.main, ["--device", "cpu"]),
                            ("jax", jcli.main, ["--platform", "cpu"])):
        adv = str(root / f"adv_{side}")
        for stage, extra in stages.items():
            stats = ["--stats_json", str(root / f"{side}_stats.json")] if stage == "autoattack" else []
            assert main([*dev, stage, *common, "--output_dir", adv, *extra, *stats]) == 0
        # rp2 retrained per split, without --patch_train_split
        assert main([*dev, "rp2-attack", *common, "--output_dir", str(root / f"rp2_{side}"),
                     "--max_iter", "2", "--patch_size", "8", "--splits", "val", "test"]) == 0
        out[side] = adv
    return out


def _subparser(parser, name):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices[name]


@pytest.mark.parametrize("stage", STAGES)
def test_flags_and_defaults_match_jax(stage):
    def flags(parser):
        return {a.dest: (a.default, a.nargs, tuple(a.choices or ()), a.required)
                for a in _subparser(parser, stage)._actions if a.dest != "help"}

    got, want = flags(tcli.build_parser()), flags(jcli.build_parser())
    assert set(want) - set(got) == JAX_ONLY and set(got) <= set(want)
    assert {k: v for k, v in got.items() if k != "param_dtype"} == {
        k: v for k, v in want.items() if k not in JAX_ONLY | {"param_dtype"}}
    assert got["param_dtype"][0] == want["param_dtype"][0] == "auto"


def _tree(root):
    """Relative directory paths and file names under ``root``."""
    out = set()
    for d, _, files in os.walk(root):
        rel = os.path.relpath(d, root)
        out.add(rel + "/")
        out.update(os.path.join(rel, f) for f in files)
    return out


@pytest.mark.parametrize("which", ["adv", "rp2"])
def test_output_layout_matches_jax(runs, which):
    root = runs["root"]
    got, want = _tree(root / f"{which}_port"), _tree(root / f"{which}_jax")
    assert got == want
    if which == "adv":
        attacks = {"autoattack", "patch_circle", "patch_square", "rp2"}
        assert {p.split("/")[3] for p in got if p.count("/") >= 4} == attacks
        for split in ("train", "val", "test"):
            assert f"vit_test/all/{split}/patch_circle/metadata.csv" in got
        # --patch_train_split train: the patches of the train split only
        assert any(p.startswith("vit_test/all/train/rp2/patches/rp2_patch_") for p in got)
        assert not any(p.startswith("vit_test/all/test/rp2/patches") for p in got)
    else:  # retrained per split
        for split in ("val", "test"):
            assert any(p.startswith(f"vit_test/all/{split}/rp2/patches/rp2_patch_") for p in got)


def test_metadata_rows_match_jax(runs):
    metas = sorted(p for p in _tree(runs["port"]) if p.endswith("metadata.csv"))
    assert len(metas) == 3 * 2 + 2 + 2  # patch x 3 splits x 2 types, rp2 x 2, autoattack x 2
    for rel in metas:
        got = pd.read_csv(os.path.join(runs["port"], rel))
        want = pd.read_csv(os.path.join(runs["jax"], rel))
        assert [os.path.basename(p) for p in got["image_path"]] == \
            [os.path.basename(p) for p in want["image_path"]]
        assert all(os.path.exists(p) for p in got["image_path"])
        pd.testing.assert_frame_equal(got.drop(columns="image_path"),
                                      want.drop(columns="image_path"))


def test_stats_json_keys_match_jax(runs):
    got = json.load(open(runs["root"] / "port_stats.json"))
    want = json.load(open(runs["root"] / "jax_stats.json"))
    assert list(got) == list(want)
    for k in ("model", "n_iter", "square_queries", "suite"):
        assert got[k] == want[k]
    assert got["stages"] and all(list(r) == list(want["stages"][0]) for r in got["stages"])
    n_images = sum(len(pd.read_csv(os.path.join(runs["data"], s, "metadata.csv")))
                   for s in ("train", "test"))
    for r in got["stages"]:
        assert r["stage"] in got["suite"] and 0 < r["bucket"] <= 8 and r["calls"] >= 1
    first = [r for r in got["stages"] if r["stage"] == "apgd-ce"]
    # the first stage sees every batch's clean survivors: at most every image
    assert sum(r["bucket"] * r["calls"] for r in first) <= n_images


def test_rp2_pixels_outside_the_sign_match_jax(runs):
    """Outside the sign mask both CLIs write the clean pixels (through the
    same uint8 truncation); their patch files have the same names and the
    circle's outside black."""
    outside = trp2.sign_mask(32)[..., 0].numpy() == 0
    for split in ("train", "test"):
        d_t = os.path.join(runs["port"], "vit_test", "all", split, "rp2", "images")
        d_j = os.path.join(runs["jax"], "vit_test", "all", split, "rp2", "images")
        for name in sorted(os.listdir(d_j)):
            got = np.asarray(Image.open(os.path.join(d_t, name)))
            want = np.asarray(Image.open(os.path.join(d_j, name)))
            assert got.shape == want.shape == (32, 32, 3)
            np.testing.assert_array_equal(got[outside], want[outside])
    pdir = os.path.join(runs["port"], "vit_test", "all", "train", "rp2", "patches")
    for name in os.listdir(pdir):
        patch = np.asarray(Image.open(os.path.join(pdir, name)))
        assert patch.shape == (8, 8, 3) and (patch[0, 0] == 0).all()


def test_outputs_feed_train_lora_and_eval_compose(runs):
    """The reference's study: adapters trained on the new attacks' train
    splits, then the composability matrix over their test splits."""
    root, attacks = runs["root"], ["patch_circle", "rp2", "autoattack"]
    dev = ["--device", "cpu"]
    assert tcli.main([*dev, "train-lora", *runs["common"], "--adv_root", runs["port"],
                      "--output_dir", str(root / "loras"), "--attacks", *attacks,
                      "--ranks", "4", "--epochs", "1"]) == 0
    for a in attacks:
        assert os.path.isdir(root / "loras" / "vit_test" / "all" / a / "rank4_best_adapter")
    assert tcli.main([*dev, "eval-compose", *runs["common"], "--adv_root", runs["port"],
                      "--lora_root", str(root / "loras"), "--output_dir", str(root / "eval"),
                      "--attacks", *attacks, "--rank", "4"]) == 0
    results = json.load(open(root / "eval" / "test_results.json"))
    assert set(results) == {"base", "lora_patch_circle", "lora_rp2", "lora_autoattack",
                            "patch_circle+rp2", "patch_circle+autoattack", "rp2+autoattack",
                            "patch_circle+rp2+autoattack"}
    for row in results.values():
        assert set(row) == {"clean", "autoattack", "patch_circle", "patch_square", "rp2"}
        assert all(0.0 <= cell["accuracy"] <= 1.0 for cell in row.values())


@pytest.mark.parametrize("stage", STAGES)
def test_stages_refuse_to_run_without_a_card(runs, stage):
    """The CLI's default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main([stage, *runs["common"], "--output_dir", str(runs["root"] / "never")])
