"""The port's CLI (``synth-data``, ``attack``) against the JAX CLI.

Both CLIs attack the same checkpoint, written by the JAX package, on the
CPU. The JAX loader is pinned to its PIL decode backend (``APVT_NATIVE=0``)
so both sides see the same pixels; FGSM PNGs must then agree on >= 99% of
pixels within 1 LSB (a near-zero gradient may take the other sign).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pandas as pd
import pytest
from PIL import Image

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.cli import main as tmain
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.cli import main as jmain
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import vit as jvit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import checkpoint as jck
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
    saved = os.environ.get("APVT_NATIVE")
    os.environ["APVT_NATIVE"] = "0"
    try:
        assert jmain(["--platform", "cpu", *common, "--output_dir", jax_out,
                      "--attacks", "fgsm"]) == 0
    finally:
        if saved is None:
            del os.environ["APVT_NATIVE"]
        else:
            os.environ["APVT_NATIVE"] = saved
    return {"data": data, "port": port_out, "jax": jax_out}


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


def test_attack_refuses_non_safetensors(tmp_path):
    with pytest.raises(SystemExit, match="safetensors"):
        tmain(["--device", "cpu", "attack", "--data_root", str(tmp_path), "--model",
               "vit_test", "--model_path", str(tmp_path / "m.pth")])
