"""The port's metadata files without pandas (``data/io.py``'s ``Table``) and
its file stages without pandas or PIL.

* ``metadata.csv`` bytes equal pandas' ``to_csv(index=False)`` (what the JAX
  package writes) for the synthetic metadata, for the adversarial metadata
  and for cells that need quoting or are missing; a JAX-written file reads
  back with the cells ``str`` gives of pandas' values (``"nan"`` for a
  missing one) and is written back byte for byte.
* ``create_adv_metadata``, ``filter_metadata``, the vocabulary and the
  metadata index agree with the JAX package's (duplicate basenames, missing
  images, a missing class cell).
* In a fresh interpreter with ``pandas`` and ``PIL`` blocked by a meta-path
  finder (the card's situation), every module of the port's ``cli``,
  ``data``, ``attacks`` and ``eval`` packages imports and ``synth-data`` plus
  a 32-px ``attack`` stage run with ``--device cpu``; a file the native
  decoder refuses then raises, naming it.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.cli.main import main as tmain
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data import io as tio
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data import loader as tloader
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data import transforms as ttransforms
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils.vocab import LabelVocabulary as TVocab
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.cli.main import main as jmain
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.data import io as jio
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.data import loader as jloader
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.data import transforms as jtransforms
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils.vocab import LabelVocabulary as JVocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cells(df: pd.DataFrame) -> list[tuple]:
    """pandas' rows as the JAX package's ``str(...)`` sees them."""
    return [tuple(str(v) for v in row) for row in df.itertuples(index=False)]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("io")
    port, jax = str(root / "port"), str(root / "jax")
    for main, dev, out in ((tmain, ["--device", "cpu"], port), (jmain, ["--platform", "cpu"], jax)):
        assert main([*dev, "synth-data", "--output_dir", out, "--n_per_class", "2",
                     "--image_size", "24", "--style", "hard"]) == 0
    return {"port": port, "jax": jax}


@pytest.mark.parametrize("split", ("train", "val", "test"))
def test_synthetic_metadata_bytes_and_pixels_equal_jax(synth, split):
    got = open(os.path.join(synth["port"], split, "metadata.csv"), "rb").read()
    assert got == open(os.path.join(synth["jax"], split, "metadata.csv"), "rb").read()
    assert got.endswith(b"\n") and b"\r" not in got
    table = tio.read_metadata(os.path.join(synth["port"], split, "metadata.csv"))
    assert len(table) == 24 and table.columns == tio.METADATA_COLUMNS
    for p in table["image_path"]:
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(synth["port"], split, p))),
            np.asarray(Image.open(os.path.join(synth["jax"], split, p))))


TRICKY = {"image_path": ["a,b.png", 'q"uote.png', "line\nbreak.png", " lead.png", "plain.png"],
          "source": ["s1", "s2", "", "NA", "s1"],
          "original_class": ["007", "x", "y", "z", "None"],
          "unified_class": ["p", "q", "nan", "r", "p"]}


def test_tricky_cells_round_trip_as_pandas(tmp_path):
    """Quoting, missing cells (pandas' NA spellings) and their ``str``."""
    path = str(tmp_path / "j.csv")
    jio.save_metadata(pd.DataFrame(TRICKY), path)
    got = tio.read_metadata(path)
    want = jio.read_metadata(path)
    assert got.columns == tuple(want.columns)
    assert got.rows == _cells(want)
    assert got["source"][2] == got["source"][3] == "nan" and got["unified_class"][2] == "nan"
    # read and written again: pandas writes its missing cells empty
    out, out_j = str(tmp_path / "t.csv"), str(tmp_path / "j2.csv")
    tio.save_metadata(got, out)
    jio.save_metadata(want, out_j)
    assert open(out, "rb").read() == open(out_j, "rb").read()
    # a table built from the same strings writes what pandas writes for them
    tio.save_metadata(tio.Table(list(TRICKY), zip(*TRICKY.values())), out)
    want_bytes = pd.DataFrame(TRICKY).to_csv(index=False).encode()
    assert open(out, "rb").read() == want_bytes


@pytest.mark.parametrize("with_originals", (True, False))
def test_adversarial_metadata_equals_jax_byte_for_byte(tmp_path, with_originals):
    """Duplicate basenames disambiguated by the writer, rows consumed once."""
    cols = {"image_path": ["a/x.png", "b/x.png", "a/y.png", "c/z.png", "d/x.png"],
            "source": ["s1", "s2", "s1", "s2", "s1"], "original_class": ["0", "1", "0", "2", "1"],
            "unified_class": ["p", "q", "p", "r", "q"]}
    written = ["x.png", "x__1.png", "z.png"]
    origs = ["x.png", "x.png", "z.png"] if with_originals else None
    got = tio.create_adv_metadata(tio.Table(list(cols), zip(*cols.values())), written, "/adv",
                                  originals=origs)
    want = jio.create_adv_metadata(pd.DataFrame(cols), written, "/adv", originals=origs)
    assert got.rows == _cells(want)
    tio.save_metadata(got, str(tmp_path / "t.csv"))
    jio.save_metadata(want, str(tmp_path / "j.csv"))
    assert open(tmp_path / "t.csv", "rb").read() == open(tmp_path / "j.csv", "rb").read()


def test_attack_stage_metadata_equals_jax_byte_for_byte(synth, tmp_path):
    """Both CLIs' FGSM stage on one checkpoint: the adversarial metadata.csv
    files are the same bytes but for the output directory in image_path."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import checkpoint

    vocab = TVocab.from_metadata_frames(
        [tio.read_metadata(os.path.join(synth["port"], s, "metadata.csv"))
         for s in ("train", "val", "test")])
    entry, cfg, model = registry.create_model("vit_test", len(vocab),
                                              torch.Generator().manual_seed(0))
    ck_dir = tmp_path / "ck"
    ck_dir.mkdir()
    ck = str(ck_dir / "vit_test_best_model_finetuned.safetensors")
    checkpoint.save_pytree(entry.to_tree(model), ck)
    vocab.save(str(ck_dir / "class_mappings.txt"))
    common = ["attack", "--data_root", synth["port"], "--model", "vit_test", "--model_path", ck,
              "--splits", "test", "--attacks", "fgsm", "--batch_size", "16"]
    assert tmain(["--device", "cpu", *common, "--output_dir", str(tmp_path / "t")]) == 0
    assert jmain(["--platform", "cpu", *common, "--output_dir", str(tmp_path / "j")]) == 0
    meta = lambda side: open(os.path.join(tmp_path, side, "vit_test", "all", "test", "fgsm",  # noqa: E731
                                          "metadata.csv")).read()
    assert meta("t").replace(str(tmp_path / "t"), "") == meta("j").replace(str(tmp_path / "j"), "")


def test_filter_and_vocabulary_match_jax(tmp_path):
    path = str(tmp_path / "m.csv")
    jio.save_metadata(pd.DataFrame(TRICKY), path)
    for sources in (None, ["s1"], ["s1", "s2"], ["nope"]):
        assert tio.filter_metadata(path, sources).rows == _cells(
            jio.filter_metadata(path, sources))
    tables = [tio.read_metadata(path)]
    assert TVocab.from_metadata_frames(tables).classes == \
        JVocab.from_metadata_frames([jio.read_metadata(path)]).classes == ("nan", "p", "q", "r")


def test_metadata_index_matches_jax(synth, tmp_path):
    """Paths, labels, file names and the retained rows, with a row whose
    image is missing and a relative path resolved against the root."""
    split = os.path.join(synth["port"], "test")
    table = tio.read_metadata(os.path.join(split, "metadata.csv"))
    table = tio.Table(table.columns, [*table.rows, ("images/gone.png", "synthetic", "x",
                                                    table.rows[0][3])])
    path = str(tmp_path / "metadata.csv")
    tio.save_metadata(table, path)
    classes = sorted(set(table["unified_class"]))
    got = tloader.MetadataIndex(path, TVocab.from_classes(classes), root_dir=split)
    want = jloader.MetadataIndex(path, JVocab.from_classes(classes), root_dir=split)
    assert got.paths == want.paths and got.filenames == want.filenames and len(got) == 24
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.frame.rows == _cells(want.frame)


def test_loader_decodes_a_png_the_native_decoder_refuses_as_jax(tmp_path):
    """A 16-bit PNG: PIL decodes (it is installed here), the native code resizes."""
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 65535, (40, 36), dtype=np.uint16)).save(tmp_path / "d.png")
    (tmp_path / "metadata.csv").write_text(
        "image_path,source,original_class,unified_class\nd.png,s,c,c\n")
    meta = str(tmp_path / "metadata.csv")
    got = next(iter(tloader.Loader(tloader.MetadataIndex(meta, TVocab.from_classes(["c"])),
                                   batch_size=1, image_size=24, resize=28))).images
    want = next(iter(jloader.Loader(jloader.MetadataIndex(meta, JVocab.from_classes(["c"])),
                                    batch_size=1, image_size=24, resize=28))).images
    np.testing.assert_array_equal(got, want)


def test_eval_transform_pil_equals_jax():
    img = Image.fromarray(np.random.default_rng(1).integers(0, 256, (101, 100, 3), np.uint8))
    np.testing.assert_array_equal(ttransforms.eval_transform_pil(img, resize=64, crop=56),
                                  jtransforms.eval_transform_pil(img, resize=64, crop=56))


_BLOCKED = r'''
import importlib, importlib.abc, os, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("pandas", "PIL"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
PKG = "%(pkg)s"
names = []
for sub in ("cli", "data", "attacks", "eval"):
    mod = importlib.import_module(f"{PKG}.{sub}")
    names.append(mod.__name__)
    for m in pkgutil.walk_packages(mod.__path__, mod.__name__ + "."):
        if not m.name.endswith("__main__"):
            importlib.import_module(m.name)
            names.append(m.name)
from %(pkg)s.cli.main import main
from %(pkg)s.models import registry
from %(pkg)s.utils import checkpoint
from %(pkg)s.utils.vocab import LabelVocabulary
d = sys.argv[1]
assert main(["--device", "cpu", "synth-data", "--output_dir", d + "/data", "--n_per_class", "2",
             "--image_size", "32"]) == 0
vocab = LabelVocabulary.from_classes(
    ["no_entry", "speed_limit", "stop", "warning", "yield"])
entry, cfg, model = registry.create_model("vit_test", len(vocab), torch.Generator().manual_seed(0))
os.makedirs(d + "/ck")
checkpoint.save_pytree(entry.to_tree(model), d + "/ck/m.safetensors")
vocab.save(d + "/ck/class_mappings.txt")
assert main(["--device", "cpu", "attack", "--data_root", d + "/data", "--model", "vit_test",
             "--model_path", d + "/ck/m.safetensors", "--output_dir", d + "/adv",
             "--splits", "test", "--steps", "2", "--batch_size", "8"]) == 0
# a file the native decoder refuses, without PIL: an error that names it
from %(pkg)s.data.io import Table, save_metadata
from %(pkg)s.data.loader import Loader, MetadataIndex
open(d + "/x.jpg", "wb").write(b"not an image")
save_metadata(Table(["image_path", "source", "original_class", "unified_class"],
                    [["x.jpg", "s", "stop", "stop"]]), d + "/bad/metadata.csv")
try:
    next(iter(Loader(MetadataIndex(d + "/bad/metadata.csv", vocab, root_dir=d), batch_size=1,
                     image_size=32, resize=36)))
    raise SystemExit("no error for a file without a decoder")
except RuntimeError as e:
    assert "x.jpg" in str(e) and "PIL" in str(e), e
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("pandas", "PIL"))
assert not bad, bad
print(len(names), "modules")
'''


def test_cli_data_attacks_eval_run_with_pandas_and_pil_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _BLOCKED % {"pkg": PKG}, str(tmp_path)],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert int(out.stdout.split()[-2]) >= 20
    for attack in ("fgsm", "pgd"):
        d = tmp_path / "adv" / "vit_test" / "all" / "test" / attack
        assert len(tio.read_metadata(str(d / "metadata.csv"))) == 10
        assert len(os.listdir(d / "images")) == 10
