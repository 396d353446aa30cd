"""The port's FashionMNIST loader (``data/fashion.py``) against the JAX
package's: IDX bytes, both directory layouts, the missing-file error and the
PIL resize bit for bit; then the JAX package's ``tests/test_fashion.py``
workflow (a LoRA fine-tune of ``vit_test`` and an FGSM sweep) in the port.
"""

import gzip
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import common as tcommon
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import whitebox as twb
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data import fashion as tf
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry as treg
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora as tlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.data import fashion as jf

IDENT = tcommon.Normalizer((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (pytest-xdist workers share
    the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _make(raw, n, name_img, name_lbl, rng):
    """The class-coded fixture of the JAX package's tests (written by the port)."""
    labels = (np.arange(n) % 10).astype(np.uint8)
    images = rng.integers(0, 40, (n, 28, 28), dtype=np.uint8)
    for i, c in enumerate(labels):
        images[i, 4 + c * 2: 10 + c * 2, 6:22] = 220
    tf.write_idx(os.path.join(raw, name_img), images)
    tf.write_idx(os.path.join(raw, name_lbl), labels)
    return images, labels


@pytest.fixture(scope="module")
def fashion_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fashion_data"))
    raw = os.path.join(root, "FashionMNIST", "raw")
    rng = np.random.default_rng(0)
    _make(raw, 60, "train-images-idx3-ubyte", "train-labels-idx1-ubyte", rng)
    _make(raw, 20, "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte", rng)
    return root


def test_classes_equal_jax():
    assert tf.CLASSES == jf.CLASSES


@pytest.mark.parametrize("shape", [(7, 28, 28), (9,), (2, 3, 4, 5)])
def test_write_idx_bytes_equal_jax(tmp_path, shape):
    a = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    tf.write_idx(str(tmp_path / "port" / "x"), a)
    jf.write_idx(str(tmp_path / "jax" / "x"), a)
    port, jax_ = (open(tmp_path / d / "x", "rb").read() for d in ("port", "jax"))
    assert port == jax_
    np.testing.assert_array_equal(tf.read_idx(str(tmp_path / "jax" / "x")), a)


def test_read_idx_reads_gzip_and_refuses_other_dtypes(tmp_path):
    a = np.random.default_rng(2).integers(0, 256, (4, 28, 28), dtype=np.uint8)
    tf.write_idx(str(tmp_path / "plain"), a)
    with open(tmp_path / "plain", "rb") as src, gzip.open(tmp_path / "gz.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    np.testing.assert_array_equal(tf.read_idx(str(tmp_path / "gz")), a)
    np.testing.assert_array_equal(jf.read_idx(str(tmp_path / "gz")), a)
    (tmp_path / "f32").write_bytes(b"\x00\x00\x0d\x01\x00\x00\x00\x01" + b"\x00" * 4)
    with pytest.raises(ValueError, match="unsupported IDX dtype 0x0d"):
        tf.read_idx(str(tmp_path / "f32"))


def test_load_split_both_layouts_and_limit(fashion_root, tmp_path):
    images, labels = tf.load_split(fashion_root, "train")
    j_images, j_labels = jf.load_split(fashion_root, "train")
    assert images.shape == (60, 28, 28) and images.dtype == np.uint8
    assert labels.shape == (60,) and labels.dtype == np.int32
    np.testing.assert_array_equal(images, j_images)
    np.testing.assert_array_equal(labels, j_labels)
    # a flat directory, gzipped
    for name in os.listdir(os.path.join(fashion_root, "FashionMNIST", "raw")):
        with open(os.path.join(fashion_root, "FashionMNIST", "raw", name), "rb") as src, \
                gzip.open(tmp_path / f"{name}.gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
    flat_images, flat_labels = tf.load_split(str(tmp_path), "test", limit=5)
    np.testing.assert_array_equal(flat_images, tf.load_split(fashion_root, "test")[0][:5])
    assert flat_labels.tolist() == [0, 1, 2, 3, 4]


def test_missing_files_raise_as_jax(tmp_path):
    msgs = []
    for mod in (tf, jf):
        with pytest.raises(FileNotFoundError) as e:
            mod.load_split(str(tmp_path), "train")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("size", [32, 20, 64])
def test_to_rgb_float_equals_jax(fashion_root, size):
    images, _ = tf.load_split(fashion_root, "train", limit=6)
    got = tf.to_rgb_float(images, image_size=size)
    assert got.shape == (6, size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jf.to_rgb_float(images, image_size=size))
    np.testing.assert_array_equal(got[..., 0], got[..., 2])


def test_to_rgb_float_without_pil_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="PIL"):
        tf.to_rgb_float(np.zeros((1, 28, 28), np.uint8))


def test_fashion_vit_lora_fgsm_sweep(fashion_root):
    """The JAX test's slice in the port: a LoRA fine-tune of ``vit_test`` on
    the fixture (30 Adam steps, rank 4, head trained), then FGSM at three
    eps: clean accuracy above 0.5, robust accuracy at most clean and not
    better at the largest eps than at the smallest (+0.1)."""
    entry = treg.get_model("vit_test")
    cfg = entry.config(10)
    base = entry.init(cfg, torch.Generator().manual_seed(0))

    def split(name):
        images, labels = tf.load_split(fashion_root, name)
        return (torch.from_numpy(tf.to_rgb_float(images, image_size=32)),
                torch.from_numpy(labels).long())

    (xtr, ytr), (xte, yte) = split("train"), split("test")

    lcfg = tlora.LoRAConfig(rank=4, alpha=16.0, targets=entry.lora_targets(cfg), dropout=0.0)
    adapter = tlora.init(torch.Generator().manual_seed(1), base, lcfg)
    model = entry.from_tree(tlora.attach(base, adapter, lcfg), cfg)
    for n, p in model.named_parameters():
        p.requires_grad_(n.startswith("head.") or n.endswith((".lora_a", ".lora_b")))
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=5e-3)
    for _ in range(30):
        opt.zero_grad()
        F.cross_entropy(entry.apply(cfg, model, xtr), ytr).backward()
        opt.step()
    model.requires_grad_(False)

    def acc(x):
        with torch.no_grad():
            return float((entry.apply(cfg, model, x).argmax(-1) == yte).float().mean())

    clean = acc(xte)
    assert clean > 0.5, f"LoRA fine-tune failed to learn: {clean}"
    robust = []
    for eps in (4 / 255, 16 / 255, 64 / 255):
        adv = twb.fgsm(lambda m, x: entry.apply(cfg, m, x), model, xte, yte, eps=eps,
                       normalize=IDENT)
        assert float((adv - xte).abs().max()) <= eps + 1e-6
        robust.append(acc(adv))
    assert robust[0] <= clean + 1e-6
    assert robust[2] <= robust[0] + 0.1
