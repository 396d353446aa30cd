"""The port's binding of the host C++ image library (``utils/native.py``)
against the JAX package's (``utils/native.py`` over the same
``native/src`` sources, built by ``native/Makefile``).

Every function equals the JAX binding bit for bit on the inputs of
``tests/test_native_kernels.py``: resize + center crop (also within 2 LSB of
PIL, mean < 0.5), batched resize, resize with padding, normalization, PNG
decode of every 8-bit colour type (PIL's ``convert("RGB")`` pixels), the
fused decode + resize against the two steps, the guards (``None`` for the
PNGs the decoder refuses), the lossless round trip and the encoder's bytes.
The port's loader and the JAX loader's default path read the same pixels at
224 -> 256 -> 224 (PIL's resize differs from them by one LSB on about a fifth
of the pixels). The build raises with the compiler's output and never uses
``-march=native``.
"""

import io
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data import loader as tloader
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import _build
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import native as tnat
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils.vocab import LabelVocabulary as TVocab
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.data import loader as jloader
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.data.transforms import eval_transform_pil
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import native as jnat
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils.vocab import LabelVocabulary as JVocab


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jax_native():
    assert jnat.available(), "the JAX package's native library did not build"
    return jnat


def _png(im: Image.Image) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG")
    return buf.getvalue()


RESIZE_SHAPES = ((300, 400), (400, 300), (224, 224), (257, 123))


@pytest.mark.parametrize("shape", RESIZE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_center_crop_equals_jax_and_is_within_two_lsb_of_pil(shape, jax_native):
    img = np.random.default_rng(0).integers(0, 255, (*shape, 3), dtype=np.uint8)
    got = tnat.resize_center_crop(img, 256, 224)
    np.testing.assert_array_equal(got, jax_native.resize_center_crop(img, 256, 224))
    diff = np.abs(got.astype(int) - eval_transform_pil(Image.fromarray(img)).astype(int))
    assert diff.max() <= 2 and diff.mean() < 0.5, (diff.max(), diff.mean())


def test_batch_resize_equals_jax(jax_native):
    imgs = np.random.default_rng(1).integers(0, 255, (6, 120, 160, 3), dtype=np.uint8)
    got = tnat.batch_resize_center_crop(imgs, 64, 48)
    assert got.shape == (6, 48, 48, 3)
    np.testing.assert_array_equal(got, jax_native.batch_resize_center_crop(imgs, 64, 48))
    np.testing.assert_array_equal(got[3], tnat.resize_center_crop(imgs[3], 64, 48))


@pytest.mark.parametrize("shape", ((50, 100), (100, 50), (31, 31)), ids=str)
def test_resize_with_padding_equals_jax(shape, jax_native):
    img = np.random.default_rng(2).integers(0, 255, (*shape, 3), dtype=np.uint8)
    got = tnat.resize_with_padding(img, 224)
    np.testing.assert_array_equal(got, jax_native.resize_with_padding(img, 224))
    if shape == (50, 100):  # 2:1 aspect: zero rows top and bottom
        assert got[0].sum() == 0 and got[-1].sum() == 0 and got[112].sum() > 0


def test_batch_normalize_equals_jax(jax_native):
    imgs = np.random.default_rng(3).integers(0, 255, (4, 16, 16, 3), dtype=np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    got = tnat.batch_normalize(imgs, mean, std)
    np.testing.assert_array_equal(got, jax_native.batch_normalize(imgs, mean, std))
    want = (imgs.astype(np.float32) / 255.0 - np.asarray(mean, np.float32)) \
        / np.asarray(std, np.float32)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _colour_cases():
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:256, 0:320]
    return {
        "rgb": Image.fromarray(rng.integers(0, 256, (200, 260, 3), dtype=np.uint8)),
        "rgba": Image.fromarray(rng.integers(0, 256, (64, 80, 4), dtype=np.uint8), "RGBA"),
        "gray": Image.fromarray(rng.integers(0, 256, (90, 70), dtype=np.uint8), "L"),
        "la": Image.fromarray(np.dstack([rng.integers(0, 256, (50, 60), dtype=np.uint8)] * 2),
                              "LA"),
        "palette": Image.fromarray(
            rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).quantize(64).convert("P"),
        # structured: PIL's encoder picks the sub/up/average/paeth filters
        "photo": Image.fromarray(np.stack([yy % 256, (xx * 2) % 256, ((yy + xx) // 2) % 256],
                                          -1).astype(np.uint8)),
    }


@pytest.mark.parametrize("name", sorted(_colour_cases()))
def test_decode_every_colour_type_equals_jax_and_pil(name, jax_native):
    data = _png(_colour_cases()[name])
    got = tnat.decode_png_rgb(data)
    assert got is not None
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    np.testing.assert_array_equal(got, jax_native.decode_png_rgb(data))
    fused = tnat.decode_png_resize_center_crop(data, 48, 40)
    np.testing.assert_array_equal(fused, jax_native.decode_png_resize_center_crop(data, 48, 40))
    np.testing.assert_array_equal(fused, tnat.resize_center_crop(got, 48, 40))


def test_fused_decode_equals_two_step_and_jax(jax_native):
    img = np.random.default_rng(2).integers(0, 256, (256, 320, 3), dtype=np.uint8)
    data = _png(Image.fromarray(img))
    fused = tnat.decode_png_resize_center_crop(data, 256, 224)
    np.testing.assert_array_equal(fused, tnat.resize_center_crop(tnat.decode_png_rgb(data),
                                                                 256, 224))
    np.testing.assert_array_equal(fused, jax_native.decode_png_resize_center_crop(data, 256, 224))


def _refused():
    rng = np.random.default_rng(3)
    data = _png(Image.fromarray(rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)))
    interlaced = bytearray(data)
    interlaced[28] = 1  # IHDR payload byte 12: interlace method
    huge = bytearray(data)
    huge[16:20] = (tnat._MAX_PNG_DIM + 1).to_bytes(4, "big")  # IHDR width
    return {"interlaced": bytes(interlaced), "truncated": data[:40],
            "not a png": b"not a png at all",
            "16-bit": _png(Image.fromarray(rng.integers(0, 65535, (20, 20), dtype=np.uint16))),
            "over _MAX_PNG_DIM": bytes(huge)}


@pytest.mark.parametrize("name", sorted(_refused()))
def test_guards_return_none_as_jax(name, jax_native):
    data = _refused()[name]
    assert tnat.decode_png_rgb(data) is None and jax_native.decode_png_rgb(data) is None
    assert tnat.decode_png_resize_center_crop(data, 32, 24) is None
    assert jax_native.decode_png_resize_center_crop(data, 32, 24) is None


def test_crop_larger_than_resize_raises():
    img = np.zeros((40, 40, 3), np.uint8)
    for call in (lambda: tnat.resize_center_crop(img, 32, 33),
                 lambda: tnat.batch_resize_center_crop(img[None], 32, 33),
                 lambda: tnat.decode_png_resize_center_crop(tnat.encode_png_rgb(img), 32, 33)):
        with pytest.raises(ValueError, match="crop"):
            call()
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        tnat.encode_png_rgb(img[..., :2])


@pytest.mark.parametrize("level", (1, 6))
def test_encode_round_trip_is_lossless_and_equals_jax(level, jax_native):
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:97, 0:113]
    base = np.stack([yy % 256, (xx * 2) % 256, ((yy + xx) // 2) % 256], -1).astype(np.int16)
    img = np.clip(base + rng.integers(-8, 9, base.shape), 0, 255).astype(np.uint8)
    data = tnat.encode_png_rgb(img, level=level)
    assert data == jax_native.encode_png_rgb(img, level=level)  # same library, same deflate
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), img)
    np.testing.assert_array_equal(tnat.decode_png_rgb(data), img)
    np.testing.assert_array_equal(jax_native.decode_png_rgb(data), img)


def test_loader_reads_the_jax_default_loaders_pixels(tmp_path, jax_native):
    """224 px PNGs through Resize(256) -> CenterCrop(224): the port's loader
    and the JAX loader's default (native) path give the same pixels; the JAX
    loader's PIL path does not (so the check can see a difference)."""
    rng = np.random.default_rng(5)
    os.makedirs(tmp_path / "images")
    lines = ["image_path,source,original_class,unified_class"]
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)).save(
            tmp_path / "images" / f"s{i}.png")
        lines.append(f"images/s{i}.png,s,c{i % 2},c{i % 2}")
    (tmp_path / "metadata.csv").write_text("\n".join(lines) + "\n")
    meta = str(tmp_path / "metadata.csv")

    def images(mod, vocab, **kw):
        idx = mod.MetadataIndex(meta, vocab)
        return next(iter(mod.Loader(idx, batch_size=4, image_size=224, resize=256, **kw))).images

    got = images(tloader, TVocab.from_classes(["c0", "c1"]))
    np.testing.assert_array_equal(got, images(jloader, JVocab.from_classes(["c0", "c1"])))
    pil = images(jloader, JVocab.from_classes(["c0", "c1"]), decode_backend="pil")
    assert (got != pil).mean() > 0.05 and np.abs(got.astype(int) - pil).max() <= 2


def test_build_failure_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setenv("APVT_TORCH_BUILD_DIR", str(tmp_path / "build"))
    bad = tmp_path / "broken.cc"
    bad.write_text('extern "C" int f() { return undeclared_name; }\n')
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed on broken.*undeclared_name"):
        _build.load_host("broken", [str(bad)])


def test_host_flags_name_no_native_arch():
    flags = _build.host_cxx_flags()
    assert not any(f.startswith("-march") or f.startswith("-mtune") for f in flags)
    cpu = open("/proc/cpuinfo").read() if os.path.exists("/proc/cpuinfo") else ""
    has_fma = bool(re.search(r"^flags\s*:.*\bfma\b", cpu, re.M))
    assert ("-mfma" in flags) == (has_fma and os.uname().machine == "x86_64")
