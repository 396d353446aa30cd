"""ctypes binding for the repository's host C++ image library (``native/``).

Counterpart of the JAX package's ``utils/native.py``, with the same functions
and return conventions: PNG decode and encode, the fused PNG decode + resize +
center crop of the loader, batched resize + center crop, the ETL's
resize-with-padding and batched normalization, over ``native/src/png_codec.cc``
and ``native/src/image_ops.cc`` (read, never edited).

The library is built with ``g++`` on first use into the port's build directory
(``kernels/_build.load_host``: named by a hash of the sources and flags, so an
edited source rebuilds and later processes reuse the build). There is no
fallback: a failed build raises with the compiler's output, and nothing here
imports PIL. The decoders return ``None`` for the PNGs they do not handle
(16-bit, interlaced, sub-byte palettes, absurd dimensions); the caller decides
what to do with those.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCES = tuple(os.path.join(_REPO, "native", "src", f) for f in ("image_ops.cc", "png_codec.cc"))

# Upper bound on the PNG dimensions the decoders allocate for: a corrupt but
# well-formed IHDR can claim 2^30 x 2^30, and the C++ side would fail to
# allocate (std::terminate through the extern "C" boundary).
_MAX_PNG_DIM = 16384


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8 = ctypes.POINTER(ctypes.c_uint8)
    f32 = ctypes.POINTER(ctypes.c_float)
    i = ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    for name, args, res in (
            ("apvt_resize_center_crop", [u8, i, i, i, i, u8], None),
            ("apvt_batch_resize_center_crop", [u8, i, i, i, i, i, u8, i], None),
            ("apvt_resize_with_padding", [u8, i, i, i, u8], None),
            ("apvt_batch_u8_to_f32_normalize", [u8, i, i, i, f32, f32, f32, i], None),
            ("apvt_png_info", [u8, ctypes.c_long, ip, ip], i),
            ("apvt_png_decode_rgb", [u8, ctypes.c_long, u8], i),
            ("apvt_png_decode_resize_center_crop", [u8, ctypes.c_long, i, i, u8], i),
            ("apvt_png_encode_rgb", [u8, i, i, i, u8, ctypes.c_long], ctypes.c_long),
            ("apvt_png_encode_bound", [i, i], ctypes.c_long)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def load() -> ctypes.CDLL:
    """The library handle, built on first use (raises if it cannot be built)."""
    global _LIB
    if _LIB is not None:
        # assigned once under the lock and never reset: the loader's decode
        # threads do not queue on the lock for every image
        return _LIB
    with _LOCK:
        if _LIB is None:
            from ..kernels import _build

            _LIB = _configure(_build.load_host("apvt_native", SOURCES))
    return _LIB


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check_crop(resize: int, crop: int) -> None:
    if crop > resize:
        # the C++ resampler computes only min(crop, new side) columns; a larger
        # crop would leave bytes of the np.empty output unwritten
        raise ValueError(f"crop ({crop}) must be <= resize ({resize})")


def resize_center_crop(img: np.ndarray, resize: int, crop: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (crop, crop, 3): shorter-side antialiased bilinear
    resize + center crop (the torchvision eval-pipeline geometry)."""
    lib = load()
    _check_crop(resize, crop)
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((crop, crop, 3), np.uint8)
    lib.apvt_resize_center_crop(_u8ptr(img), img.shape[0], img.shape[1], resize, crop,
                                _u8ptr(out))
    return out


def batch_resize_center_crop(imgs: np.ndarray, resize: int, crop: int,
                             *, max_threads: int = 8) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, crop, crop, 3), on C++ threads."""
    lib = load()
    _check_crop(resize, crop)
    imgs = np.ascontiguousarray(imgs, np.uint8)
    n, h, w, _ = imgs.shape
    out = np.empty((n, crop, crop, 3), np.uint8)
    lib.apvt_batch_resize_center_crop(_u8ptr(imgs), n, h, w, resize, crop, _u8ptr(out),
                                      max_threads)
    return out


def resize_with_padding(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (size, size, 3): aspect-preserving resize + centered
    zero pad (the ETL geometry)."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((size, size, 3), np.uint8)
    lib.apvt_resize_with_padding(_u8ptr(img), img.shape[0], img.shape[1], size, _u8ptr(out))
    return out


def _png_dims(lib, buf: np.ndarray) -> Optional[tuple[int, int]]:
    """(h, w) from the IHDR, or None when the decoder refuses the file or the
    dimensions pass :data:`_MAX_PNG_DIM` (the C++ buffers are sized from
    them)."""
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.apvt_png_info(_u8ptr(buf), len(buf), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    if h.value > _MAX_PNG_DIM or w.value > _MAX_PNG_DIM:
        return None
    return h.value, w.value


def decode_png_rgb(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes -> (H, W, 3) uint8 RGB (alpha dropped, palettes looked up, as
    PIL's ``convert("RGB")``); None for a PNG the decoder does not handle."""
    lib = load()
    buf = np.frombuffer(data, np.uint8)
    dims = _png_dims(lib, buf)
    if dims is None:
        return None
    out = np.empty((*dims, 3), np.uint8)
    if lib.apvt_png_decode_rgb(_u8ptr(buf), len(data), _u8ptr(out)) != 0:
        return None
    return out


def decode_png_resize_center_crop(data: bytes, resize: int, crop: int) -> Optional[np.ndarray]:
    """The loader's path in one native call: PNG bytes -> shorter-side resize
    + center crop -> (crop, crop, 3) uint8; None for a PNG the decoder does not
    handle."""
    lib = load()
    _check_crop(resize, crop)
    buf = np.frombuffer(data, np.uint8)
    if _png_dims(lib, buf) is None:
        return None
    out = np.empty((crop, crop, 3), np.uint8)
    if lib.apvt_png_decode_resize_center_crop(_u8ptr(buf), len(data), resize, crop,
                                              _u8ptr(out)) != 0:
        return None
    return out


def encode_png_rgb(img: np.ndarray, *, level: int = 6) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, fixed up filter, zlib or
    libdeflate compression): lossless, so any decoder reads the same pixels."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("encode_png_rgb expects (H, W, 3)")
    h, w, _ = img.shape
    cap = lib.apvt_png_encode_bound(h, w)
    out = np.empty(cap, np.uint8)
    n = lib.apvt_png_encode_rgb(_u8ptr(img), h, w, level, _u8ptr(out), cap)
    if n <= 0:
        raise RuntimeError("native PNG encode failed")
    return out[:n].tobytes()


def batch_normalize(imgs: np.ndarray, mean, std, *, max_threads: int = 8) -> np.ndarray:
    """(N, H, W, 3) uint8 -> float32 ``(x/255 - mean)/std`` on C++ threads."""
    lib = load()
    imgs = np.ascontiguousarray(imgs, np.uint8)
    n, h, w, _ = imgs.shape
    mean_a = np.ascontiguousarray(mean, np.float32)
    std_a = np.ascontiguousarray(std, np.float32)
    out = np.empty((n, h, w, 3), np.float32)
    f32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))  # noqa: E731
    lib.apvt_batch_u8_to_f32_normalize(_u8ptr(imgs), n, h, w, f32p(mean_a), f32p(std_a),
                                       f32p(out), max_threads)
    return out
