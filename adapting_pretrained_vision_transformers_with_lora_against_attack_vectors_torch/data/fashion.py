"""FashionMNIST loader: the small-scale fixture of the BiLoRA workflow.

Counterpart of the JAX package's ``data/fashion.py``. The reference keeps
``fashion_data/FashionMNIST/raw`` and loads it with torchvision
(``train_bilora.ipynb``); this is a self-contained IDX parser (plain or
gzip) over local files only: nothing is downloaded.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

CLASSES = ("T-shirt/top", "Trouser", "Pullover", "Dress", "Coat", "Sandal",
           "Shirt", "Sneaker", "Bag", "Ankle boot")

_FILES = {
    ("train", "images"): "train-images-idx3-ubyte",
    ("train", "labels"): "train-labels-idx1-ubyte",
    ("test", "images"): "t10k-images-idx3-ubyte",
    ("test", "labels"): "t10k-labels-idx1-ubyte",
}


def _open(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def read_idx(path: str) -> np.ndarray:
    """Parse an IDX(1|3)-ubyte file (the MNIST family's container), or its
    ``.gz`` where that exists."""
    with _open(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dtype_code = (magic >> 8) & 0xFF
        if dtype_code != 0x08:  # ubyte, the only dtype the MNIST family uses
            raise ValueError(f"unsupported IDX dtype 0x{dtype_code:02x} in {path}")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), np.uint8)
        return data.reshape(dims)


def load_split(root: str, split: str = "train",
               *, limit: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
    """(images uint8 (N, 28, 28), labels int32 (N,)) from
    ``{root}/FashionMNIST/raw`` (the reference's layout) or a flat ``{root}``."""
    for base in (os.path.join(root, "FashionMNIST", "raw"), root):
        img_path = os.path.join(base, _FILES[(split, "images")])
        lbl_path = os.path.join(base, _FILES[(split, "labels")])
        if os.path.exists(img_path) or os.path.exists(img_path + ".gz"):
            images = read_idx(img_path)
            labels = read_idx(lbl_path).astype(np.int32)
            if limit is not None:
                images, labels = images[:limit], labels[:limit]
            return images, labels
    raise FileNotFoundError(
        f"FashionMNIST idx files not found under {root!r} "
        "(no network egress — place the raw files locally)")


def to_rgb_float(images: np.ndarray, *, image_size: int = 32) -> np.ndarray:
    """(N, 28, 28) uint8 -> (N, S, S, 3) float32 in [0, 1]: each image
    resized by PIL's bilinear filter, as the JAX package does (so the two
    agree bit for bit), and its grey replicated to RGB. Needs PIL."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError("fashion.to_rgb_float resizes with PIL, which is not "
                           "installed") from None
    n = images.shape[0]
    out = np.empty((n, image_size, image_size), np.float32)
    for i in range(n):
        im = Image.fromarray(images[i]).resize((image_size, image_size), Image.BILINEAR)
        out[i] = np.asarray(im, np.float32) / 255.0
    return np.repeat(out[..., None], 3, axis=-1)


def write_idx(path: str, array: np.ndarray) -> None:
    """Inverse of :func:`read_idx` (test fixtures)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    array = np.ascontiguousarray(array, np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 + array.ndim))
        for d in array.shape:
            f.write(struct.pack(">I", d))
        f.write(array.tobytes())
