"""Synthetic traffic-sign-style dataset generator.

Produces the exact filesystem contract of the real ETL output
(``{root}/{split}/images/*.png`` + ``{split}/metadata.csv`` with columns
``image_path, source, original_class, unified_class``, reference
Process.py:715-721) from nothing — shape/color-coded classes rendered with
numpy. Used by tests, the CPU-runnable integration config (BASELINE.json
config 1), and CLI demos; plays the role the reference's committed
``fashion_data/`` fixture plays (SURVEY.md §2.1 item 15) without binary
blobs in the repo. PNGs go through the native encoder (``utils.native``) and
``metadata.csv`` through :mod:`.io`: the pixels and the metadata equal the
JAX package's for the same seed and style (the PNG bytes may differ).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import native
from .io import METADATA_COLUMNS, Table, save_metadata

DEFAULT_CLASSES = ("no_entry", "speed_limit", "stop", "warning", "yield")

# "hard" style: classes share shape AND color within each group and differ
# only in a small inner glyph (bar count), like real speed-limit signs that
# differ only in the printed digits (GTSRB's limit_20/30/50/70...). The
# default style's classes are separable by dominant color alone, which makes
# a fine-tuned ViT-B trivially robust to Linf attacks (every cell of the r3
# flagship matrix saturated at 1.0); glyph-coded classes keep clean accuracy
# learnable while restoring the non-robust fine-feature margins the
# reference's real corpus has, so attacks at the reference-exact eps=8/255
# (whitebox_attacks.py:59-61) actually discriminate defended variants.
HARD_CLASSES = (
    "speed_limit_20", "speed_limit_30", "speed_limit_50", "speed_limit_70",
    "info_parking", "info_crossing", "info_hospital", "info_bus",
    "warn_curve", "warn_bump", "warn_ice", "warn_animals",
)


def _render_hard(cls_idx: int, rng: np.random.Generator, size: int) -> np.ndarray:
    """Sign with a group shape/border-color and a (1 + cls%4)-bar inner glyph.

    Group g = (cls//4)%3 selects circle/square/triangle; within a group the
    only class-discriminative feature is the thin dark bar pattern."""
    group, code = (cls_idx // 4) % 3, cls_idx % 4
    img = rng.integers(0, 70, (size, size, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    c = size / 2.0
    r = size * (0.30 + 0.06 * rng.random())
    cx = c + rng.uniform(-0.02, 0.02) * size
    cy = c + rng.uniform(-0.02, 0.02) * size

    if group == 0:  # red-ring circle (speed-limit family)
        outer = (xx - cx) ** 2 + (yy - cy) ** 2 < r ** 2
        inner = (xx - cx) ** 2 + (yy - cy) ** 2 < (0.80 * r) ** 2
        border = (200, 30, 30)
    elif group == 1:  # blue square (info family)
        outer = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < r)
        inner = (np.abs(xx - cx) < 0.80 * r) & (np.abs(yy - cy) < 0.80 * r)
        border = (30, 60, 200)
    else:  # red-bordered triangle (warning family), apex up

        def tri(rr):
            return (yy - cy > -rr) & (np.abs(xx - cx) < (yy - cy + rr) / 2)

        outer, inner = tri(r), tri(0.78 * r)
        border = (200, 30, 30)

    img[outer] = np.asarray(border, np.uint8)
    img[inner] = int(rng.integers(195, 231))  # near-white interior

    # glyph: (code+1) bold vertical bars, centered on the sign interior
    # (bar width ~10 px at 224 — thin enough to be a fine feature relative
    # to the 8/255 Linf ball, bold enough that a from-scratch ViT-B/16
    # learns the count from a few hundred images)
    n = code + 1
    bw = max(2, round(size * 0.045))
    gap = max(2, round(size * 0.045))
    span = n * bw + (n - 1) * gap
    gy = cy + (0.22 * r if group == 2 else 0.0)  # triangle mass sits lower
    gh = 0.60 * r
    x0 = cx - span / 2.0
    glyph = np.zeros((size, size), bool)
    for i in range(n):
        xs = x0 + i * (bw + gap)
        glyph |= (xx >= xs) & (xx < xs + bw) & (np.abs(yy - gy) < gh / 2)
    img[glyph & inner] = int(rng.integers(25, 56))

    noise = rng.integers(0, 18, (size, size, 3), dtype=np.uint8)
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def _render(cls_idx: int, rng: np.random.Generator, size: int) -> np.ndarray:
    """Class-dependent geometric figure + noise; classes are separable but
    not trivially so (color AND shape carry the label)."""
    img = rng.integers(0, 60, (size, size, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    c = size / 2.0
    r = size * (0.28 + 0.1 * rng.random())
    cx = c + rng.uniform(-2, 2)
    cy = c + rng.uniform(-2, 2)
    color = np.zeros(3, np.uint8)
    color[cls_idx % 3] = 230
    color[(cls_idx + 1) % 3] = 40 * (cls_idx % 5)

    if cls_idx % 3 == 0:  # disk
        mask = (xx - cx) ** 2 + (yy - cy) ** 2 < r ** 2
    elif cls_idx % 3 == 1:  # square
        mask = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < r)
    else:  # triangle
        mask = (yy - cy > -r) & (np.abs(xx - cx) < (yy - cy + r) / 2)
    img[mask] = color
    noise = rng.integers(0, 25, (size, size, 3), dtype=np.uint8)
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def make_synthetic_dataset(root: str, *, classes=None,
                           n_per_class: dict | int = 8, image_size: int = 32,
                           splits=("train", "val", "test"), source: str = "synthetic",
                           seed: int = 0, style: str = "default") -> dict[str, Table]:
    """Write the dataset under ``root``; returns per-split metadata frames.

    ``style='default'`` renders 5 color+shape-separable classes (easy,
    Linf-robust by construction); ``style='hard'`` renders 12 glyph-coded
    confusable classes (see HARD_CLASSES) for robustness experiments."""
    if classes is None:
        classes = HARD_CLASSES if style == "hard" else DEFAULT_CLASSES
    render = _render_hard if style == "hard" else _render
    if isinstance(n_per_class, int):
        n_per_class = {s: n_per_class for s in splits}
    out = {}
    for si, split in enumerate(splits):
        rng = np.random.default_rng((seed, si))
        img_dir = os.path.join(root, split, "images")
        os.makedirs(img_dir, exist_ok=True)
        rows = []
        for ci, cls in enumerate(classes):
            for j in range(n_per_class[split]):
                name = f"{cls}_{split}_{j:04d}.png"
                with open(os.path.join(img_dir, name), "wb") as f:
                    f.write(native.encode_png_rgb(render(ci, rng, image_size)))
                rows.append((os.path.join("images", name), source, cls, cls))
        df = Table(METADATA_COLUMNS, rows)
        save_metadata(df, os.path.join(root, split, "metadata.csv"))
        out[split] = df
    return out
