"""Filesystem contract: the inter-stage API of the whole pipeline.

Copy of the JAX package's ``data/io.py`` (PIL encoder only).

Stages exchange data through directories of PNGs plus ``metadata.csv`` with
columns ``image_path, source, original_class, unified_class`` (reference
Process.py:715-721) — this module is the single owner of that contract on
the write side and of adversarial-image persistence:

* :func:`save_images` — clamp to [0,1], quantize to uint8 with the
  reference's truncation semantics (Utils.py:106-113), write PNGs. Encoding
  is fanned out over a thread pool (PIL releases the GIL around zlib).
* :func:`create_adv_metadata` — rewrite clean metadata rows to point at an
  adversarial image directory (Utils.py:115-120).
* :func:`filter_metadata` — source filter returning a DataFrame (the
  reference round-trips through a temp CSV, Utils.py:95-104).
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Iterable, Optional, Sequence

import numpy as np
import pandas as pd
from PIL import Image

METADATA_COLUMNS = ("image_path", "source", "original_class", "unified_class")


def read_metadata(path: str) -> pd.DataFrame:
    return pd.read_csv(path)


def filter_metadata(metadata: str | pd.DataFrame, sources: Optional[Iterable[str]]) -> pd.DataFrame:
    df = read_metadata(metadata) if isinstance(metadata, str) else metadata
    if sources:
        df = df[df["source"].isin(list(sources))]
    return df.reset_index(drop=True)


def save_metadata(df: pd.DataFrame, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    df.to_csv(path, index=False)


def save_images(images, filenames: Sequence[str], output_dir: str, *,
                max_workers: int = 8,
                pool: Optional[ThreadPoolExecutor] = None) -> list[Future]:
    """Write a batch of [0,1] NHWC float images as uint8 PNGs (PIL encoder;
    PNG is lossless, so the pixels equal any other encoder's).

    ``pool``: optional caller-owned executor, so per-batch callers (e.g.
    ``attacks.generate``) reuse one pool for a whole split. With a pool the
    encodes are only submitted: the futures are returned and the caller waits
    for them (``attacks.generate`` overlaps them with the next batch's
    attack). Without one the files are written when this returns (and the
    list is empty)."""
    # lazy: data.io <-> attacks would otherwise import each other
    from ..attacks.common import uint8_quantize

    os.makedirs(output_dir, exist_ok=True)
    arr = uint8_quantize(images)

    def write(i_name):
        i, name = i_name
        Image.fromarray(arr[i]).save(os.path.join(output_dir, name))

    if pool is not None:
        return [pool.submit(write, item) for item in enumerate(filenames)]
    if len(filenames) > 1:
        with ThreadPoolExecutor(max_workers=max_workers) as own:
            list(own.map(write, enumerate(filenames)))
    else:
        for item in enumerate(filenames):
            write(item)
    return []


def create_adv_metadata(clean_meta: str | pd.DataFrame, filenames: Iterable[str],
                        adv_dir: str, *,
                        originals: Optional[Iterable[str]] = None) -> pd.DataFrame:
    """Clean metadata rows matching ``filenames``, re-pointed at ``adv_dir``
    (same row order/columns as the reference's version).

    ``originals``: parallel iterable of the clean basename each written file
    came from — needed when duplicate basenames were disambiguated by the
    writer (attacks/generate). Each written file is consumed by exactly ONE
    clean row (in row order), so k duplicate rows map to the k files written
    for them instead of all pointing at one surviving PNG."""
    df = read_metadata(clean_meta) if isinstance(clean_meta, str) else clean_meta
    written = list(filenames)
    origs = list(originals) if originals is not None else list(written)
    from collections import defaultdict, deque

    if len(written) != len(origs):
        raise ValueError(f"filenames ({len(written)}) and originals "
                         f"({len(origs)}) must be parallel")
    by_orig: dict[str, deque] = defaultdict(deque)
    for w, o in zip(written, origs):
        by_orig[o].append(w)
    keep_idx, new_paths = [], []
    for i, p in enumerate(df["image_path"]):
        q = by_orig.get(os.path.basename(str(p)))
        if q:
            keep_idx.append(i)
            new_paths.append(os.path.join(adv_dir, q.popleft()))
    adv = df.iloc[keep_idx].copy()
    adv["image_path"] = new_paths
    return adv


def resolve_image_path(img_path: str, metadata_dir: str, root_dir: str) -> Optional[str]:
    """Reference path-resolution order: absolute, metadata-relative,
    root-relative (Utils.py:28-48)."""
    for candidate in (img_path,
                      os.path.join(metadata_dir, img_path),
                      os.path.join(root_dir, img_path)):
        if os.path.exists(candidate):
            return os.path.normpath(candidate)
    return None
