"""Filesystem contract: the inter-stage API of the whole pipeline.

Counterpart of the JAX package's ``data/io.py``, without pandas or PIL.

Stages exchange data through directories of PNGs plus ``metadata.csv`` with
columns ``image_path, source, original_class, unified_class`` (reference
Process.py:715-721). This module owns that contract on the write side and
the adversarial-image persistence:

* :class:`Table`: a metadata file in memory, ordered column names and rows
  of ``str``. :func:`read_metadata` / :func:`save_metadata` go through the
  ``csv`` module; the written file is byte for byte what pandas'
  ``to_csv(index=False)`` writes for the same rows (``\\n`` line ends,
  minimal quoting). A cell pandas reads as missing (empty, ``NA``, ``nan``,
  ...) reads as :data:`MISSING`, which is the string ``"nan"`` (what the
  JAX package's ``str(...)`` of a missing cell gives) and is written back
  empty. Other cells keep their text (pandas would turn ``007`` into 7).
* :func:`save_images`: clamp to [0,1], quantize to uint8 with the
  reference's truncation semantics (Utils.py:106-113), write PNGs with the
  native encoder (``utils.native``) on a thread pool (the encoder runs in C++
  with the interpreter lock released); another file type through PIL, where
  it is installed (:func:`pil_image`).
* :func:`create_adv_metadata`: clean metadata rows re-pointed at an
  adversarial image directory (Utils.py:115-120).
* :func:`filter_metadata`: the rows of the given sources (Utils.py:95-104).
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Iterable, Optional, Sequence

METADATA_COLUMNS = ("image_path", "source", "original_class", "unified_class")

# the cells pandas' read_csv takes as missing by default
NA_CELLS = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                      "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                      "nan", "null"})


class _Missing(str):
    """The type of :data:`MISSING`."""


MISSING = _Missing("nan")  # a missing cell: "nan" to every reader, empty when written


class Table:
    """Rows of ``str`` under ordered column names.

    ``table[column]`` is that column's values in row order;
    :meth:`take` selects rows by position (repeats allowed);
    :meth:`with_column` replaces a column's values."""

    def __init__(self, columns: Sequence[str], rows: Iterable[Sequence[str]] = ()):
        self.columns = tuple(columns)
        self.rows = [tuple(r) for r in rows]
        for r in self.rows:
            if len(r) != len(self.columns):
                raise ValueError(f"row of {len(r)} cells under {len(self.columns)} columns")

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, column: str) -> list[str]:
        j = self.columns.index(column)
        return [r[j] for r in self.rows]

    def take(self, positions: Iterable[int]) -> "Table":
        return Table(self.columns, (self.rows[i] for i in positions))

    def with_column(self, column: str, values: Sequence[str]) -> "Table":
        values = list(values)
        if len(values) != len(self.rows):
            raise ValueError(f"{len(values)} values for {len(self.rows)} rows")
        j = self.columns.index(column)
        return Table(self.columns, (r[:j] + (v,) + r[j + 1:] for r, v in zip(self.rows, values)))


def read_metadata(path: str) -> Table:
    """``metadata.csv`` -> :class:`Table` (blank lines skipped, as pandas does)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        columns = next(reader)
        rows = [[MISSING if c in NA_CELLS else c for c in r] for r in reader if r]
    return Table(columns, rows)


def filter_metadata(metadata: str | Table, sources: Optional[Iterable[str]]) -> Table:
    df = read_metadata(metadata) if isinstance(metadata, str) else metadata
    if sources:
        keep = set(sources)
        df = df.take(i for i, s in enumerate(df["source"]) if s in keep)
    return df


def save_metadata(df: Table, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(df.columns)
        writer.writerows(["" if c is MISSING else c for c in r] for r in df.rows)


def save_images(images, filenames: Sequence[str], output_dir: str, *,
                max_workers: int = 8,
                pool: Optional[ThreadPoolExecutor] = None) -> list[Future]:
    """Write a batch of [0,1] NHWC float images as uint8 PNGs (the native
    encoder, as the JAX package's default; PNG is lossless, so any decoder
    reads the same pixels).

    ``pool``: optional caller-owned executor, so per-batch callers (e.g.
    ``attacks.generate``) reuse one pool for a whole split. With a pool the
    encodes are only submitted: the futures are returned and the caller waits
    for them (``attacks.generate`` overlaps them with the next batch's
    attack). Without one the files are written when this returns (and the
    list is empty)."""
    # lazy: data.io <-> attacks would otherwise import each other
    from ..attacks.common import uint8_quantize
    from ..utils import native

    os.makedirs(output_dir, exist_ok=True)
    arr = uint8_quantize(images)

    def write(i_name):
        i, name = i_name
        path = os.path.join(output_dir, name)
        if name.endswith(".png"):
            data = native.encode_png_rgb(arr[i])
            with open(path, "wb") as f:
                f.write(data)
        else:
            pil_image(path).fromarray(arr[i]).save(path)

    if pool is not None:
        return [pool.submit(write, item) for item in enumerate(filenames)]
    if len(filenames) > 1:
        with ThreadPoolExecutor(max_workers=max_workers) as own:
            list(own.map(write, enumerate(filenames)))
    else:
        for item in enumerate(filenames):
            write(item)
    return []


def pil_image(path: str):
    """PIL's ``Image`` module, for a file the native codec does not handle
    (not a PNG, or a PNG it refuses); where PIL is not installed, an error
    that names the file."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: the native PNG codec does not handle this file and PIL "
                           "is not installed") from None
    return Image


def create_adv_metadata(clean_meta: str | Table, filenames: Iterable[str],
                        adv_dir: str, *,
                        originals: Optional[Iterable[str]] = None) -> Table:
    """Clean metadata rows matching ``filenames``, re-pointed at ``adv_dir``
    (same row order/columns as the reference's version).

    ``originals``: parallel iterable of the clean basename each written file
    came from, needed when duplicate basenames were disambiguated by the
    writer (attacks/generate). Each written file is consumed by exactly ONE
    clean row (in row order), so k duplicate rows map to the k files written
    for them instead of all pointing at one surviving PNG."""
    df = read_metadata(clean_meta) if isinstance(clean_meta, str) else clean_meta
    written = list(filenames)
    origs = list(originals) if originals is not None else list(written)
    if len(written) != len(origs):
        raise ValueError(f"filenames ({len(written)}) and originals "
                         f"({len(origs)}) must be parallel")
    by_orig: dict[str, deque] = defaultdict(deque)
    for w, o in zip(written, origs):
        by_orig[o].append(w)
    keep_idx, new_paths = [], []
    for i, p in enumerate(df["image_path"]):
        q = by_orig.get(os.path.basename(p))
        if q:
            keep_idx.append(i)
            new_paths.append(os.path.join(adv_dir, q.popleft()))
    return df.take(keep_idx).with_column("image_path", new_paths)


def resolve_image_path(img_path: str, metadata_dir: str, root_dir: str) -> Optional[str]:
    """Reference path-resolution order: absolute, metadata-relative,
    root-relative (Utils.py:28-48)."""
    for candidate in (img_path,
                      os.path.join(metadata_dir, img_path),
                      os.path.join(root_dir, img_path)):
        if os.path.exists(candidate):
            return os.path.normpath(candidate)
    return None
