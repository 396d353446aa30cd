"""Metadata-driven dataset index + prefetching batch loader.

Counterpart of the JAX package's ``data/loader.py`` with its default decode
backend, the native C++ library:

* :class:`MetadataIndex` resolves image paths (absolute, metadata-relative,
  root-relative) and encodes labels through the immutable
  :class:`..utils.vocab.LabelVocabulary`.
* :class:`Loader` decodes images on worker threads to a fixed shape,
  assembles padded uint8 batches in index order (a ``valid`` mask marks the
  padding rows of the last batch) and prefetches ahead of the consumer.
  Shuffling comes with the training stages. Batches go to the device as
  uint8; the conversion to [0,1] floats happens there.
* :class:`CachedLoader` decodes an unshuffled loader once and replays its
  batches from host memory, for consumers that sweep a split many times.

A PNG is decoded, resized and center-cropped in one call of
``utils.native`` (the pixels of the JAX loader's default path). A file the
native decoder refuses (not a PNG; a 16-bit, interlaced or sub-byte palette
PNG) is decoded by PIL, where PIL is installed, and resized natively, as the
JAX loader does; without PIL it raises, naming the file.
"""

from __future__ import annotations

import io
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from ..utils import native
from ..utils.vocab import LabelVocabulary
from .io import Table, filter_metadata, pil_image, read_metadata, resolve_image_path


@dataclass
class Batch:
    images: np.ndarray  # (B, H, W, 3) uint8
    labels: np.ndarray  # (B,) int32
    valid: np.ndarray  # (B,) float32, 0 for padding
    filenames: list[str]
    # positions into the owning MetadataIndex of the real samples; artifact
    # writers pair outputs with their exact metadata rows through these
    ids: Optional[np.ndarray] = None


class MetadataIndex:
    """Sample index over one ``metadata.csv`` (optionally source-filtered)."""

    def __init__(self, metadata: str | Table, vocab: LabelVocabulary, *,
                 root_dir: str = ".", sources: Optional[Sequence[str]] = None):
        df = read_metadata(metadata) if isinstance(metadata, str) else metadata
        meta_dir = os.path.dirname(os.path.abspath(metadata)) if isinstance(metadata, str) else root_dir
        df = filter_metadata(df, sources)

        self.vocab = vocab
        self.root_dir = root_dir
        paths, labels, filenames, kept, missing = [], [], [], [], 0
        for pos, (image_path, unified_class) in enumerate(zip(df["image_path"],
                                                               df["unified_class"])):
            resolved = resolve_image_path(image_path, meta_dir, root_dir)
            if resolved is None:
                missing += 1
                continue
            paths.append(resolved)
            labels.append(vocab.index_of(unified_class))
            filenames.append(os.path.basename(resolved))
            kept.append(pos)
        if missing:
            print(f"MetadataIndex: skipped {missing} rows with missing images")
        self.paths = paths
        self.labels = np.asarray(labels, np.int32)
        self.filenames = filenames
        # metadata rows of the retained samples: sample i <-> frame.rows[i]
        self.frame = df.take(kept)

    def __len__(self) -> int:
        return len(self.paths)


class Loader:
    """Batched iterator with threaded native decode + background prefetch."""

    NUM_WORKERS = 8  # decode threads
    PREFETCH = 2  # batches decoded ahead of the consumer

    def __init__(self, index: MetadataIndex, *, batch_size: int,
                 image_size: int = 224, resize: int = 256,
                 shuffle: bool = False, seed: int = 0):
        """``shuffle``: a fresh order every pass, a function of ``seed`` and
        the number of passes made (numpy's generator, as in the JAX class, so
        both packages see the same orders)."""
        if resize < image_size:
            raise ValueError(f"resize ({resize}) must be >= image_size ({image_size})")
        self.index = index
        self.batch_size = batch_size
        self.image_size = image_size
        self.resize = resize
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return (len(self.index) + self.batch_size - 1) // self.batch_size

    def _decode(self, i: int) -> np.ndarray:
        path = self.index.paths[i]
        with open(path, "rb") as f:
            data = f.read()
        if path.endswith(".png"):
            out = native.decode_png_resize_center_crop(data, self.resize, self.image_size)
            if out is not None:
                return out
        # a file the native decoder refuses: PIL decodes, the native code resizes
        with pil_image(path).open(io.BytesIO(data)) as img:
            arr = np.asarray(img.convert("RGB"), np.uint8)
        return native.resize_center_crop(arr, self.resize, self.image_size)

    def __iter__(self) -> Iterator[Batch]:
        order = np.arange(len(self.index))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        self._epoch += 1
        b = self.batch_size
        n_batches = len(self)

        def make_batch(pool: ThreadPoolExecutor, k: int) -> Batch:
            idxs = order[k * b:(k + 1) * b]
            imgs = list(pool.map(self._decode, idxs))
            pad = b - len(idxs)
            if pad:
                imgs.extend([np.zeros_like(imgs[0])] * pad)
            images = np.stack(imgs)
            labels = np.concatenate([self.index.labels[idxs], np.zeros(pad, np.int32)])
            valid = np.concatenate([np.ones(len(idxs), np.float32), np.zeros(pad, np.float32)])
            names = [self.index.filenames[i] for i in idxs]
            return Batch(images, labels, valid, names, ids=np.asarray(idxs))

        q: queue.Queue = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up once the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # exceptions reach the consumer through the queue, so it never
            # waits forever on a dead producer
            try:
                with ThreadPoolExecutor(max_workers=self.NUM_WORKERS) as pool:
                    for k in range(n_batches):
                        if stop.is_set() or not put(make_batch(pool, k)):
                            return
                put(None)
            except BaseException as e:  # noqa: BLE001
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


class CachedLoader:
    """Replayable wrapper: decode the underlying loader once, then serve its
    batches from host memory on every later pass.

    For consumers that sweep the same split many times (the eval stage runs
    one pass per variant and dataset). Caches only when the loader does not
    shuffle (a shuffling loader yields a different order each pass) and the
    decoded split fits ``max_bytes``; otherwise it passes batches through.
    The cache is published only after a complete first pass, so an
    interrupted pass leaves no partial cache behind. ``max_bytes`` and the
    shuffle rule mirror the JAX class.
    """

    def __init__(self, loader: Loader, *, max_bytes: int = 4 << 30):
        self.loader = loader
        est = len(loader.index) * loader.image_size * loader.image_size * 3
        self._cache: Optional[list[Batch]] = (
            [] if (not loader.shuffle and est <= max_bytes) else None)
        self._filled = False

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Batch]:
        if self._cache is None:
            yield from self.loader
            return
        if self._filled:
            yield from self._cache
            return
        fill: list[Batch] = []
        for b in self.loader:
            fill.append(b)
            yield b
        self._cache = fill
        self._filled = True
