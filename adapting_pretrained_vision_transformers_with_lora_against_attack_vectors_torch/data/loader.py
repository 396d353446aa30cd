"""Metadata-driven dataset index + prefetching batch loader.

Counterpart of the JAX package's ``data/loader.py`` with its PIL decode
backend (bit-exact with the torchvision eval pipeline):

* :class:`MetadataIndex` resolves image paths (absolute, metadata-relative,
  root-relative) and encodes labels through the immutable
  :class:`..utils.vocab.LabelVocabulary`.
* :class:`Loader` decodes images on worker threads to a fixed shape,
  assembles padded uint8 batches in index order (a ``valid`` mask marks the
  padding rows of the last batch) and prefetches ahead of the consumer.
  Shuffling comes with the training stages. Batches go to the device as
  uint8; the conversion to [0,1] floats happens there.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import pandas as pd
from PIL import Image

from ..utils.vocab import LabelVocabulary
from .io import filter_metadata, read_metadata, resolve_image_path
from .transforms import eval_transform_pil


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

    def __init__(self, metadata: str | pd.DataFrame, vocab: LabelVocabulary, *,
                 root_dir: str = ".", sources: Optional[Sequence[str]] = None):
        df = read_metadata(metadata) if isinstance(metadata, str) else metadata
        meta_dir = os.path.dirname(os.path.abspath(metadata)) if isinstance(metadata, str) else root_dir
        df = filter_metadata(df, sources)

        self.vocab = vocab
        self.root_dir = root_dir
        paths, labels, filenames, kept, missing = [], [], [], [], 0
        for pos, row in enumerate(df.itertuples()):
            resolved = resolve_image_path(str(row.image_path), meta_dir, root_dir)
            if resolved is None:
                missing += 1
                continue
            paths.append(resolved)
            labels.append(vocab.index_of(str(row.unified_class)))
            filenames.append(os.path.basename(resolved))
            kept.append(pos)
        if missing:
            print(f"MetadataIndex: skipped {missing} rows with missing images")
        self.paths = paths
        self.labels = np.asarray(labels, np.int32)
        self.filenames = filenames
        # metadata rows of the retained samples: sample i <-> frame.iloc[i]
        self.frame = df.iloc[kept].reset_index(drop=True)

    def __len__(self) -> int:
        return len(self.paths)


class Loader:
    """Batched iterator with threaded PIL decode + background prefetch."""

    NUM_WORKERS = 8  # decode threads
    PREFETCH = 2  # batches decoded ahead of the consumer

    def __init__(self, index: MetadataIndex, *, batch_size: int,
                 image_size: int = 224, resize: int = 256):
        if resize < image_size:
            raise ValueError(f"resize ({resize}) must be >= image_size ({image_size})")
        self.index = index
        self.batch_size = batch_size
        self.image_size = image_size
        self.resize = resize

    def __len__(self) -> int:
        return (len(self.index) + self.batch_size - 1) // self.batch_size

    def _decode(self, i: int) -> np.ndarray:
        with Image.open(self.index.paths[i]) as img:
            return eval_transform_pil(img, resize=self.resize, crop=self.image_size)

    def __iter__(self) -> Iterator[Batch]:
        order = np.arange(len(self.index))
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
