"""Adversarial-dataset generation over whole splits.

Counterpart of the JAX package's ``attacks/generate.py``, with the same
directory contract: for each model x source x split, each attack writes
``{adv_root}/{model}/{source}/{split}/{attack}/images/*.png`` and
``metadata.csv``, rows paired through the loader's own sample index.
Batches go to the device as uint8; the attack converts them to [0,1] there.
The PNGs go through ``data.io.save_images`` (the native encoder), the
metadata through ``data.io.Table``.

Under a mesh (``parallel.mesh``, every rank calling) each rank attacks its
rows of each batch, on a model built on the same mesh (whose draws are the
global batch's, sliced); the adversarial batch is gathered over the data
axis and rank 0 encodes and writes it, so the PNG bytes and
``metadata.csv`` are the single-process run's.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from ..data import io as data_io
from ..data.loader import Loader
from ..parallel import mesh as pmesh

_SEED_STRIDE = 100003  # batches per seed before two seeds' streams meet


def generate_adversarial_split(
    attack_fn: Callable,
    params,
    loader: Loader,
    *,
    out_dir: str,
    clean_metadata: data_io.Table,
    device: torch.device | str,
    seed: int = 0,
    mesh=None,
) -> data_io.Table:
    """Run ``attack_fn(params, images, labels, generator) -> adv`` over a split
    on ``device`` (where ``params`` live; the caller must name it).

    Batch ``k`` draws its random start from a generator seeded with
    ``seed * 100003 + k``. Writes ``{out_dir}/images/*.png`` and
    ``{out_dir}/metadata.csv``; returns the adversarial metadata frame.
    ``mesh``: see the module docstring; rank 0 writes.
    """
    img_dir = os.path.join(out_dir, "images")
    main = pmesh.is_main(mesh)
    if main:
        os.makedirs(img_dir, exist_ok=True)
    device = torch.device(device)

    all_names: list[str] = []  # unique written filenames, in loader order
    all_origs: list[str] = []  # the clean basename each written file is for
    all_ids: list[int] = []  # MetadataIndex sample positions
    seen: dict[str, int] = {}

    def unique_name(name: str) -> str:
        # duplicate basenames across class directories would overwrite each
        # other in the flat images/ dir: disambiguate, keep the original
        k = seen.get(name, 0)
        seen[name] = k + 1
        if k == 0:
            return name
        stem, ext = os.path.splitext(name)
        return f"{stem}__{k}{ext}"

    def wait(futures) -> None:
        for f in futures:
            f.result()

    # batch k-1's PNG encodes run on the pool while the device runs batch k's
    # attack; at most one batch is pending, as in the JAX package
    pending: list = []
    with ThreadPoolExecutor(max_workers=8) as pool:
        for k, batch in enumerate(loader):
            images, labels = (torch.from_numpy(a).to(device)
                              for a in pmesh.shard_batch(mesh, batch.images, batch.labels))
            gen = torch.Generator(device).manual_seed(seed * _SEED_STRIDE + k)
            adv = pmesh.gather_rows(mesh, attack_fn(params, images, labels, gen))
            wait(pending)
            adv = adv.cpu()
            keep = [i for i, v in enumerate(batch.valid) if v > 0]
            origs = [batch.filenames[i] for i in keep]
            uniq = [unique_name(n) for n in origs]
            if main:
                pending = data_io.save_images(adv[keep], uniq, img_dir, pool=pool)
            all_names.extend(uniq)
            all_origs.extend(origs)
            if batch.ids is not None:
                all_ids.extend(int(batch.ids[i]) for i in keep)
        wait(pending)

    frame = getattr(getattr(loader, "index", None), "frame", None)
    if frame is not None and len(all_ids) == len(all_names):
        order = np.argsort(np.asarray(all_ids), kind="stable")
        adv_meta = frame.take(all_ids[i] for i in order).with_column(
            "image_path", [os.path.join(img_dir, all_names[i]) for i in order])
    else:  # a loader without an index frame: basename matching
        adv_meta = data_io.create_adv_metadata(
            clean_metadata, all_names, img_dir, originals=all_origs)
    if main:
        data_io.save_metadata(adv_meta, os.path.join(out_dir, "metadata.csv"))
    return adv_meta


def attack_output_dir(adv_root: str, model: str, source: str, split: str,
                      attack: str) -> str:
    """Directory contract: {adv_root}/{model}/{source}/{split}/{attack}."""
    return os.path.join(adv_root, model, source, split, attack)
