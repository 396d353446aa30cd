"""The composability matrix's wall on one card: the port's counterpart of
``tools/bench_compose.py``, with its flags and artifact.

At the reference's scale: five attack adapters (rank 8, alpha 16, on the
backbone's targets and ``blocks/mlp/fc2``, each B moved off zero, each with
a head of its own), so 27 variants, over ``--datasets`` synthetic uint8
datasets of ``--n_per_dataset`` images. Two walls, on the host clock:

* variant build: the 27 merged models alone (``eval.compose``'s eager merge
  over the base and adapters resident on the card, ``build_variant_params``,
  then ``entry.from_tree``), each ended by a host fetch of one merged weight;
* the whole matrix: ``eval.compose.run_composability_eval`` (27 variants x
  every dataset through the shared eval step), after one untimed run.

The JAX tool times two merge modes, ``host`` and ``device``. The port has
one, its eager merge on the card, recorded under ``host``. The ``device``
mode is ``compose.make_device_variant_builder``, a jitted merge program
against a remote-device transport that the port does not port (ROADMAP.md,
"Not to port"): its fields are null.

Usage: python -m <port>.tools.bench_compose [--json COMPOSE.json]
       [--model google_vit] [--n_per_dataset 192] [--datasets 6] [--batch 64]
       [--tiny] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ..data.loader import Batch
from ..eval import compose
from ..models import registry
from ..ops import lora
from . import timing

ATTACKS = ("fgsm", "pgd", "autoattack", "patch", "rp2")
DEVICE_MODE_NOTE = ("device merge mode: null. compose.make_device_variant_builder (a jitted "
                    "merge program against a remote-device transport) is not ported; the "
                    "port's one mode merges eagerly on the card and is recorded as host")


class ArrayLoader:
    """Minimal in-memory loader: pre-batched uint8 arrays -> ``Batch`` stream."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch: int):
        self.batches = []
        for i in range(0, len(labels), batch):
            ib, lb = images[i:i + batch], labels[i:i + batch]
            self.batches.append(Batch(
                images=ib, labels=lb.astype(np.int32),
                valid=np.ones(len(lb), np.float32),
                filenames=[f"s{i + j}.png" for j in range(len(lb))]))

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def fetch_scalar(model) -> float:
    """Wait for a merged model: fetch one scalar of its first q weight (or of
    its first parameter)."""
    params = dict(model.named_parameters())
    leaf = next((p for n, p in params.items() if n.endswith("attn.q.w")),
                next(iter(params.values())))
    return timing.fetch_sum(leaf.reshape(-1)[:1])


def setup(model: str, classes: int, rank: int, tiny: bool):
    """``(entry, cfg, params, adapters)``: seeded random base params and five
    adapters with heads (CPU tensors, JAX layout)."""
    entry = registry.get_model(model)
    cfg = entry.config(classes)
    if tiny:
        cfg = dataclasses.replace(cfg, image_size=32, patch_size=8, hidden_dim=64, depth=2,
                                  num_heads=2, mlp_dim=128)
    params = entry.init(cfg, torch.Generator().manual_seed(0))
    targets = tuple(entry.lora_targets(cfg))
    if "blocks/mlp/fc2" not in targets:
        targets += ("blocks/mlp/fc2",)
    lcfg = lora.LoRAConfig(rank=rank, alpha=16.0, dropout=0.0, targets=targets)
    adapters = {}
    for i, name in enumerate(ATTACKS):
        ad = lora.init(torch.Generator().manual_seed(10 + i), params, lcfg)
        # B off zero so that merges change weights; a distinct head per attack
        ad = {p: {k: v + 0.01 * (i + 1) for k, v in fac.items()} for p, fac in ad.items()}
        head = {"w": params["head"]["w"] * (1 + 0.01 * i), "b": params["head"]["b"].clone()}
        adapters[name] = (ad, lcfg, head)
    return entry, cfg, params, adapters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", default="google_vit")
    ap.add_argument("--classes", type=int, default=21)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n_per_dataset", type=int, default=192)
    ap.add_argument("--datasets", type=int, default=6)
    ap.add_argument("--tiny", action="store_true", help="shrink the backbone geometry (CPU)")
    args = ap.parse_args(argv)
    device = timing.resolve_device(args.device)

    entry, cfg, params, adapters = setup(args.model, args.classes, args.rank, args.tiny)
    rng = np.random.default_rng(7)
    loaders = {}
    for d in range(args.datasets):
        imgs = rng.integers(0, 256, (args.n_per_dataset, cfg.image_size, cfg.image_size, 3),
                            dtype=np.uint8)
        labels = rng.integers(0, args.classes, args.n_per_dataset)
        loaders["clean" if d == 0 else ATTACKS[d - 1]] = ArrayLoader(imgs, labels, args.batch)

    variants = compose.enumerate_variants(ATTACKS)
    n_imgs = len(variants) * args.datasets * args.n_per_dataset
    print(f"{len(variants)} variants x {args.datasets} datasets x {args.n_per_dataset} imgs")

    variant = compose.make_device_variants(entry, cfg, params, adapters, device)
    fetch_scalar(variant(variants[0][1]))  # warm-up
    t0 = time.perf_counter()
    for _, combo in variants:
        fetch_scalar(variant(combo))
    build_host = time.perf_counter() - t0
    print(f"variant build x{len(variants)}: {build_host:.2f}s")

    def run_matrix() -> float:
        t0 = time.perf_counter()
        compose.run_composability_eval(entry, params, adapters, loaders, args.classes,
                                       device=device, cfg=cfg, log=lambda *_: None)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    run_matrix()  # warm-up: kernels built and loaded
    matrix_host = run_matrix()
    print(f"matrix wall: {matrix_host:.1f}s ({n_imgs / matrix_host:.0f} imgs/s)")
    print(DEVICE_MODE_NOTE)

    if args.json:
        with open(args.json, "w") as f:
            json.dump({
                "device": timing.device_kind(device),
                "variants": len(variants), "datasets": args.datasets,
                "n_per_dataset": args.n_per_dataset, "batch": args.batch,
                "build_wall_s": {"host": round(build_host, 3), "device": None},
                "matrix_wall_s": {"host": round(matrix_host, 2), "device": None},
                "matrix_imgs_per_s": {"host": round(n_imgs / matrix_host, 1), "device": None},
            }, f, indent=2)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
