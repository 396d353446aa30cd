"""Forward-only evaluation throughput per backbone on one card: the port's
counterpart of ``tools/bench_eval.py``, with its flags, rows and artifact.

The composability matrix's hot loop and the serving path: each backbone's
registry config at 21 classes, seeded random params cast to bf16 (the
``google_vit`` ``+int8`` row: ``ops/quant.quantize_dense_tree`` over
``vit.QUANT_TARGETS_DEFAULT`` after the cast), ``--iters`` forward passes at
batch 256 in an eager loop, each on an input shifted by the previous logits
(``clip(x + tanh(logits[:, :1]) * 1e-4, 0, 1)``: the JAX tool's data
dependence, so no pass can be left out), then a synchronize and a host fetch
of the sum, on the host clock after one warm-up loop. ``--sweep_batch``
times the first backbone at other batch sizes.

Usage: python -m <port>.tools.bench_eval [--json EVAL.json] [--batch 256]
       [--iters 20] [--sweep_batch 64 128 512] [--models ...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from ..models import registry, vit
from ..ops import quant
from ..utils import trees
from . import timing

DEFAULT_MODELS = ["google_vit", "dinov1", "swin", "convnext", "yolo11-cls"]
CLASSES = 21


def build(name: str, batch: int, iters: int, device, *, int8: bool = False):
    """``(sweep, images)``: ``sweep(images)`` runs the chained forward loop
    and returns the sum of its output (a device scalar)."""
    entry = registry.get_model(name)
    cfg = entry.config(CLASSES)
    tree = trees.cast_tree(entry.init(cfg, torch.Generator().manual_seed(0)), torch.bfloat16)
    if int8:
        tree = quant.quantize_dense_tree(tree, vit.QUANT_TARGETS_DEFAULT)
    model = entry.from_tree(trees.map_leaves(lambda t: t.to(device), tree), cfg)
    size = cfg.image_size
    images = torch.rand((batch, size, size, 3), device=device,
                        generator=torch.Generator(device).manual_seed(2))

    @torch.no_grad()
    def sweep(x):
        for _ in range(iters):
            logits = entry.apply(cfg, model, x)
            shift = (torch.tanh(logits[:, :1]) * 1e-4)[:, :, None, None]
            x = torch.clamp(x + shift, 0.0, 1.0)
        return x.sum()

    return sweep, images


def bench_one(name: str, batch: int, iters: int, device, *, int8: bool = False):
    """-> (images/s, the output's sum)."""
    sweep, images = build(name, batch, iters, device, int8=int8)
    timing.fetch_sum(sweep(images))  # warm-up: kernels built and loaded
    t0 = time.perf_counter()
    s = timing.fetch_sum(sweep(images))
    return batch * iters / (time.perf_counter() - t0), s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", nargs="+", default=DEFAULT_MODELS)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sweep_batch", nargs="*", type=int, default=[64, 128, 256, 512],
                    help="extra batch sizes for the FIRST model only (none: no sweep)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = timing.resolve_device(args.device)

    records = []
    for b in args.sweep_batch:
        if b == args.batch or not args.models:
            continue
        rec = {"backbone": args.models[0], "batch": b, "int8": False,
               "metric": "eval_forward_imgs_per_sec_per_chip"}
        try:
            v, _ = bench_one(args.models[0], b, args.iters, device)
            rec["value"] = round(v, 1)
            print(f"batch sweep {args.models[0]} B={b}: {rec['value']} imgs/s")
        except Exception as e:  # keep sweeping; the exit code says so
            traceback.print_exc()
            rec["error"] = f"{type(e).__name__}: {e}"
        records.append(rec)
    print(f"| backbone | eval imgs/s (B={args.batch}) |")
    print("|---|---|")
    variants = [(n, False) for n in args.models]
    if "google_vit" in args.models:
        variants.append(("google_vit", True))  # the W8A8 serving path
    for name, int8 in variants:
        label = name + ("+int8" if int8 else "")
        rec = {"backbone": name, "metric": "eval_forward_imgs_per_sec_per_chip",
               "batch": args.batch, "int8": int8}
        try:
            v, _ = bench_one(name, args.batch, args.iters, device, int8=int8)
            rec["value"] = round(v, 1)
            print(f"| {label} | {rec['value']} |")
        except Exception as e:  # record per-backbone failures and go on
            traceback.print_exc()
            rec["error"] = f"{type(e).__name__}: {e}"
            print(f"| {label} | ERROR {rec['error'][:60]} |")
        records.append(rec)

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"unit": "images/sec/chip", "device": timing.device_kind(device),
                       "records": records}, f, indent=2)
        print(f"wrote {args.json}")
    return 1 if any("error" in r for r in records) else 0


if __name__ == "__main__":
    sys.exit(main())
