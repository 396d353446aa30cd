"""PGD-10 throughput over the five-backbone zoo on one card: the port's
counterpart of ``tools/bench_zoo.py``, with its flags, table and artifact.

For each backbone: its registry config at 21 classes and full size, seeded
random params cast to bf16, ``attacks.whitebox.make_pgd`` at batch 64
(eps 8/255, alpha 3/255), a warm-up call (which builds the kernels at first
use), then ``--iters`` chained calls (each on the previous output, random
starts from ``torch.Generator(device).manual_seed(i)``), a synchronize and a
host fetch of the output's sum, timed on the host clock.

The ViT family and Swin always run their attention kernel on the card
(packed and window attention: the port has no unfused attention path there),
so ``--no-fused`` is refused; ``--fused-block`` sets ``fuse_attn_block`` and
``fuse_ln_mlp`` where the config has them. A record's ``fused_attention``
and ``fused_block`` say what the backbone ran, not what was asked. A
backbone that fails is recorded with ``error`` and the sweep goes on; the
tool then exits 1.

Usage: python -m <port>.tools.bench_zoo [--models google_vit swin ...]
       [--batch 64] [--steps 10] [--iters 4] [--fused-block] [--json ZOO.json]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch

from ..attacks import whitebox
from ..models import registry
from ..utils import trees
from . import timing

DEFAULT_MODELS = ["google_vit", "dinov1", "swin", "convnext", "yolo11-cls"]
CLASSES, EPS, ALPHA = 21, 8 / 255, 3 / 255
# the families whose attention is a kernel of this repo on every CUDA call
ATTENTION_KERNEL_FAMILIES = ("vit", "swin")


def build(name: str, batch: int, steps: int, device, *, fused_block: bool = False):
    """``(call, applied)``: ``call(starts)`` runs one PGD-``steps`` call per
    start (a ``torch.Generator``), each on the previous output, and returns
    the last output; ``applied`` is what the backbone's config ran."""
    entry = registry.get_model(name)
    cfg = entry.config(CLASSES)
    applied = {"use_fused_attention": entry.family in ATTENTION_KERNEL_FAMILIES}
    for flag in ("fuse_attn_block", "fuse_ln_mlp"):
        if hasattr(cfg, flag):
            cfg = dataclasses.replace(cfg, **{flag: fused_block})
            applied[flag] = fused_block
    tree = trees.cast_tree(entry.init(cfg, torch.Generator().manual_seed(0)), torch.bfloat16)
    model = entry.from_tree(trees.map_leaves(lambda t: t.to(device), tree), cfg)
    run = whitebox.make_pgd(entry.apply, cfg, eps=EPS, alpha=ALPHA, steps=steps)
    size = cfg.image_size
    images = torch.rand((batch, size, size, 3), device=device,
                        generator=torch.Generator(device).manual_seed(2))
    labels = torch.randint(0, CLASSES, (batch,), device=device,
                           generator=torch.Generator(device).manual_seed(3))

    def call(starts):
        x = images
        for gen in starts:
            x = run(model, x, labels, gen)
        return x

    return call, applied


def bench_one(name: str, batch: int, steps: int, iters: int, device, *,
              fused_block: bool = False) -> tuple[float, dict]:
    """-> (images/s, applied flags)."""
    call, applied = build(name, batch, steps, device, fused_block=fused_block)
    gen = lambda i: torch.Generator(device).manual_seed(i)  # noqa: E731
    timing.fetch_sum(call([gen(99)]))  # warm-up: kernels built and loaded
    t0 = time.perf_counter()
    timing.fetch_sum(call([gen(i) for i in range(iters)]))
    return batch * iters / (time.perf_counter() - t0), applied


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", nargs="+", default=DEFAULT_MODELS)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--no-fused", action="store_true",
                    help="refused: the port has no unfused attention path on the card")
    ap.add_argument("--fused-block", action="store_true",
                    help="fuse_attn_block / fuse_ln_mlp on backbones that have them")
    ap.add_argument("--json", default=None,
                    help="also write a machine-readable per-backbone artifact")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.no_fused:
        ap.error("--no-fused: the port's ViT and Swin always run their CUDA attention kernel "
                 "on the card (packed and window attention); there is no unfused path to time")
    device = timing.resolve_device(args.device)

    records = []
    print(f"| backbone | PGD-{args.steps} imgs/s (B={args.batch}) |")
    print("|---|---|")
    for name in args.models:
        rec = {"backbone": name, "metric": f"pgd{args.steps}_imgs_per_sec_per_chip",
               "batch": args.batch, "steps": args.steps}
        try:
            v, applied = bench_one(name, args.batch, args.steps, args.iters, device,
                                   fused_block=args.fused_block)
            rec["value"] = round(v, 1)
            rec["fused_attention"] = applied["use_fused_attention"]
            rec["fused_block"] = (applied.get("fuse_attn_block", False)
                                  or applied.get("fuse_ln_mlp", False))
            print(f"| {name} | {v:.1f} |", flush=True)
        except Exception as e:  # keep sweeping, as the JAX tool does; the exit code says so
            traceback.print_exc()
            rec["value"] = None
            rec["error"] = f"{type(e).__name__}: {e}"
            print(f"| {name} | FAILED: {type(e).__name__}: {e} |", flush=True)
        records.append(rec)

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"unit": "images/sec/chip", "device": timing.device_kind(device),
                       "records": records}, f, indent=2)
        print(f"wrote {args.json}")
    return 1 if any("error" in r for r in records) else 0


if __name__ == "__main__":
    sys.exit(main())
