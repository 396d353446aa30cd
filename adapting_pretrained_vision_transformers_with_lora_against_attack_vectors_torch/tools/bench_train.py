"""Train-step throughput on one card: the port's counterpart of
``tools/bench_train.py``, with its modes, flags and record.

The two training programs the port ships, at ViT-B/16 (224 px, 21 classes,
f32 params, bf16 compute), built exactly as the library builds them:

* ``full``: the full fine-tune step of ``train.loop.train_base_model``
  (``train.steps.make_train_step``, AdamW + StepLR from ``train.optim``,
  ``data.augment.train_augment`` on the card);
* ``lora`` / ``lora_pa``: the rank-8 LoRA step of ``train_lora_adapter``
  (``train.loop.lora_trainer`` over a bf16 base, q/k/v/o factors, dropout 0.1
  in mode ``input`` or ``post_a``, Adam; the head frozen, as in the JAX tool).

Each mode: one warm-up step (it builds the kernels at first use), then
``--iters`` steps on the same batch, a synchronize and a host fetch of the
last ``loss_sum`` (it depends on every update), on the host clock.
``mfu_pct_analytic`` is the port's FLOP count (``tools/flops.py``) over the
H100 SXM's dense bf16 peak; null for ``--tiny`` and off the card.

Usage: python -m <port>.tools.bench_train [--json TRAIN.json]
       [--modes full lora] [--batch 64] [--iters 8] [--no-augment]
       [--tiny] [--fused-block] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from ..attacks.common import IMAGENET
from ..data.augment import train_augment
from ..models import registry, vit
from ..ops import lora
from ..train import loop, optim
from ..train.steps import TrainState, make_train_step
from ..utils import trees
from . import flops, timing


def config(tiny: bool, fused_block: bool):
    """``(cfg, model label)``: ``vit_test`` at 32 px and 5 classes (f32
    compute; the kernel field off) for ``--tiny``, else ViT-B/16."""
    if tiny:
        return vit.VIT_TEST.with_classes(5), "vit_test"
    return dataclasses.replace(vit.VIT_B16.with_classes(21), fuse_attn_block=fused_block), "vitb"


def inputs(cfg, batch: int, device, seed: int = 0) -> dict:
    """Seeded random f32 params (JAX layout, on the CPU), images in [0, 1],
    labels and a ``valid`` mask of ones on ``device``."""
    size = cfg.image_size
    return {"params": vit.init(cfg, torch.Generator().manual_seed(seed)),
            "images": torch.rand((batch, size, size, 3), device=device,
                                 generator=torch.Generator(device).manual_seed(seed + 2)),
            "labels": torch.randint(0, cfg.num_classes, (batch,), device=device,
                                    generator=torch.Generator(device).manual_seed(seed + 3)),
            "valid": torch.ones(batch, device=device)}


def build_step(mode: str, batch: int, augment: bool, device, *, tiny: bool = False,
               fused_block: bool = False, data: dict | None = None) -> dict:
    """The step the bench times, and what it takes: ``{"step", "state",
    "images", "labels", "valid", "model", "cfg"}`` (``profile_train`` traces
    the same). ``data``: :func:`inputs`' dict (a test passes the JAX tool's)."""
    cfg, label = config(tiny, fused_block)
    data = data if data is not None else inputs(cfg, batch, device)
    entry = registry.get_model("vit_test" if tiny else "google_vit")
    forward = lambda m, x: vit.apply(cfg, m, x)  # noqa: E731
    generator = torch.Generator(device).manual_seed(17)
    aug = train_augment if augment else None
    if mode == "full":
        model = vit.params_from_jax(trees.map_leaves(
            lambda t: torch.as_tensor(t).to(device, copy=True), data["params"]), cfg)
        state = TrainState.create(model, None, lambda ps: optim.adamw_steplr(
            ps, 1e-4, weight_decay=1e-4, step_size_epochs=20, gamma=0.1, steps_per_epoch=100))
    elif mode in ("lora", "lora_pa"):
        lcfg = lora.LoRAConfig(rank=8, alpha=16.0, dropout=0.1, targets=vit.LORA_TARGETS_DEFAULT,
                               dropout_mode="post_a" if mode == "lora_pa" else "input")
        base = trees.cast_tree(data["params"], torch.bfloat16)
        model, state, _ = loop.lora_trainer(entry, cfg, base, lcfg, lr=1e-4, train_head=False,
                                            seed=0, device=device)
    else:
        raise ValueError(f"mode {mode!r}: full, lora or lora_pa")
    model.train()
    step = make_train_step(forward, model, normalize=IMAGENET,
                           generator=generator if augment else None, augment=aug)
    return {"step": step, "state": state, "images": data["images"], "labels": data["labels"],
            "valid": data["valid"], "model": label, "cfg": cfg}


def bench_mode(mode: str, batch: int, iters: int, augment: bool, device, *,
               tiny: bool = False, fused_block: bool = False) -> dict:
    built = build_step(mode, batch, augment, device, tiny=tiny, fused_block=fused_block)
    step, state = built["step"], built["state"]
    args = (built["images"], built["labels"], built["valid"])
    state, m = step(state, *args)  # warm-up: kernels built and loaded
    timing.fetch_sum(m["loss_sum"])
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, *args)
    timing.fetch_sum(m["loss_sum"])  # depends on the final params, so on every step
    ips = batch * iters / (time.perf_counter() - t0)
    on_card = torch.device(device).type == "cuda"
    return {
        "metric": f"train_step_images_per_sec_per_chip_{built['model']}_{mode}",
        "device_kind": timing.device_kind(device),
        "value": round(ips, 1),
        "unit": "images/sec/chip",
        "batch": batch,
        "augment": augment,
        # against the card's peak: meaningless for --tiny and off the card
        "mfu_pct_analytic": (round(flops.mfu_pct(ips, flops.train_step(built["cfg"], mode)), 1)
                             if on_card and not tiny else None),
        # what the flag engaged: --tiny builds without it (f32 compute); LoRA
        # factors on q/k/v/o keep the attention half unfused, fc1/fc2 fuse
        "fused_block": fused_block and not tiny,
        "fused_block_scope": ("none" if (not fused_block or tiny)
                              else "mlp_half_only" if mode.startswith("lora")
                              else "both_halves"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--modes", nargs="+", default=["full", "lora"], help="full, lora, lora_pa")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--no-augment", action="store_true")
    ap.add_argument("--tiny", action="store_true", help="vit_test at 32 px")
    ap.add_argument("--fused-block", action="store_true",
                    help="fuse_attn_block (in lora modes only the LN2 + MLP half engages)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = timing.resolve_device(args.device)

    records = []
    for mode in args.modes:
        rec = bench_mode(mode, args.batch, args.iters, not args.no_augment, device,
                         tiny=args.tiny, fused_block=args.fused_block)
        print(json.dumps(rec), flush=True)
        records.append(rec)

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"unit": "images/sec/chip",
                       "device": records[0]["device_kind"] if records else None,
                       "records": records}, f, indent=2)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
