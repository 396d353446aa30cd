"""A ``torch.profiler`` trace of a training step and its device-time table:
the port's counterpart of ``tools/profile_train.py``.

Traces exactly the step ``tools/bench_train.py`` times
(``bench_train.build_step``: ViT-B/16, batch ``--batch``, ``--mode`` full or
LoRA), one warm step inside ``utils.observability.profile_trace`` (the trace
file under ``--out``), and prints ``tools/trace_table.py``'s table, the idle
gaps by the step's span (input, forward, backward, optimizer, metrics)
among it; ``--table_json`` writes it.

Usage: python -m <port>.tools.profile_train [--mode lora] [--batch 64]
       [--top 25] [--out DIR] [--table_json T.json] [--no-augment]
       [--fused-block] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

from ..kernels import _build
from . import bench_train, timing, trace_table


def trace_step(built: dict, out_dir: str, device, *, top: int = 25) -> dict:
    """One warm-up step of ``bench_train.build_step``'s dict, then the table
    of one traced step."""
    step, args = built["step"], (built["images"], built["labels"], built["valid"])

    def call():
        _, m = step(built["state"], *args)
        return timing.fetch_sum(m["loss_sum"])

    call()  # warm-up: kernels built and loaded
    return trace_table.trace_call(call, out_dir, device, top=top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="lora", choices=["full", "lora"])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", default=os.path.join(_build.build_dir(), "trace_train"))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--table_json", default=None, help="also write the table as JSON")
    ap.add_argument("--no-augment", action="store_true")
    ap.add_argument("--fused-block", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = timing.resolve_device(args.device)

    built = bench_train.build_step(args.mode, args.batch, not args.no_augment, device,
                                   fused_block=args.fused_block)
    table = trace_step(built, args.out, device, top=args.top)
    for line in trace_table.lines(table, "profile_train", f"{built['model']} {args.mode} step "
                                  f"B={args.batch}", timing.device_kind(device), top=args.top):
        print(line)
    print(f"trace: {table['trace']}")
    if args.table_json:
        trace_table.write(table, args.table_json)
        print(f"wrote {args.table_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
