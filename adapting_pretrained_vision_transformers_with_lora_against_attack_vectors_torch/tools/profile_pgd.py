"""A ``torch.profiler`` trace of the zoo's PGD program and its device-time
table: the port's counterpart of ``tools/profile_pgd.py``.

Traces exactly the program ``tools/bench_zoo.py`` times (``bench_zoo.build``:
the backbone's bf16 params, PGD-``--steps`` at ``--batch``), one warm call
inside ``utils.observability.profile_trace`` (the trace file under
``--out``), and prints ``tools/trace_table.py``'s table: device ms per kernel
group, the top kernels, the device's busy time and the idle share against
the unprofiled wall. ``--table_json`` writes the table. The port has no
scanned encoder, so ``--scan`` is refused.

Usage: python -m <port>.tools.profile_pgd [--backbone google_vit] [--batch 64]
       [--steps 10] [--top 25] [--out DIR] [--table_json T.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..kernels import _build
from . import bench_zoo, timing, trace_table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(_build.build_dir(), "trace_pgd"))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--scan", action="store_true",
                    help="refused: the port has no scanned encoder")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--table_json", default=None, help="also write the table as JSON")
    ap.add_argument("--backbone", default="google_vit",
                    help="zoo registry name (bench_zoo's program)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.scan:
        ap.error("--scan: the port's encoders are unrolled module lists; there is no scanned "
                 "encoder to profile")
    device = timing.resolve_device(args.device)

    call, _ = bench_zoo.build(args.backbone, args.batch, args.steps, device)
    gen = lambda i: torch.Generator(device).manual_seed(i)  # noqa: E731
    timing.fetch_sum(call([gen(0)]))  # warm-up: kernels built and loaded
    table = trace_table.trace_call(lambda: timing.fetch_sum(call([gen(1)])), args.out, device,
                                   top=args.top)
    for line in trace_table.lines(table, "profile_pgd", f"{args.backbone} PGD-{args.steps} "
                                  f"B={args.batch} bf16", timing.device_kind(device), top=args.top):
        print(line)
    print(f"trace: {table['trace']}")
    if args.table_json:
        trace_table.write(table, args.table_json)
        print(f"wrote {args.table_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
