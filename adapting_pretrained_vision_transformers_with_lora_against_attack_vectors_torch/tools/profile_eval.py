"""A ``torch.profiler`` trace of the eval-forward program and its
device-time table: the port's counterpart of ``tools/profile_eval.py``.

Traces exactly the program ``tools/bench_eval.py`` times (``bench_eval.build``:
the backbone's bf16 params, ``--iters`` chained forward passes at
``--batch``): prints the chained wall on the host clock and its images/s,
then one warm loop inside ``utils.observability.profile_trace`` (the trace
file under ``--out``) and ``tools/trace_table.py``'s table, so device time
per image can be read against the wall; ``--table_json`` writes the table.

Usage: python -m <port>.tools.profile_eval [--backbone google_vit] [--batch 256]
       [--iters 8] [--top 25] [--out DIR] [--table_json T.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..kernels import _build
from . import bench_eval, timing, trace_table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(_build.build_dir(), "trace_eval"))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--table_json", default=None, help="also write the table as JSON")
    ap.add_argument("--backbone", default="google_vit")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = timing.resolve_device(args.device)

    sweep, images = bench_eval.build(args.backbone, args.batch, args.iters, device)
    timing.fetch_sum(sweep(images))  # warm-up: kernels built and loaded
    t0 = time.perf_counter()
    timing.fetch_sum(sweep(images))
    wall = time.perf_counter() - t0
    print(f"chained eval wall: {wall * 1e3:.1f} ms for {args.iters} iters (batch {args.batch}) "
          f"= {args.batch * args.iters / wall:.0f} imgs/s on {timing.device_kind(device)}")
    table = trace_table.trace_call(lambda: timing.fetch_sum(sweep(images)), args.out, device,
                                   top=args.top)
    for line in trace_table.lines(table, "profile_eval", f"{args.backbone} {args.iters} forward "
                                  f"passes B={args.batch} bf16", timing.device_kind(device),
                                  top=args.top):
        print(line)
    print(f"trace: {table['trace']}")
    if args.table_json:
        trace_table.write(table, args.table_json)
        print(f"wrote {args.table_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
