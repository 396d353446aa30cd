"""A ``torch.profiler`` trace of the zoo's PGD program and its device-time
table: the port's counterpart of ``tools/profile_pgd.py``.

Traces exactly the program ``tools/bench_zoo.py`` times (``bench_zoo.build``:
the backbone's bf16 params, PGD-``--steps`` at ``--batch``), one warm call
inside ``utils.observability.profile_trace`` (the trace file under
``--out``), and prints ``tools/trace_table.py``'s table: device ms per kernel
group, the top kernels, the device's busy time, the idle share against
the unprofiled wall, and the idle gaps by the attack's span (its start,
each step's forward, backward and update; on the card a graphed step's
replay, update and the step itself) that was open when each began, and
the attack's step counters (``attacks.whitebox``'s ``GRAPH_CAPTURES``,
``GRAPH_REPLAYS``, ``EAGER_STEPS``) over the warm-up call and over the
table's calls, and the kernels' launches over the warm-up call, one batch
(``whitebox.launch_counts``: the attention kernels' and the LayerNorm
kernel's, read as an eager batch would count them). ``--table_json`` writes
the table. The port has no
scanned encoder, so ``--scan`` is refused.

Usage: python -m <port>.tools.profile_pgd [--backbone google_vit] [--batch 64]
       [--steps 10] [--top 25] [--out DIR] [--table_json T.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..attacks import whitebox
from ..kernels import _build
from . import bench_zoo, timing, trace_table

STEP_COUNTERS = ("GRAPH_CAPTURES", "GRAPH_REPLAYS", "EAGER_STEPS")


def step_counts() -> dict:
    """The attack's step counters: ``{name: count}``."""
    return {n: getattr(whitebox, n) for n in STEP_COUNTERS}


def launches_line(before: dict, after: dict) -> str:
    """The kernels' launches between two ``whitebox.launch_counts()``: the
    attention and LayerNorm counters always, any other that moved."""
    always = ("attention", "window_attention", "layer_norm")
    return "profile_pgd: kernel launches over the warm-up call (one batch): " + ", ".join(
        f"{m.__name__.rsplit('.', 1)[-1]}.{k} {after[(m, k)] - before[(m, k)]}"
        for m, k in after if m.__name__.rsplit(".", 1)[-1] in always
        or after[(m, k)] != before[(m, k)])


def counts_line(what: str, before: dict, after: dict) -> str:
    return f"profile_pgd: PGD steps over {what}: " + ", ".join(
        f"{n} {after[n] - before[n]}" for n in STEP_COUNTERS)


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
    counts, launches = [step_counts()], [whitebox.launch_counts()]
    timing.fetch_sum(call([gen(0)]))  # warm-up: kernels built and loaded, the step captured
    counts.append(step_counts())
    launches.append(whitebox.launch_counts())
    table = trace_table.trace_call(lambda: timing.fetch_sum(call([gen(1)])), args.out, device,
                                   top=args.top)
    counts.append(step_counts())
    for line in trace_table.lines(table, "profile_pgd", f"{args.backbone} PGD-{args.steps} "
                                  f"B={args.batch} bf16", timing.device_kind(device), top=args.top):
        print(line)
    print(counts_line("the warm-up call", *counts[:2]))
    print(counts_line("the table's calls (timed and traced)", *counts[1:]))
    print(launches_line(*launches))
    print(f"trace: {table['trace']}")
    if args.table_json:
        trace_table.write(table, args.table_json)
        print(f"wrote {args.table_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
