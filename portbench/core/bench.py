"""One run of one cell: set-up, the measured window, the traced units, the
check against the reference, and the result line.

The window runs whole units (attack batches, training steps) until
``--seconds`` have passed on the host clock, then the driver's closing
units (the window's last, which its check reads), and ends when the device
has finished them: a rate is all the images of all the units over the time from
the first unit's start to the last unit's end. Set-up is everything from the
process's start to the first timed unit being ready: imports, the CUDA
context, the kernels loaded (built on the first run in a checkout), the
parameters made, the program built and warmed up on the cell's own shapes.
With ``--trace 1`` the window is measured the same way; whole units then run
under the profiler, after it.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from . import spec
from . import trace as tracing

# the JAX package, its alias, the repository's JAX tools, and JAX itself:
# none may be loaded in a run, compared by whole top-level module name
BANNED = ("jax", "jaxlib", "flax",
          "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu",
          "apvt_lora", "tools")


NOT_READ = 1e300  # a compared number that came out NaN or infinite: past every limit


def jax_modules() -> list[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in BANNED)


class Readings:
    """What a metric reader reads: the cell, the window, the trace."""

    def __init__(self, cell, *, setup_s, window_s, units, images, trace=None, taken=None):
        self.cell, self.setup_s, self.window_s = cell, setup_s, window_s
        self.units, self.images, self.trace = units, images, trace
        self.taken = taken or {}  # what the cell's run read in the window: {name: number}

    @property
    def unit_s(self) -> float:
        """The window's mean wall time of a unit."""
        return self.window_s / self.units


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        *, control: bool = False) -> dict:
    """The result line of one run (``correct`` and the numbers compared
    under ``checks``) on ``device``."""
    import torch

    device = torch.device(device)
    drv = cell.driver.Driver(cell, seed, device, control=control)
    drv.setup()
    drv.drain()
    setup_s = time.perf_counter() - t_start
    units = images = 0
    t0 = time.perf_counter()
    while True:
        images += drv.unit()
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    for _ in range(drv.closing()):
        images += drv.unit()
        units += 1
    drv.drain()
    window_s = time.perf_counter() - t0
    launches = drv.counters()
    on_card = device.type == "cuda"
    peak = max(torch.cuda.max_memory_allocated(device), getattr(drv, "setup_peak_bytes", 0)) \
        if on_card else 0
    traced = tracing.profile(drv, drv.trace_units) if trace else None
    drv.release()
    values, failed = drv.check()
    values = {n: v if math.isfinite(v) else NOT_READ for n, v in values.items()}
    limits = cell.limits["numbers"]
    checks = {n: {"value": values[n], "limit": lim} for n, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    got = Readings(cell, setup_s=setup_s, window_s=window_s, units=units, images=images,
                   trace=traced, taken=getattr(drv, "readings", None))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.reader(m["name"]).read(got)
        if v is None:  # nothing to read: the code it reads is off this cell's path
            print(f"portbench: {m['name']} read nothing in {cell.name}", file=sys.stderr)
        else:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": 1, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": images, "failed": failed,
            "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced.busy_s, traced.wall_s
        line["breakdown"] = traced.breakdown()
    line["checks"] = checks
    line["_info"] = {"values": values, "units": units, "window_s": window_s, "setup_s": setup_s,
                     "setup_phases": getattr(drv, "phases", None), "launches": launches,
                     "traced_counters": traced.counters if traced else None,
                     "by_step": getattr(drv, "by_step", None),
                     "program_values": getattr(drv, "program_values", None)}
    return line


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is false); the benchmark "
              "measures on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    line = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)
    found = jax_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded in this run: {found}",
              file=sys.stderr)
        return 3
    info = line.pop("_info")
    print(f"portbench: card {card_line()}", file=sys.stderr)
    print(f"portbench: {json.dumps(info, default=str)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
