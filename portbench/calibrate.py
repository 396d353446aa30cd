"""The readings that a cell's limits are set from, on the card, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control_seeds 7,8,9 [--fault_seeds 7,8,9] --seconds 2 --out <file.jsonl>

* ``sound``: the benchmark's own run of the cell (set-up, a window at the
  cell's load, the check) on each of ``--seeds``: the numbers it compares;
* ``control``: the same numbers where the program is replaced by its control,
  one precision below the configuration's bf16: for an attack cell the
  program's own W8A8 path (``ops/quant``), on each of ``--control_seeds``;
  for a training cell the reference itself computed with float8 (e4m3)
  products from the program's own starts, read in each sound run;
* ``fault:<name>`` (training cells): the program with a fault planted under
  the timed path (``portbench/faults.py``), on each of ``--fault_seeds``.

Each reading is one JSON line in ``--out``; the last line is the summary:
each number's largest sound reading and its smallest control and fault
readings.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ["APVT_TORCH_BUILD_DIR"] = os.path.join(ROOT, ".portbench_cache", "kernels")
os.environ["USE_FLAX"] = "0"
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, ROOT)]

from portbench import faults  # noqa: E402
from portbench.core import bench, spec  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--fault_seeds", default="")
    ap.add_argument("--faults", default="half_batch,altered_answer")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault_seconds", type=float, default=None,
                    help="the fault runs' window (default: --seconds)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.cell(args.workload)
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    rows = []
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "w")

    def emit(kind, seed, values, extra=None):
        row = {"kind": kind, "seed": seed, "values": values, **(extra or {})}
        rows.append(row)
        out.write(json.dumps(row) + "\n")
        out.flush()
        print(json.dumps(row), flush=True)

    is_train = cell.traffic["driver"] == "train"
    for seed in seeds(args.seeds):
        # a training run with ``control`` runs the program as it is and reads
        # both: the program's numbers and the float8 reference's in its place
        line = bench.run(cell, seed, args.seconds, False, device, time.perf_counter(),
                         control=is_train)
        info = line["_info"]
        if info.get("by_step"):
            print(json.dumps({"seed": seed, "by_step": info["by_step"]}), file=sys.stderr)
        extra = {"units": info["units"], "rate": line["attempted"] / info["window_s"],
                 "peak": line["device"]["memory_peak_bytes"]}
        if is_train:
            emit("sound", seed, info["program_values"], extra)
            emit("control", seed, info["values"])
        else:
            emit("sound", seed, info["values"], extra)
    for seed in seeds(args.control_seeds) if not is_train else ():
        line = bench.run(cell, seed, args.seconds, False, device, time.perf_counter(),
                         control=True)
        if line["_info"].get("by_step"):
            print(json.dumps({"control": seed, "by_step": line["_info"]["by_step"]}),
                  file=sys.stderr)
        emit("control", seed, line["_info"]["values"])
    if is_train:
        for fault in [f for f in args.faults.split(",") if f]:
            for seed in seeds(args.fault_seeds):
                undo = faults.plant("train", fault)
                try:
                    line = bench.run(cell, seed, args.fault_seconds or args.seconds, False,
                                     device, time.perf_counter())
                finally:
                    undo()
                emit(f"fault:{fault}", seed, line["_info"]["values"])
    summary = {}
    for row in rows:
        for name, v in row["values"].items():
            s = summary.setdefault(name, {})
            key = "sound_max" if row["kind"] == "sound" else f"{row['kind']}_min"
            s[key] = max(s.get(key, v), v) if row["kind"] == "sound" else min(s.get(key, v), v)
    out.write(json.dumps({"summary": summary}) + "\n")
    out.close()
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
