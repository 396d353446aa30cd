"""The robustness study through the port's CLI -> one JSON artifact.

Counterpart of the JAX package's runner (``tools/run_robustness.py``): the
same eight stages in the same order (synth-data, train, the FGSM/PGD, EOT
patch, AutoAttack and RP2 attack stages, train-lora over the five families,
eval-compose), the same arguments, defaults and ``--quick`` geometry, and
an artifact with the same keys (``config``, ``stages``, ``total_seconds``,
``matrix``, ``aa_attribution``). Each stage runs ``python -m
<port>.cli --device <device> ...`` in a fresh process, with a timeout and
one retry in a new process; a stage that fails twice ends the run with an
error. ``--device`` takes the place of the JAX runner's ``--platform``: the
CLI refuses to run on the CPU unless ``--device cpu`` is given, and the
runner never moves a stage to the CPU by itself.

Resume (``--resume``) differs from the JAX runner's, which skips a stage when
its last output file exists:

* every stage that finishes writes a marker, ``<workdir>/markers/<stage>.json``,
  holding its argument list and the digests of the markers of the stages
  whose outputs it reads (``INPUTS``), and a fresh token, so that a stage run
  again has a new digest;
* a stage is skipped only when its marker holds the arguments it would run
  with and the current digests of its inputs' markers: a workdir made with
  other arguments is not reused, and a stage run again reruns every stage
  that reads its outputs;
* train-lora has one marker per family, so that a family added on resume is
  trained alone (one train-lora process over the families whose markers do
  not match);
* eval-compose always reruns, as in the JAX runner.

Usage: python -m <port>.tools.run_robustness [--out FILE] [--workdir DIR]
         [--device cuda] [--quick] [--resume] [counts ...]

A relative ``--workdir`` or ``--out`` is taken from the caller's working
directory (the stage processes run from the repository's root); the artifact
defaults to ``ROBUSTNESS_torch.json`` there.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Callable, Optional, Sequence

PKG = "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGE_TIMEOUT_S = float(os.environ.get("APVT_STAGE_TIMEOUT", "3600"))
STAGE_ATTEMPTS = int(os.environ.get("APVT_STAGE_ATTEMPTS", "2"))

FAMILIES = ("fgsm", "pgd", "patch_circle", "autoattack", "rp2")
# the stages whose outputs each stage reads
INPUTS = {"synth-data": (), "train": ("synth-data",),
          "attack-whitebox": ("synth-data", "train"), "attack-patch": ("synth-data", "train"),
          "attack-autoattack": ("synth-data", "train"), "attack-rp2": ("synth-data", "train")}
# the attack stage that writes each family's adversarial data
FAMILY_STAGE = {"fgsm": "attack-whitebox", "pgd": "attack-whitebox",
                "patch_circle": "attack-patch", "autoattack": "attack-autoattack",
                "rp2": "attack-rp2"}


def run_subprocess(argv: list[str]) -> tuple[int, str]:
    """One CLI stage in a fresh process: (exit code, its output)."""
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.cli", *argv], cwd=REPO, text=True,
                          capture_output=True, timeout=STAGE_TIMEOUT_S)
    return proc.returncode, proc.stdout + proc.stderr


class Runner:
    """The stages of one study over ``workdir``, with their markers.

    ``launch(argv) -> (rc, output)`` runs one CLI stage (``argv`` without the
    interpreter and module): :func:`run_subprocess`, or a recorder in tests."""

    def __init__(self, workdir: str, device: str, *, resume: bool,
                 launch: Callable[[list[str]], tuple[int, str]] = run_subprocess):
        self.markers = os.path.join(workdir, "markers")
        self.device = device
        self.resume = resume
        self.launch = launch
        self.stages: list[dict] = []

    def _marker_path(self, key: str) -> str:
        return os.path.join(self.markers, f"{key}.json")

    def digest(self, key: str) -> Optional[str]:
        """sha256 of a marker's bytes, or None when there is none."""
        try:
            with open(self._marker_path(key), "rb") as f:
                return hashlib.sha256(f.read()).hexdigest()
        except FileNotFoundError:
            return None

    def _stamp(self, argv: list[str], inputs: Sequence[str]) -> dict:
        return {"args": argv, "inputs": {k: self.digest(k) for k in inputs}}

    def matches(self, key: str, stamp: dict) -> bool:
        """True when ``key``'s marker holds ``stamp`` (arguments and input digests)."""
        try:
            with open(self._marker_path(key)) as f:
                held = json.load(f)
        except FileNotFoundError:
            return False
        return {k: held.get(k) for k in stamp} == stamp

    def _write_marker(self, key: str, stamp: dict) -> None:
        os.makedirs(self.markers, exist_ok=True)
        tmp = self._marker_path(key) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({**stamp, "token": uuid.uuid4().hex}, f, indent=1)
        os.replace(tmp, self._marker_path(key))

    def _clear_marker(self, key: str) -> None:
        if os.path.exists(self._marker_path(key)):
            os.unlink(self._marker_path(key))

    def run(self, name: str, cli_args: list[str], extra: Optional[dict] = None) -> None:
        """Run a stage (no marker: eval-compose), retrying once in a new
        process; raise after the last attempt."""
        argv = ["--device", self.device, *cli_args]
        for attempt in range(1, STAGE_ATTEMPTS + 1):
            t0 = time.perf_counter()
            try:
                rc, out = self.launch(argv)
            except subprocess.TimeoutExpired:
                dt = time.perf_counter() - t0
                print(f"=== {name}: TIMEOUT after {dt:.0f}s (attempt {attempt}/{STAGE_ATTEMPTS})",
                      flush=True)
                self.stages.append({"stage": name, "seconds": round(dt, 1), "rc": "timeout",
                                    "attempt": attempt, **(extra or {})})
                continue
            dt = time.perf_counter() - t0
            tail = "\n".join(out.strip().splitlines()[-14:])
            print(f"=== {name}: rc={rc} {dt:.1f}s\n{tail}", flush=True)
            self.stages.append({"stage": name, "seconds": round(dt, 1), "rc": rc,
                                **({"attempt": attempt} if attempt > 1 else {}),
                                **(extra or {})})
            if rc == 0:
                return
        raise RuntimeError(f"stage {name} failed after {STAGE_ATTEMPTS} attempts")

    def _resumed(self, name: str) -> None:
        print(f"=== {name}: resumed (its marker matches)", flush=True)
        self.stages.append({"stage": name, "seconds": None, "rc": 0, "resumed": True})

    def stage(self, name: str, cli_args: list[str]) -> None:
        """One stage with a marker: skipped under resume when the marker matches."""
        stamp = self._stamp(["--device", self.device, *cli_args], INPUTS[name])
        if self.resume and self.matches(name, stamp):
            self._resumed(name)
            return
        self._clear_marker(name)
        self.run(name, cli_args)
        self._write_marker(name, stamp)

    def train_lora(self, cli_args: list[str], families: Sequence[str]) -> None:
        """train-lora over ``families``: ``cli_args`` has no ``--attacks``; one
        marker per family, and one process over the families that need it."""
        stamps = {f: self._stamp(["--device", self.device, *cli_args, "--attacks", f],
                                 ("synth-data", "train", FAMILY_STAGE[f])) for f in families}
        todo = [f for f in families
                if not (self.resume and self.matches(f"train-lora.{f}", stamps[f]))]
        if not todo:
            self._resumed("train-lora")
            return
        for f in todo:
            self._clear_marker(f"train-lora.{f}")
        self.run("train-lora", [*cli_args, "--attacks", *todo],
                      {"families": todo} if len(todo) < len(families) else None)
        for f in todo:
            self._write_marker(f"train-lora.{f}", stamps[f])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="ROBUSTNESS_torch.json")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "apvt_robustness"))
    ap.add_argument("--model", default="google_vit")
    ap.add_argument("--style", default="hard", choices=["default", "hard"],
                    help="synthetic corpus style; 'hard' = 12 glyph-coded confusable classes so "
                         "the matrix discriminates")
    ap.add_argument("--n_per_class", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--epsilon", type=float, default=8 / 255,
                    help="whitebox/autoattack eps (the reference's 8/255)")
    ap.add_argument("--pgd_steps", type=int, default=30)
    ap.add_argument("--patch_iters", type=int, default=250)
    ap.add_argument("--rp2_iters", type=int, default=250)
    ap.add_argument("--rp2_patch_size", type=int, default=96)
    ap.add_argument("--aa_iters", type=int, default=50)
    ap.add_argument("--aa_queries", type=int, default=500)
    ap.add_argument("--lora_epochs", type=int, default=4)
    ap.add_argument("--quick", action="store_true",
                    help="tiny smoke config (vit_test, 32px) for CI-style runs")
    ap.add_argument("--device", default="cuda",
                    help="forwarded to every CLI stage: 'cuda' (the default), 'cuda:N' or 'cpu'")
    ap.add_argument("--resume", action="store_true",
                    help="skip each stage whose marker in --workdir holds the arguments it would "
                         "run with and the current markers of the stages it reads; "
                         "eval-compose always reruns")
    return ap


def main(argv=None, *, launch: Callable[[list[str]], tuple[int, str]] = run_subprocess) -> dict:
    """Run the study; returns the artifact (also written to ``--out``)."""
    args = build_parser().parse_args(argv)
    # the stages run with the repo as their cwd: every path handed to them, and
    # every path read or written here, is absolute
    args.workdir, args.out = os.path.abspath(args.workdir), os.path.abspath(args.out)
    d = args.workdir
    os.makedirs(d, exist_ok=True)
    if args.quick:
        # an explicit tiny backbone stays; only the flagship default becomes vit_test
        if args.model == "google_vit":
            args.model = "vit_test"
        image_size = 64 if args.model == "yolo11_test" else 32
        args.n_per_class, args.epochs, args.lora_epochs = 4, 1, 1
        args.pgd_steps, args.patch_iters, args.rp2_iters = 2, 3, 3
        args.rp2_patch_size = 8
        args.aa_iters, args.aa_queries = 2, 10
    else:
        image_size = 224

    runner = Runner(d, args.device, resume=args.resume, launch=launch)
    ck = os.path.join(d, "train", args.model, "all",
                      f"{args.model}_best_model_finetuned.safetensors")
    data, adv, loras, ev = (os.path.join(d, x) for x in ("data", "adv", "loras", "eval"))
    t_total = time.perf_counter()

    runner.stage("synth-data", ["synth-data", "--output_dir", data,
                                "--n_per_class", str(args.n_per_class),
                                "--image_size", str(image_size), "--style", args.style])
    runner.stage("train", ["train", "--data_root", data, "--model", args.model,
                           "--output_dir", os.path.join(d, "train"),
                           "--epochs", str(args.epochs), "--batch_size", "32"]
                 + (["--resize", str(image_size)] if args.quick else []))
    common = ["--data_root", data, "--model", args.model, "--model_path", ck,
              "--output_dir", adv]
    runner.stage("attack-whitebox", ["attack", *common, "--splits", "train", "val", "test",
                                     "--epsilon", str(args.epsilon),
                                     "--steps", str(args.pgd_steps), "--batch_size", "64"])
    runner.stage("attack-patch", ["patch-attack", *common, "--splits", "train", "val", "test",
                                  "--patch_type", "circle", "--max_iter", str(args.patch_iters),
                                  "--batch_size", "24"])
    aa_stats_path = os.path.join(d, "aa_stats.json")
    runner.stage("attack-autoattack", ["autoattack", *common, "--splits", "train", "val", "test",
                                       "--epsilon", str(args.epsilon),
                                       "--n_iter", str(args.aa_iters),
                                       "--square_queries", str(args.aa_queries),
                                       "--stats_json", aa_stats_path, "--batch_size", "64"])
    # RP2: patches train once on the train split (physical-sticker semantics)
    # and apply to all three splits
    runner.stage("attack-rp2", ["rp2-attack", *common, "--splits", "train", "val", "test",
                                "--patch_train_split", "train",
                                "--patch_size", str(args.rp2_patch_size),
                                "--max_iter", str(args.rp2_iters), "--batch_size", "24"])
    families = list(FAMILIES)
    runner.train_lora(["train-lora", "--data_root", data, "--model", args.model,
                       "--model_path", ck, "--adv_root", adv, "--output_dir", loras,
                       "--ranks", "8", "--epochs", str(args.lora_epochs),
                       "--batch_size", "32"], families)
    runner.run("eval-compose", ["eval-compose", "--data_root", data, "--model", args.model,
                                   "--model_path", ck, "--adv_root", adv, "--lora_root", loras,
                                   "--output_dir", ev, "--attacks", *families, "--rank", "8",
                                   "--batch_size", "64"])

    with open(os.path.join(ev, "test_results.json")) as f:
        matrix = json.load(f)
    artifact = {
        "config": {"model": args.model, "image_size": image_size, "style": args.style,
                   "n_per_class": args.n_per_class, "epochs": args.epochs,
                   "epsilon": args.epsilon, "pgd_steps": args.pgd_steps,
                   "patch_iters": args.patch_iters, "rp2_iters": args.rp2_iters,
                   "rp2_patch_size": args.rp2_patch_size, "aa_iters": args.aa_iters,
                   "aa_queries": args.aa_queries, "lora_epochs": args.lora_epochs,
                   "attack_families": families, "device": args.device,
                   **({"resumed": True} if args.resume else {})},
        "stages": runner.stages,
        "total_seconds": round(time.perf_counter() - t_total, 1),
        "matrix": matrix,
    }
    if os.path.exists(aa_stats_path):
        with open(aa_stats_path) as f:
            artifact["aa_attribution"] = json.load(f)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(f"wrote {args.out} (total {artifact['total_seconds']:.0f}s)")
    return artifact


if __name__ == "__main__":
    try:
        main()
    except RuntimeError as e:
        sys.exit(f"run_robustness: {e}")
