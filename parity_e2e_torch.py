"""End-to-end accuracy parity with three sides, on the host CPU: HF
``transformers`` + PEFT and the JAX package (``tools/parity_e2e.py``'s
``TorchSide`` and ``JaxSide``) beside the PyTorch port (its
``tools/parity_e2e.PortSide``, driven by ``run_port_side``).

The counterpart of ``tools/parity_e2e.py``'s ``main``, with the port as a
third side and the same protocol: one HF init from ``torch.manual_seed(0)``
imported by the other two sides; the corpus and the batch orders
(``default_rng(99)`` for the base fine-tune, ``default_rng(100)`` for the
LoRA defense) shared; dropout 0; FGSM and PGD without a random start, each
side against its own trained model, uint8-truncated; final-epoch weights;
the LoRA init of each attack ``JaxSide.init_lora(10 + i)``, written with the
JAX side's trained head as a PEFT directory that HF's PEFT and the port
read; then the accuracy of the four merged variants on the clean and the two
adversarial test sets, every cell held to ``--tol`` between every two sides.

It takes the JAX tool's flags with their defaults, plus ``--device`` for the
port's side (the card by default; ``--device cpu`` on a host without one).
``--full`` runs at the production ViT-B/224 geometry (``FULL_HF_CFG``): the
tool's sides read its module globals ``HF_CFG`` and ``IMG``, so they are set
for the run and restored afterwards, also when the run raises.

The artifact (``--out``, default ``PARITY_E2E_torch.json``) has the tool's
keys with a ``port`` value in every matrix cell, ``abs_diff`` the largest
gap between two sides, and besides: each side's per-step base losses, the
port's largest loss gap to the JAX side, the adversarial test sets' uint8
mismatch fractions (port and HF each against JAX), seconds per stage per
side, and the host CPU's model and torch's thread count. Exits 1 when a cell
differs by more than ``--tol``.

Run from the repository root, on the CPU:
``python3 parity_e2e_torch.py --device cpu`` (the tiny geometry), or
``python3 parity_e2e_torch.py --full --device cpu --n_train 4 --n_val 1
--n_test 4 --batch 16 --epochs 2 --lora_epochs 2 --out
PARITY_E2E_FULL_torch.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import platform
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import parity_e2e as tpar  # noqa: E402
from tools import parity_e2e as jpar  # noqa: E402

SIDES = ("torch", "jax", "port")
# PEFT looks an adapter's base model up on the hub unless offline; transformers skips TensorFlow
ENV = {"HF_HUB_OFFLINE": "1", "USE_TF": "0"}
COUNTS = ("n_train", "n_val", "n_test", "epochs", "lora_epochs", "batch", "pgd_steps")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="PARITY_E2E_torch.json")
    ap.add_argument("--tol", type=float, default=0.005)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--lora_epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n_train", type=int, default=32)
    ap.add_argument("--n_val", type=int, default=8)
    ap.add_argument("--n_test", type=int, default=36)
    ap.add_argument("--eps", type=float, default=8 / 255)
    ap.add_argument("--alpha", type=float, default=3 / 255)
    ap.add_argument("--pgd_steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--wd", type=float, default=1e-4)
    ap.add_argument("--full", action="store_true",
                    help="run at the production ViT-B/224 geometry (FULL_HF_CFG); keep the "
                         "counts small: every stage runs three times on the host CPU")
    ap.add_argument("--device", default="cuda",
                    help="the port side's device: the card by default, or cpu")
    return ap


def host() -> dict:
    """The host CPU's model name and the threads torch computes on."""
    import torch

    model = platform.processor()
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as f:
        model = next((line.split(":", 1)[1].strip() for line in f
                      if line.startswith("model name")), model)
    return {"cpu": model, "cpu_count": os.cpu_count(), "torch_threads": torch.get_num_threads()}


@contextlib.contextmanager
def geometry(hf_cfg: dict):
    """The JAX tool's module globals ``HF_CFG`` and ``IMG`` (read by its sides
    and its ``make_corpus``) and the hub environment, set for the run and
    restored after it, whether it returns or raises."""
    saved = jpar.HF_CFG, jpar.IMG, {k: os.environ.get(k) for k in ENV}
    jpar.HF_CFG, jpar.IMG = dict(hf_cfg), hf_cfg["image_size"]
    os.environ.update(ENV)
    try:
        yield
    finally:
        jpar.HF_CFG, jpar.IMG, env = saved
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _timed(seconds: dict, side: str, stage: str, fn):
    """``fn()``, its wall seconds kept as ``seconds[side][stage]`` and printed."""
    t = time.perf_counter()
    out = fn()
    seconds[side][stage] = time.perf_counter() - t
    print(f"{side} {stage}: {seconds[side][stage]:.1f} s", flush=True)
    return out


def _torch_side(ts, corpus, lora_orders, adv, init_dirs, workdir, args, seconds):
    """HF + PEFT's stages 3-4 (the tool's): the LoRA defense from each init
    directory, saved by PEFT, then the merged variants' matrix."""

    def train_loras():
        dirs = {}
        for kind in tpar.ATTACKS:
            pm = ts.train_lora(init_dirs[kind], (adv[kind]["train"], corpus["train"][1]),
                               lora_orders, args.lr)
            out = os.path.join(workdir, f"torch_{kind}")
            pm.save_pretrained(out)
            dirs[kind] = out if os.path.exists(os.path.join(out, "adapter_config.json")) \
                else os.path.join(out, "default")
        return dirs

    dirs = _timed(seconds, "torch", "lora", train_loras)

    def variant(combo):
        if not combo:
            m = copy.deepcopy(ts.model)
            m.load_state_dict(ts.init_state_trained)
            return m
        return ts.merged([dirs[a] for a in combo])

    return _timed(seconds, "torch", "matrix", lambda: tpar.accuracy_matrix(
        ts.accuracy, variant, corpus["test"], {k: adv[k]["test"] for k in tpar.ATTACKS}))


def _jax_side(js, corpus, lora_orders, adv, inits, args, seconds):
    """The JAX package's stages 3-4 (the tool's): the LoRA defense from each
    init in memory, then the merged variants' matrix."""
    trained = _timed(seconds, "jax", "lora", lambda: {
        kind: js.train_lora(*inits[kind], (adv[kind]["train"], corpus["train"][1]),
                            lora_orders, args.lr)
        for kind in tpar.ATTACKS})
    lcfg = inits[tpar.ATTACKS[0]][1]

    def variant(combo):
        return js.variant_params(trained, lcfg, combo) if combo else js.params

    return _timed(seconds, "jax", "matrix", lambda: tpar.accuracy_matrix(
        js.accuracy, variant, corpus["test"], {k: adv[k]["test"] for k in tpar.ATTACKS}))


def experiment(args, workdir: str) -> dict:
    """The three sides at the geometry ``args`` selects; returns the artifact.
    Adapter directories go under ``workdir``."""
    hf_cfg = dict(jpar.FULL_HF_CFG if args.full else jpar.HF_CFG)
    with geometry(hf_cfg):
        return _experiment(args, hf_cfg, workdir)


def _experiment(args, hf_cfg: dict, workdir: str) -> dict:
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import peft_io as jpeft

    t0 = time.time()
    img = hf_cfg["image_size"]
    corpus = jpar.make_corpus(args.n_train, args.n_val, args.n_test)
    port_corpus = tpar.make_corpus(args.n_train, args.n_val, args.n_test, image_size=img)
    for split, (x, y) in corpus.items():
        px, py = port_corpus[split]
        if not (np.array_equal(x, px) and np.array_equal(y, py)):
            raise RuntimeError(f"the port's {split} corpus is not the tool's at {img} px")
    n_train = len(corpus["train"][1])
    orders = jpar.batch_orders(np.random.default_rng(99), n_train, args.batch, args.epochs)
    lora_orders = jpar.batch_orders(np.random.default_rng(100), n_train, args.batch,
                                    args.lora_epochs)

    ts = jpar.TorchSide(seed=0)
    js = jpar.JaxSide(ts.init_state)
    ps = tpar.PortSide(ts.init_state, hf_cfg=hf_cfg, device=args.device)
    seconds = {side: {} for side in SIDES}
    losses = {}

    # stage 1: the base fine-tune on HF and JAX (the port's runs in run_port_side)
    losses["torch"] = _timed(seconds, "torch", "base",
                             lambda: ts.train_base(corpus, orders, args.lr, args.wd))
    ts.init_state_trained = {k: v.detach().clone() for k, v in ts.model.state_dict().items()}
    losses["jax"] = _timed(seconds, "jax", "base",
                           lambda: js.train_base(corpus, orders, args.lr, args.wd))

    # the LoRA inits: JAX's factors with JAX's trained head, one PEFT directory an attack
    inits, init_dirs = {}, {}
    for i, kind in enumerate(tpar.ATTACKS):
        inits[kind] = js.init_lora(seed=10 + i)
        init_dirs[kind] = os.path.join(workdir, f"init_{kind}")
        jpeft.save_peft_adapter(*inits[kind], init_dirs[kind], head={
            "w": js.params["head"]["w"], "b": js.params["head"]["b"]})

    port = tpar.run_port_side(ps, port_corpus, orders, lora_orders,
                              lambda side, kind, i: init_dirs[kind], workdir, eps=args.eps,
                              alpha=args.alpha, pgd_steps=args.pgd_steps, lr=args.lr, wd=args.wd)
    losses["port"] = port["losses"]
    seconds["port"] = port["seconds"]
    print("port stages: " + ", ".join(f"{k} {v:.1f} s" for k, v in port["seconds"].items()),
          flush=True)

    # stage 2 on HF and JAX
    kw = dict(eps=args.eps, alpha=args.alpha, steps=args.pgd_steps)
    adv = {}
    for side, run in (("torch", ts.attack_split), ("jax", js.attack_split)):
        adv[side] = _timed(seconds, side, "attacks", lambda: {
            kind: {split: run(*corpus[split], kind=kind, **kw) for split in ("train", "test")}
            for kind in tpar.ATTACKS})
    adv["port"] = port["adv"]

    # stages 3-4 on HF and JAX
    matrices = {"port": port["matrix"]}
    matrices["torch"] = _torch_side(ts, corpus, lora_orders, adv["torch"], init_dirs, workdir,
                                    args, seconds)
    matrices["jax"] = _jax_side(js, corpus, lora_orders, adv["jax"], inits, args, seconds)
    return _artifact(args, hf_cfg, corpus, losses, adv, matrices, seconds, time.time() - t0)


def _artifact(args, hf_cfg, corpus, losses, adv, matrices, seconds, wall) -> dict:
    lj = np.asarray(losses["jax"])
    drift = float(np.max(np.abs(np.asarray(losses["torch"]) - lj)))
    port_drift = float(np.max(np.abs(np.asarray(losses["port"]) - lj)))
    print(f"base train: {len(lj)} steps, max |loss_torch - loss_jax| = {drift:.2e}, "
          f"max |loss_port - loss_jax| = {port_drift:.2e}", flush=True)
    mismatch = {kind: {f"{side}_vs_jax": float((adv[side][kind]["test"]
                                                != adv["jax"][kind]["test"]).mean())
                       for side in ("port", "torch")}
                for kind in tpar.ATTACKS}
    for kind, fracs in mismatch.items():
        print(f"{kind}: adv-test uint8 pixel mismatch fraction port/jax "
              f"{fracs['port_vs_jax']:.4f}, torch/jax {fracs['torch_vs_jax']:.4f}", flush=True)

    matrix, worst, worst_port = {}, 0.0, 0.0
    for vname in tpar.VARIANTS:
        matrix[vname] = {}
        for dname in matrices["port"][vname]:
            acc = {side: matrices[side][vname][dname] for side in SIDES}
            d = max(acc.values()) - min(acc.values())
            worst, worst_port = max(worst, d), max(worst_port, abs(acc["port"] - acc["jax"]))
            matrix[vname][dname] = {**{side: round(a, 4) for side, a in acc.items()},
                                    "abs_diff": round(d, 4)}
            print(f"{vname:10s} {dname:6s} " + " ".join(f"{s}={a:.4f}" for s, a in acc.items())
                  + f" |d|={d:.4f}", flush=True)

    defaults = parser().parse_args([])
    return {
        "protocol": {"classes": jpar.N_CLASSES, "image_size": hf_cfg["image_size"],
                     "geometry": "full_vit_b" if args.full else "tiny",
                     "hf_cfg": dict(hf_cfg),
                     "n_train": len(corpus["train"][1]), "n_test": len(corpus["test"][1]),
                     "epochs": args.epochs, "lora_epochs": args.lora_epochs,
                     "batch": args.batch, "eps": args.eps, "alpha": args.alpha,
                     "pgd_steps": args.pgd_steps, "pgd_random_start": False,
                     "lr": args.lr, "wd": args.wd, "lora_rank": 8,
                     "lora_targets": list(jpar.LORA_TARGETS), "tol": args.tol,
                     "port_device": str(args.device),
                     "cuts": {k: {"used": getattr(args, k), "tool_default": getattr(defaults, k)}
                              for k in COUNTS if getattr(args, k) != getattr(defaults, k)}},
        "train_loss_max_abs_diff": drift,
        "port_train_loss_max_abs_diff": port_drift,
        "train_losses": losses,
        "adv_test_uint8_mismatch": mismatch,
        "matrix": matrix,
        "max_abs_acc_diff": round(worst, 4),
        "max_port_vs_jax_acc_diff": round(worst_port, 4),
        "ok": worst <= args.tol,
        "stage_seconds": seconds,
        "host": host(),
        "seconds": round(wall, 1),
    }


def main(argv=None, *, workdir: str | None = None) -> int:
    """Parse ``argv``, run, write ``--out``; 0 when every cell is within
    ``--tol``. ``workdir``: where the adapter directories go (a temporary
    directory, removed afterwards, when None)."""
    import torch

    args = parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device found. The port's side runs "
                         f"on the card; pass --device cpu to run it on the CPU")
    with contextlib.ExitStack() as stack:
        if workdir is None:
            workdir = stack.enter_context(tempfile.TemporaryDirectory(prefix="parity3_"))
        artifact = experiment(args, workdir)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(f"\nmax |acc difference| over the three sides = {artifact['max_abs_acc_diff']:.4f} "
          f"({'PASS' if artifact['ok'] else 'FAIL'} at tol {args.tol}); port vs jax "
          f"{artifact['max_port_vs_jax_acc_diff']:.4f} -> {args.out}")
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
