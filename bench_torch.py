"""North-star benchmark of the PyTorch port: PGD-10 adversarial-example
throughput on one CUDA card.

The port's counterpart of ``bench.py``, with its unit, flags and JSON line:
PGD-10 (eps 8/255, alpha 3/255, random start) against ViT-B/16 with a rank-8
LoRA merged into q/k/v/o, batch 64, the whole tree in bf16, through
``attacks.whitebox.make_pgd``, the function the ``attack`` CLI stage runs
(there is no separate fast path). Every attention runs the port's packed
attention kernel (``csrc/attention_packed.cu``).

Prints, before the JSON line, the card's name and power limit (nvidia-smi)
and the kernel launches the run saw (one warm-up call and BENCH_ITERS timed
calls: 12 x BENCH_STEPS packed-attention launches each way per call for
``merged``), then ONE JSON line: ``{"metric", "value", "unit",
"vs_baseline", "mfu_pct", "roofline_imgs_per_sec_per_chip"}``.

Timing (``bench.py``'s discipline): one warm-up call, which also builds the
kernels at first use (tens of seconds on a fresh machine) and stays outside
the window; then BENCH_ITERS chained calls, each attacking the previous
call's output with a random start from ``torch.Generator(card).manual_seed(i)``;
then one ``torch.cuda.synchronize()`` and a host fetch of the output's sum,
both inside the window. ``mfu_pct`` and the roofline come from the port's own
FLOP count (``<port>/tools/flops.py``: the config's 197 tokens, no padding;
0.717 TFLOP an image for PGD-10) over the H100 SXM's dense bf16 peak of
989.4 TFLOP/s. The program runs on one card, so per chip is per run.

Harness: each attempt runs in a fresh subprocess (a clean CUDA context), up
to BENCH_ATTEMPTS with BENCH_BACKOFF seconds between them and BENCH_TIMEOUT
seconds each. With no card, the child raises naming the cause; when every
attempt fails the parent prints a parseable line with ``"value": null`` and
``"error"``, and exits 0. It never measures on the CPU.

Tunables (``bench.py``'s, same defaults): BENCH_BATCH (64), BENCH_STEPS (10),
BENCH_ITERS (8), BENCH_VARIANT (merged), BENCH_FUSED_MLP (0: 1 sets
``use_fused_mlp``), BENCH_ATTEMPTS (3), BENCH_TIMEOUT (1800), BENCH_BACKOFF
(15). BENCH_VARIANT:

* ``merged``: the adapter merged into the weights (the reference's deployed
  form, eval_compose.py's merge_and_unload);
* ``attached``: the unmerged adapter through ``ops/nn.dense``'s LoRA branch
  (its rank-8 products count in the FLOP);
* ``int8``: ``ops/quant.quantize_dense_tree`` over ``vit.QUANT_TARGETS_DEFAULT``
  after the bf16 cast (W8A8; the same model FLOP as bf16; the fused kernels
  are bypassed for quantized denses);
* ``fusedblock``: ``fuse_attn_block`` (``csrc/attn_block.cu`` for the
  attention half, ``csrc/ln_mlp.cu``'s LN-fused MLP for the MLP half);
* ``lnmlp``: ``fuse_ln_mlp`` (the LN-fused MLP half only).

Run: ``python3 bench_torch.py`` from the repository root on a machine with a
CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch"
_CHILD_FLAG = "_APVT_BENCH_TORCH_CHILD"
VARIANTS = ("merged", "attached", "int8", "fusedblock", "lnmlp")
# BASELINE.md's estimate of the reference's eager float32 torchattacks PGD-10
# loop on an A100 (a roofline derivation, ~35-40% eager MFU of 156 TF TF32;
# the reference publishes no number): bench.py's baseline, kept as its yardstick
REFERENCE_IMGS_PER_SEC = 55.0
EPS, ALPHA, CLASSES, RANK = 8 / 255, 3 / 255, 21, 8
# a reading of this script on a card, default variant (PERF.md section 6);
# for triage in a failed run's line, never a value of that run
LAST_MEASURED = {"value": 320.98, "mfu_pct": 23.3, "vs_baseline": 5.836,
                 "device": "NVIDIA H100 80GB HBM3, 700.00 W", "see": "PERF.md"}


def metric_name(steps: int, variant: str) -> str:
    return f"pgd{steps}_adv_images_per_sec_per_chip_vitb_lora" + (
        "" if variant == "merged" else f"_{variant}")


def config(variant: str, *, fused_mlp: bool = False, base=None):
    """The ViT config of ``variant``: ``base`` (ViT-B/16, 21 classes, bf16
    compute) with ``bench.py``'s kernel fields."""
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit

    if variant not in VARIANTS:
        raise ValueError(f"BENCH_VARIANT {variant!r}: one of {VARIANTS}")
    base = base if base is not None else vit.VIT_B16.with_classes(CLASSES)
    return dataclasses.replace(base, use_fused_mlp=fused_mlp,
                               fuse_attn_block=variant == "fusedblock",
                               fuse_ln_mlp=variant == "lnmlp")


def inputs(cfg, batch: int, device, seed: int = 0) -> dict:
    """Seeded random base params and adapter (JAX layout, f32, on the CPU),
    images in [0, 1] and labels on ``device``."""
    import torch

    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora

    base = vit.init(cfg, torch.Generator().manual_seed(seed))
    adapter = lora.init(torch.Generator().manual_seed(seed + 1), base, _lora_cfg())
    size = cfg.image_size
    images = torch.rand((batch, size, size, 3), generator=torch.Generator(device).manual_seed(
        seed + 2), device=device)
    labels = torch.randint(0, cfg.num_classes, (batch,), device=device,
                           generator=torch.Generator(device).manual_seed(seed + 3))
    return {"base": base, "adapter": adapter, "images": images, "labels": labels}


def _lora_cfg():
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora

    return lora.LoRAConfig(rank=RANK, alpha=16.0, targets=vit.LORA_TARGETS_DEFAULT)


def build(variant: str, cfg, base, adapter, device):
    """``bench.py``'s model of ``variant`` on ``device``: the adapter merged
    (or attached), every float leaf cast to bf16, then (``int8``) the dense
    weights quantized."""
    import torch

    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora, quant
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees

    put = lambda tree: trees.map_leaves(lambda t: torch.as_tensor(t).to(device), tree)  # noqa: E731
    base_d = put(base)
    adapter_d = {path: put(fac) for path, fac in adapter.items()}  # keys are paths themselves
    lcfg = _lora_cfg()
    tree = (lora.attach(base_d, adapter_d, lcfg) if variant == "attached"
            else lora.merge(base_d, adapter_d, lcfg))
    tree = trees.cast_tree(tree, torch.bfloat16)
    if variant == "int8":
        tree = quant.quantize_dense_tree(tree, vit.QUANT_TARGETS_DEFAULT)
    return vit.params_from_jax(tree, cfg)


def attack(cfg, model, images, labels, *, steps: int, starts) -> "torch.Tensor":
    """The timed program: one PGD-``steps`` call per random start, each on
    the previous call's output. ``starts``: per call, a ``torch.Generator``
    (the bench's) or the start's noise tensor itself (a parity test's draws)."""
    import torch

    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import whitebox
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit

    run = whitebox.make_pgd(vit.apply, cfg, eps=EPS, alpha=ALPHA, steps=steps)
    x = images
    for start in starts:
        if isinstance(start, torch.Generator):
            x = run(model, x, labels, start)
        else:
            x = run(model, x, labels, noise=start)
    return x


# the kernel counters of the ViT path: {name: (module, attribute)}
COUNTERS = {"attention_packed_fwd": ("attention", "FWD_LAUNCHES"),
            "attention_packed_bwd": ("attention", "BWD_LAUNCHES"),
            "attn_block_fwd": ("attn_block", "FWD_LAUNCHES"),
            "attn_block_bwd": ("attn_block", "BWD_LAUNCHES"),
            "ln_mlp_fwd": ("mlp", "FWD_LAUNCHES"), "ln_mlp_bwd": ("mlp", "BWD_LAUNCHES"),
            "fused_mlp_fwd": ("mlp", "MLP_FWD_LAUNCHES"),
            "fused_mlp_bwd": ("mlp", "MLP_BWD_LAUNCHES")}


def _counter_modules() -> dict:
    import importlib

    return {name: importlib.import_module(f"{PKG}.kernels.{mod}")
            for name, (mod, _) in COUNTERS.items()}


def reset_launches() -> None:
    for name, mod in _counter_modules().items():
        setattr(mod, COUNTERS[name][1], 0)


def read_launches() -> dict:
    return {name: getattr(mod, COUNTERS[name][1]) for name, mod in _counter_modules().items()}


def measure(device, variant: str, *, batch: int, steps: int, iters: int,
            fused_mlp: bool = False) -> tuple[dict, dict]:
    """(the JSON record, the kernel launches of the warm-up and the timed
    calls) of one run on ``device``, a CUDA card."""
    import torch

    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import flops, timing

    if torch.device(device).type != "cuda":
        raise RuntimeError(f"bench_torch measures on a CUDA card, not on {device}")
    cfg = config(variant, fused_mlp=fused_mlp)
    data = inputs(cfg, batch, device)
    model = build(variant, cfg, data["base"], data["adapter"], device)
    images, labels = data["images"], data["labels"]
    gen = lambda i: torch.Generator(device).manual_seed(i)  # noqa: E731

    reset_launches()
    timing.fetch_sum(attack(cfg, model, images, labels, steps=steps, starts=[gen(99)]))
    t0 = time.perf_counter()
    x = attack(cfg, model, images, labels, steps=steps, starts=[gen(i) for i in range(iters)])
    timing.fetch_sum(x)
    dt = time.perf_counter() - t0
    launches = read_launches()

    ips = batch * iters / dt
    flop = flops.pgd(cfg, steps, rank=RANK if variant == "attached" else 0)
    return {
        "metric": metric_name(steps, variant),
        "value": round(ips, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(ips / REFERENCE_IMGS_PER_SEC, 3),
        "mfu_pct": round(flops.mfu_pct(ips, flop), 1),
        "roofline_imgs_per_sec_per_chip": round(flops.roofline_images_per_s(flop), 0),
    }, launches


def settings() -> dict:
    """The BENCH_* environment variables the child measures with (bench.py's defaults)."""
    return {"batch": int(os.environ.get("BENCH_BATCH", "64")),
            "steps": int(os.environ.get("BENCH_STEPS", "10")),
            "iters": int(os.environ.get("BENCH_ITERS", "8")),
            "variant": os.environ.get("BENCH_VARIANT", "merged"),
            "fused_mlp": os.environ.get("BENCH_FUSED_MLP", "0") == "1"}


def child() -> None:
    """One measurement attempt (a fresh process)."""
    import torch

    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.tools import timing

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is false; bench_torch.py "
                           "measures on the card only")
    env = settings()
    print(timing.card_line(), flush=True)
    record, launches = measure(torch.device("cuda", 0), env["variant"], batch=env["batch"],
                               steps=env["steps"], iters=env["iters"],
                               fused_mlp=env["fused_mlp"])
    print(f"kernel launches over {1 + env['iters']} PGD-{env['steps']} calls "
          f"(B={env['batch']}, {env['variant']}): {json.dumps(launches)}", flush=True)
    print(json.dumps(record), flush=True)


def _parse_json_line(text: str) -> dict | None:
    for line in reversed(text.strip().splitlines()):
        line = line.strip()
        if line.startswith("{") and line.endswith("}"):
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict) and "metric" in obj:
                return obj
    return None


def main() -> None:
    """Retry harness: a fresh subprocess per attempt, a JSON line no matter what."""
    attempts = int(os.environ.get("BENCH_ATTEMPTS", "3"))
    timeout = float(os.environ.get("BENCH_TIMEOUT", "1800"))
    backoff = float(os.environ.get("BENCH_BACKOFF", "15"))
    env = dict(os.environ, **{_CHILD_FLAG: "1"})
    errors: list[str] = []
    for n in range(1, attempts + 1):
        try:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__)], env=env, cwd=HERE,
                                  capture_output=True, text=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            errors.append(f"attempt {n}: timeout after {timeout:.0f}s")
        else:
            parsed = _parse_json_line(proc.stdout)
            if proc.returncode == 0 and parsed is not None and parsed.get("value"):
                for line in proc.stdout.strip().splitlines()[:-1]:
                    print(line)
                if errors:
                    parsed["recovered_after"] = errors
                print(json.dumps(parsed))
                return
            tail = (proc.stderr or proc.stdout or "").strip().splitlines()[-3:]
            errors.append(f"attempt {n}: rc={proc.returncode} " + " | ".join(tail))
        if n < attempts:
            time.sleep(backoff)

    cfg = settings()
    print(json.dumps({
        "metric": metric_name(cfg["steps"], cfg["variant"]),
        "value": None,
        "unit": "images/sec/chip",
        "vs_baseline": None,
        "error": f"all {attempts} attempts failed: " + " ;; ".join(errors),
        # the last reading on a card, default variant only: for
        # triage, not a value of this run
        "last_measured_builder": LAST_MEASURED if cfg["variant"] == "merged" else None,
        "attempts": attempts,
        "timeout_s": timeout,
    }))


if __name__ == "__main__":
    if os.environ.get(_CHILD_FLAG):
        child()
    else:
        main()
