#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90a).

Drives the port's main path once: the ``google_vit`` ViT-B/16 (random
weights from a seed) with a rank-8 LoRA merged into q/k/v/o, in bf16,
through FGSM and PGD-10 at batch 64, with the hand-written packed-attention
kernel (``csrc/attention_packed.cu``) forward and backward. Phases, one line
each:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the kernel compiled with nvcc from the checkout's sources;
3. kernel against its plain PyTorch version on the card, forward and
   dQ/dK/dV, f32 and bf16, at (B, N, H, hd) = (2, 37, 3, 32) and
   (64, 197, 12, 64), and bf16 at (2, 300, 2, 64);
4. model: merged bf16 state through the port's checkpoint writer/reader
   (byte-equal), then logits of the kernel path against the plain path;
5. attack: FGSM + PGD-10 from a uint8 batch; output range, eps-ball, loss
   increase, and the launch counts that prove the path ran the kernels;
6. timing with CUDA events: PGD-10 images/s and kernel vs plain times.

The line before the last is a JSON object describing every kernel; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or without the rest
of the repository beside it, the script fails with a non-zero exit.

Run: ``python3 chip_smoke.py`` from the repository root.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch"

# (B, N, H, hd): the ViT-B/16 main-path shape, a ragged small case, and (bf16
# only) a sequence past the tensor-core variant's N <= 256
MAIN = (64, 197, 12, 64)
SHAPES = {"float32": ((2, 37, 3, 32), MAIN),
          "bfloat16": ((2, 37, 3, 32), (2, 300, 2, 64), MAIN)}
# fwd (atol, rtol), grads (atol, rtol) per dtype
TOL = {"float32": ((1e-4, 1e-3), (1e-4, 1e-3)),
       "bfloat16": ((3e-2, 3e-2), (5e-2, 5e-2))}
LOGIT_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (5e-2, 5e-2)}
BATCH, PGD_STEPS, EPS, ALPHA = 64, 10, 8 / 255, 3 / 255


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def close(got, want, atol: float, rtol: float, what: str) -> float:
    """Assert allclose; returns the max abs error."""
    import torch

    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite values")
    torch.testing.assert_close(g, w, atol=atol, rtol=rtol, msg=lambda m: f"{what}: {m}")
    return float((g - w).abs().max())


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over ``iters`` calls (after one warm-up)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def plain_attention(vit_mod, ka):
    """Route the model's attention through the plain version (for comparison)."""
    saved = vit_mod.attention_packed
    vit_mod.attention_packed = ka.attention_packed_reference
    try:
        yield
    finally:
        vit_mod.attention_packed = saved


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    sys.path.insert(0, HERE)
    import importlib

    ka = importlib.import_module(f"{PKG}.kernels.attention")
    kbuild = importlib.import_module(f"{PKG}.kernels._build")
    vit = importlib.import_module(f"{PKG}.models.vit")
    registry = importlib.import_module(f"{PKG}.models.registry")
    lora = importlib.import_module(f"{PKG}.ops.lora")
    trees = importlib.import_module(f"{PKG}.utils.trees")
    ckpt = importlib.import_module(f"{PKG}.utils.checkpoint")
    common = importlib.import_module(f"{PKG}.attacks.common")
    whitebox = importlib.import_module(f"{PKG}.attacks.whitebox")
    check("jax" not in sys.modules, "the port imported jax")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(smi)
    print(f"phase 1 device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    ka._lib()
    ptxas = kbuild.BUILD_LOG.get("attention_packed.cu", "")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", ptxas))
    print(f"phase 2 build: attention_packed.cu -> {kbuild.build_dir()} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {kbuild.BUILD_SECONDS}); ptxas: "
          f"{len(regs)} kernels, registers {min(regs, default=0)}-{max(regs, default=0)}, "
          f"spill stores {spills} bytes", flush=True)

    # 3. kernel against plain, on the card
    gen = torch.Generator(dev).manual_seed(0)
    err = {"fwd": 0.0, "bwd": 0.0}  # at the main-path shape and dtype
    for dtype_name, ((fa, fr), (ga, gr)) in TOL.items():
        dtype = getattr(torch, dtype_name)
        for (b, n, h, hd) in SHAPES[dtype_name]:
            q, k, v, do = (torch.randn(b, n, h * hd, device=dev, generator=gen).to(dtype)
                           for _ in range(4))
            tag = f"{dtype_name} {(b, n, h, hd)}"
            e_f = close(ka.fused_attention_packed_fwd(q, k, v, h),
                        ka.attention_packed_reference(q, k, v, h), fa, fr, f"fwd {tag}")
            got = ka.fused_attention_packed_bwd(q, k, v, do, h)
            want = ka.attention_packed_bwd_reference(q, k, v, do, h)
            e_b = max(close(g_, w_, ga, gr, f"d{nm} {tag}")
                      for nm, g_, w_ in zip("qkv", got, want))
            again = ka.fused_attention_packed_bwd(q, k, v, do, h)
            check(all(torch.equal(a_, b_) for a_, b_ in zip(got, again)),
                  f"backward not reproducible {tag}")
            torch.cuda.synchronize()
            if dtype == torch.bfloat16 and (b, n, h, hd) == MAIN:
                err = {"fwd": e_f, "bwd": e_b}
            print(f"phase 3 kernel vs plain {tag}: fwd max|err| {e_f:.3e}, "
                  f"dq/dk/dv max|err| {e_b:.3e}, backward bitwise reproducible", flush=True)

    # 4. model: google_vit + merged rank-8 LoRA, bf16, checkpoint round trip
    entry = registry.get_model("google_vit")
    cfg = entry.config(21)
    g_cpu = torch.Generator().manual_seed(0)
    tree = entry.init(cfg, g_cpu)
    lcfg = lora.LoRAConfig(rank=8, alpha=16.0, targets=entry.lora_targets(cfg))
    adapter = lora.init(g_cpu, tree, lcfg)
    for fac in adapter.values():
        fac["b"] = torch.randn(fac["b"].shape, generator=g_cpu) * 0.02
    merged = lora.merge(tree, adapter, lcfg)
    check(not torch.equal(merged["blocks"]["attn"]["q"]["w"], tree["blocks"]["attn"]["q"]["w"]),
          "the LoRA merge left the weights unchanged")
    bf16_tree = trees.map_leaves(lambda t: t.to(torch.bfloat16), merged)
    path = os.path.join(kbuild.build_dir(), "chip_smoke_merged_bf16.safetensors")
    ckpt.save_pytree(bf16_tree, path, meta={"model": "google_vit", "lora_rank": 8})
    loaded, meta = ckpt.load_pytree(path)
    os.unlink(path)
    flat_a, flat_b = trees.flatten_with_paths(bf16_tree), trees.flatten_with_paths(loaded)
    check(set(flat_a) == set(flat_b) and meta == {"model": "google_vit", "lora_rank": 8},
          "checkpoint paths or metadata changed")
    check(all(flat_b[p].dtype == torch.bfloat16 and torch.equal(
        flat_a[p].view(torch.int16), flat_b[p].view(torch.int16)) for p in flat_a),
        "checkpoint round trip is not byte-equal")
    model = entry.from_tree(loaded, cfg).to(dev)
    rng = np.random.default_rng(0)
    x8 = torch.from_numpy(rng.random((8, 224, 224, 3), dtype=np.float32)).to(dev)
    normalize = common.Normalizer(*registry.get_normalization("google_vit"))
    logit_err = {}
    for dtype_name, (la, lr) in LOGIT_TOL.items():
        m = model if dtype_name == "bfloat16" else entry.from_tree(
            merged, vit.ViTConfig(num_classes=21, compute_dtype="float32")).to(dev)
        mcfg = m.cfg
        with torch.no_grad():
            got = entry.apply(mcfg, m, normalize(x8))
            with plain_attention(vit, ka):
                want = entry.apply(mcfg, m, normalize(x8))
        check(got.shape == (8, 21), f"logits shape {tuple(got.shape)}")
        logit_err[dtype_name] = close(got, want, la, lr, f"logits {dtype_name}")
        del m
    print(f"phase 4 model: google_vit depth {cfg.depth} width {cfg.hidden_dim} rank-8 LoRA "
          f"merged, bf16 checkpoint round trip byte-equal ({len(flat_a)} tensors), logits "
          f"kernel vs plain max|err| bf16 {logit_err['bfloat16']:.3e} "
          f"f32 {logit_err['float32']:.3e}", flush=True)

    # 5. the attack stage, counted
    images_u8 = torch.from_numpy(
        rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 21, BATCH)).to(dev)
    fgsm = whitebox.make_fgsm(entry.apply, cfg, eps=EPS, normalize=normalize)
    pgd = whitebox.make_pgd(entry.apply, cfg, eps=EPS, alpha=ALPHA, steps=PGD_STEPS,
                            normalize=normalize)
    torch.cuda.synchronize()
    ka.FWD_LAUNCHES = ka.BWD_LAUNCHES = 0
    adv_f = fgsm(model, images_u8, labels)
    adv_p = pgd(model, images_u8, labels, torch.Generator(dev).manual_seed(1))
    torch.cuda.synchronize()
    launches = {"fwd": ka.FWD_LAUNCHES, "bwd": ka.BWD_LAUNCHES}
    depth = cfg.depth
    check(launches["fwd"] >= depth * (PGD_STEPS + 1), f"forward launches {launches}")
    check(launches["bwd"] >= depth * PGD_STEPS, f"backward launches {launches}")
    clean = common.to_unit_floats(images_u8)
    for name, adv in (("fgsm", adv_f), ("pgd", adv_p)):
        check(adv.shape == clean.shape and adv.dtype == torch.float32, f"{name} shape/dtype")
        check(bool(torch.isfinite(adv).all()), f"{name} non-finite")
        check(float(adv.min()) >= 0.0 and float(adv.max()) <= 1.0, f"{name} outside [0,1]")
        check(float((adv - clean).abs().max()) <= EPS + 1e-6, f"{name} outside the eps-ball")
        q8 = common.uint8_quantize(adv)
        check(q8.shape == tuple(images_u8.shape) and q8.dtype == np.uint8, f"{name} uint8")
    with torch.no_grad():
        ce_clean = float(common.sum_cross_entropy(entry.apply(cfg, model, normalize(clean)), labels))
        ce_pgd = float(common.sum_cross_entropy(entry.apply(cfg, model, normalize(adv_p)), labels))
    check(ce_pgd > ce_clean, f"PGD did not raise the loss ({ce_clean} -> {ce_pgd})")
    print(f"phase 5 attack: FGSM + PGD-{PGD_STEPS} B={BATCH} bf16, summed CE clean "
          f"{ce_clean:.4f} -> PGD {ce_pgd:.4f}, kernel launches {launches}", flush=True)

    # 6. timing on the card
    pgd_ms = cuda_ms(lambda: pgd(model, images_u8, labels,
                                 torch.Generator(dev).manual_seed(2)), 5)
    print(f"phase 6 PGD-{PGD_STEPS} google_vit+LoRA bf16 B={BATCH}: {pgd_ms:.2f} ms/batch, "
          f"{BATCH * 1000 / pgd_ms:.2f} images/s {card}", flush=True)
    b, n, h, hd = MAIN
    q, k, v, do = (torch.randn(b, n, h * hd, device=dev, generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    times = {}
    for turn in ("plain", "kernel", "kernel", "plain"):
        if turn == "kernel":
            f = cuda_ms(lambda: ka.fused_attention_packed_fwd(q, k, v, h), 20)
            bw = cuda_ms(lambda: ka.fused_attention_packed_bwd(q, k, v, do, h), 20)
        else:
            f = cuda_ms(lambda: ka.attention_packed_reference(q, k, v, h), 20)
            bw = cuda_ms(lambda: ka.attention_packed_bwd_reference(q, k, v, do, h), 20)
        times.setdefault(turn, []).append((f, bw))
    kf, kb = (min(t[i] for t in times["kernel"]) for i in (0, 1))
    pf, pb = (min(t[i] for t in times["plain"]) for i in (0, 1))
    print(f"phase 6 attention {MAIN} bf16: kernel fwd {kf:.4f} ms bwd {kb:.4f} ms "
          f"fwd+bwd {kf + kb:.4f} ms; plain fwd {pf:.4f} ms bwd {pb:.4f} ms "
          f"fwd+bwd {pf + pb:.4f} ms {card}", flush=True)

    src = f"{PKG}/csrc/attention_packed.cu"
    jax_src = "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu/kernels/attention.py"
    print(json.dumps({"kernels": [
        {"name": "attention_packed_fwd", "route": "cuda", "source": src,
         "replaces": f"{jax_src}:230", "launches": launches["fwd"],
         "max_abs_err": err["fwd"], "ms": kf, "plain_ms": pf},
        {"name": "attention_packed_bwd", "route": "cuda", "source": src,
         "replaces": f"{jax_src}:238", "launches": launches["bwd"],
         "max_abs_err": err["bwd"], "ms": kb, "plain_ms": pb},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
