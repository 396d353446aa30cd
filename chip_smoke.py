#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90a).

Drives the port's main paths once, with random weights from a seed, through
the hand-written kernels:

* ``google_vit`` ViT-B/16 with a rank-8 LoRA merged into q/k/v/o, in bf16,
  through FGSM and PGD-10 at batch 64: the packed-attention kernel
  (``csrc/attention_packed.cu``), forward and backward;
* ``swin`` Swin-B (all 24 blocks) with a rank-8 LoRA merged into qkv/proj,
  in bf16, through FGSM and PGD-10 at batch 64: the window-attention kernel
  (``csrc/window_attention.cu``), forward and backward;
* the eval-compose stage for ``swin`` from memory: two adapters with heads
  through the port's PEFT writer and reader, then the accuracy matrix over
  the clean batch and the FGSM/PGD batches, f32 params and bf16 compute.

Phases, one line each (or a few):

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: both kernels compiled with nvcc from the checkout's sources, in
   parallel; ptxas registers and spills of each;
3. kernels against their plain PyTorch versions on the card, forward and
   gradients, f32 and bf16: packed attention at (B, N, H, hd) =
   (2, 37, 3, 32), (64, 197, 12, 64) and (bf16) (2, 300, 2, 64); window
   attention at the four Swin-B stage shapes (B=64; the shift mask on
   stages 1-3, zeros on stage 4) and at a ragged (2, 4, 16, 2), with a
   relative-position bias at the scale of a pretrained Swin's (std 1-2,
   another per head), and the kernel's change from a zero bias held
   against the plain version's; every backward bitwise reproducible;
4. model, per backbone: merged bf16 state through the port's checkpoint
   writer/reader (byte-equal), then logits of the kernel path against the
   plain path in bf16 and f32 (Swin's bias tables drawn at std 1.5);
5. attack, per backbone: FGSM + PGD-10 from a uint8 batch; output range,
   eps-ball, loss increase, and the launch counts (reset just before the
   run, read just after) that prove the path ran the kernels; for Swin, no
   bias gradient was computed. Then eval-compose for ``swin`` (its launch
   counts read the same way): 4 variants x 3 datasets, base/clean accuracy
   equal to a direct argmax count, a merged variant's weights equal to
   base + sum s*A*B;
6. timing with CUDA events: PGD-10 images/s of each backbone, kernel vs
   plain times (window attention with a zero, the shift and a random 30%
   mask, whose masked scores slow the kernel), and the eval-compose
   matrix's wall time.

The line before the last is a JSON object describing every kernel (window
attention's ``ms`` at the Swin-B stage-3 shape with its shift mask, which
18 of the 24 blocks run); the last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the rest of the repository beside it, the script fails with a
non-zero exit.

Run: ``python3 chip_smoke.py`` from the repository root.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch"
JAX_SRC = "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu/kernels"

# packed attention (B, N, H, hd): the ViT-B/16 main-path shape, a ragged
# small case, and (bf16 only) a sequence past the tensor-core variant's N <= 256
MAIN = (64, 197, 12, 64)
SHAPES = {"float32": ((2, 37, 3, 32), MAIN),
          "bfloat16": ((2, 37, 3, 32), (2, 300, 2, 64), MAIN)}
# window attention (B, nW, n, heads, mask): the four Swin-B stages at B=64
# (window 7, hd 32) and a ragged window-4 case
WIN_SHAPES = ((64, 64, 49, 4, "shift"), (64, 16, 49, 8, "shift"), (64, 4, 49, 16, "shift"),
              (64, 1, 49, 32, "zeros"), (2, 4, 16, 2, "shift"))
WIN_TIMED = {"stage 1": WIN_SHAPES[0][:4], "stage 3": WIN_SHAPES[2][:4]}
WIN_MASKS = ("zeros", "shift", "random")
# std of the Swin-B bias tables in phase 4 (a pretrained Swin's are O(1-10))
SWIN_BIAS_STD = 1.5
# fwd (atol, rtol), grads (atol, rtol) per dtype, both kernels
TOL = {"float32": ((1e-4, 1e-3), (1e-4, 1e-3)),
       "bfloat16": ((3e-2, 3e-2), (5e-2, 5e-2))}
# logits, kernel path vs plain path
LOGIT_TOL = {"google_vit": {"float32": (1e-3, 1e-3), "bfloat16": (5e-2, 5e-2)},
             "swin": {"float32": (1e-3, 1e-3), "bfloat16": (5e-2, 5e-2)}}
BATCH, PGD_STEPS, EPS, ALPHA, CLASSES = 64, 10, 8 / 255, 3 / 255, 21


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


def turns(kernel, plain, iters: int = 20) -> tuple[float, float]:
    """(kernel ms, plain ms), each the best of two in plain-kernel-kernel-plain order."""
    times = {"plain": [], "kernel": []}
    for turn in ("plain", "kernel", "kernel", "plain"):
        times[turn].append(cuda_ms(kernel if turn == "kernel" else plain, iters))
    return min(times["kernel"]), min(times["plain"])


@contextlib.contextmanager
def plain_path(module, name: str, plain):
    """Route a model module's attention through the plain version."""
    saved = getattr(module, name)
    setattr(module, name, plain)
    try:
        yield
    finally:
        setattr(module, name, saved)


class Smoke:
    """The modules, the device and the card's label, shared by the phases."""

    def __init__(self, dev):
        import torch

        sys.path.insert(0, HERE)
        for attr, name in (("ka", "kernels.attention"), ("kw", "kernels.window_attention"),
                           ("build_mod", "kernels._build"), ("vit", "models.vit"),
                           ("swin", "models.swin"), ("registry", "models.registry"),
                           ("lora", "ops.lora"), ("peft_io", "ops.peft_io"),
                           ("trees", "utils.trees"), ("checkpoint", "utils.checkpoint"),
                           ("common", "attacks.common"), ("whitebox", "attacks.whitebox"),
                           ("loader", "data.loader"), ("compose_mod", "eval.compose")):
            setattr(self, attr, importlib.import_module(f"{PKG}.{name}"))
        check("jax" not in sys.modules, "the port imported jax")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dev = dev
        self.gen = torch.Generator(self.dev).manual_seed(0)
        self.card = ""

    # 1. device
    def device(self) -> None:
        import torch

        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()[0]
        self.card = f"[{smi}]"
        print(smi)
        print(f"phase 1 device: torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}",
              flush=True)

    # 2. build
    def build(self) -> None:
        sources = ("attention_packed.cu", "window_attention.cu")
        t0 = time.perf_counter()
        self.build_mod.load_all(sources)
        self.ka._lib()
        self.kw._lib()
        wall = time.perf_counter() - t0
        for src in sources:
            ptxas = self.build_mod.BUILD_LOG.get(src, "")
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
            spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", ptxas))
            print(f"phase 2 build: {src} -> {self.build_mod.build_dir()} "
                  f"(nvcc {self.build_mod.BUILD_SECONDS.get(src, 0.0):.2f} s; all sources in "
                  f"parallel {wall:.2f} s); ptxas: {len(regs)} kernels, registers "
                  f"{min(regs, default=0)}-{max(regs, default=0)}, spill stores {spills} bytes",
                  flush=True)

    # 3. kernels against plain, on the card
    def packed_vs_plain(self) -> dict:
        import torch

        ka, err = self.ka, {"fwd": 0.0, "bwd": 0.0}  # at the main-path shape and dtype
        for dtype_name, ((fa, fr), (ga, gr)) in TOL.items():
            dtype = getattr(torch, dtype_name)
            for (b, n, h, hd) in SHAPES[dtype_name]:
                q, k, v, do = (torch.randn(b, n, h * hd, device=self.dev, generator=self.gen)
                               .to(dtype) for _ in range(4))
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
                print(f"phase 3 attention_packed vs plain {tag}: fwd max|err| {e_f:.3e}, "
                      f"dq/dk/dv max|err| {e_b:.3e}, backward bitwise reproducible", flush=True)
        return err

    def window_operands(self, shape, mask_kind, dtype):
        """qkv, bias, mask, dO and heads; the bias's std runs from 1 to 2 over
        the heads (a constant offset per head would not change the softmax)."""
        import torch

        b, nw, n, h = shape
        c = 32 * h
        qkv = torch.randn(b, nw, n, 3 * c, device=self.dev, generator=self.gen).to(dtype)
        bias = (torch.randn(h, n, n, device=self.dev, generator=self.gen)
                * torch.linspace(1.0, 2.0, h, device=self.dev)[:, None, None])
        if mask_kind == "shift":
            window = round(n ** 0.5)
            mask = torch.from_numpy(self.swin._shift_attn_mask(
                window * round(nw ** 0.5), window, window // 2)).to(self.dev)
        elif mask_kind == "random":
            mask = torch.where(torch.rand(nw, n, n, device=self.dev, generator=self.gen) < 0.3,
                               -100.0, 0.0)
        else:
            mask = torch.zeros(nw, n, n, device=self.dev)
        do = torch.randn(b, nw, n, c, device=self.dev, generator=self.gen).to(dtype)
        return qkv, bias, mask, do, h

    def window_vs_plain(self) -> dict:
        import torch

        kw, err = self.kw, {"fwd": 0.0, "bwd": 0.0}  # bf16, max over the Swin-B stages
        for dtype_name, ((fa, fr), (ga, gr)) in TOL.items():
            dtype = getattr(torch, dtype_name)
            for *shape, mask_kind in WIN_SHAPES:
                qkv, bias, mask, do, h = self.window_operands(shape, mask_kind, dtype)
                tag = f"{dtype_name} {tuple(shape)} {mask_kind} mask"
                got_f = kw.fused_window_attention_fwd(qkv, bias, mask, h)
                want_f = kw.window_attention_reference(qkv, bias, mask, h)
                e_f = close(got_f, want_f, fa, fr, f"window fwd {tag}")
                got = kw.fused_window_attention_bwd(qkv, bias, mask, do, h)
                want = kw.window_attention_bwd_reference(qkv, bias, mask, do, h)
                e_b = close(got, want, ga, gr, f"window dqkv {tag}")
                check(torch.equal(got, kw.fused_window_attention_bwd(qkv, bias, mask, do, h)),
                      f"window backward not reproducible {tag}")
                # what the bias contributes: the kernel's change from a zero
                # bias against the plain version's (a kernel that drops the
                # bias, or reads another head's, fails here)
                zero = torch.zeros_like(bias)
                moved = {}
                for what, k_out, p_out, k_zero, p_zero, (a, r) in (
                        ("fwd", got_f, want_f, kw.fused_window_attention_fwd(qkv, zero, mask, h),
                         kw.window_attention_reference(qkv, zero, mask, h), (fa, fr)),
                        ("dqkv", got, want,
                         kw.fused_window_attention_bwd(qkv, zero, mask, do, h),
                         kw.window_attention_bwd_reference(qkv, zero, mask, do, h), (ga, gr))):
                    d_plain = p_out.float() - p_zero.float()
                    moved[what] = float(d_plain.abs().max())
                    check(moved[what] > 20 * a, f"window {what} {tag}: the bias moved the plain "
                          f"output by only {moved[what]:.3e}")
                    close(k_out.float() - k_zero.float(), d_plain, 2 * a, r,
                          f"window {what} bias contribution {tag}")
                torch.cuda.synchronize()
                if dtype == torch.bfloat16 and shape[0] == BATCH:
                    err = {"fwd": max(err["fwd"], e_f), "bwd": max(err["bwd"], e_b)}
                print(f"phase 3 window_attention vs plain {tag}: fwd max|err| {e_f:.3e}, "
                      f"dqkv max|err| {e_b:.3e}; bias contribution (max {moved['fwd']:.3e} fwd, "
                      f"{moved['dqkv']:.3e} dqkv) matches; backward bitwise reproducible",
                      flush=True)
        return err

    # 4. model
    def model(self, name: str, module, attn_name: str, plain):
        """Merged rank-8 LoRA, bf16, checkpoint round trip, kernel vs plain logits."""
        import numpy as np
        import torch

        lora, trees, ckpt = self.lora, self.trees, self.checkpoint
        entry = self.registry.get_model(name)
        cfg = entry.config(CLASSES)
        g_cpu = torch.Generator().manual_seed(0)
        tree = trees.flatten_with_paths(entry.init(cfg, g_cpu))
        for p in tree:
            if p.endswith("bias_table"):
                tree[p] = torch.randn(tree[p].shape, generator=g_cpu) * SWIN_BIAS_STD
        tree = trees.unflatten_from_paths(tree)
        lcfg = lora.LoRAConfig(rank=8, alpha=16.0, targets=entry.lora_targets(cfg))
        adapter = lora.init(g_cpu, tree, lcfg)
        for fac in adapter.values():
            fac["b"] = torch.randn(fac["b"].shape, generator=g_cpu) * 0.02
        merged = lora.merge(tree, adapter, lcfg)
        target = lcfg.targets[0]
        check(not torch.equal(trees.get_path(merged, target)["w"],
                              trees.get_path(tree, target)["w"]),
              f"{name}: the LoRA merge left the weights unchanged")
        bf16_tree = trees.map_leaves(lambda t: t.to(torch.bfloat16), merged)
        path = os.path.join(self.build_mod.build_dir(), f"chip_smoke_{name}_bf16.safetensors")
        ckpt.save_pytree(bf16_tree, path, meta={"model": name, "lora_rank": 8})
        loaded, meta = ckpt.load_pytree(path)
        os.unlink(path)
        flat_a, flat_b = trees.flatten_with_paths(bf16_tree), trees.flatten_with_paths(loaded)
        check(set(flat_a) == set(flat_b) and meta == {"model": name, "lora_rank": 8},
              f"{name}: checkpoint paths or metadata changed")
        check(all(flat_b[p].dtype == torch.bfloat16 and torch.equal(
            flat_a[p].view(torch.int16), flat_b[p].view(torch.int16)) for p in flat_a),
            f"{name}: checkpoint round trip is not byte-equal")
        model = entry.from_tree(trees.map_leaves(lambda t: t.to(self.dev), loaded), cfg)
        size = cfg.image_size
        x8 = torch.from_numpy(np.random.default_rng(0).random((8, size, size, 3),
                                                               dtype=np.float32)).to(self.dev)
        normalize = self.common.Normalizer(*self.registry.get_normalization(name))
        logit_err = {}
        for dtype_name, (la, lr) in LOGIT_TOL[name].items():
            mcfg = (cfg if dtype_name == "bfloat16"
                    else dataclasses.replace(cfg, compute_dtype="float32"))
            m = model if dtype_name == "bfloat16" else entry.from_tree(
                trees.map_leaves(lambda t: t.to(self.dev), merged), mcfg)
            with torch.no_grad():
                got = entry.apply(mcfg, m, normalize(x8))
                with plain_path(module, attn_name, plain):
                    want = entry.apply(mcfg, m, normalize(x8))
            check(got.shape == (8, CLASSES), f"{name}: logits shape {tuple(got.shape)}")
            logit_err[dtype_name] = close(got, want, la, lr, f"{name} logits {dtype_name}")
            del m
        blocks = sum(getattr(cfg, "depths", ())) or getattr(cfg, "depth", 0)
        print(f"phase 4 model: {name} {blocks} blocks, rank-8 LoRA merged, bf16 checkpoint "
              f"round trip byte-equal ({len(flat_a)} tensors), logits kernel vs plain "
              f"max|err| bf16 {logit_err['bfloat16']:.3e} f32 {logit_err['float32']:.3e}",
              flush=True)
        return entry, cfg, model, tree, normalize

    # 5. attack
    def attack(self, name: str, entry, cfg, model, normalize, counters, min_launches):
        """FGSM + PGD-10 with the kernels' counts reset just before and read just after."""
        import numpy as np
        import torch

        common, whitebox = self.common, self.whitebox
        rng = np.random.default_rng(1)
        size = cfg.image_size
        images_u8 = torch.from_numpy(
            rng.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8)).to(self.dev)
        labels = torch.from_numpy(rng.integers(0, CLASSES, BATCH)).to(self.dev)
        fgsm = whitebox.make_fgsm(entry.apply, cfg, eps=EPS, normalize=normalize)
        pgd = whitebox.make_pgd(entry.apply, cfg, eps=EPS, alpha=ALPHA, steps=PGD_STEPS,
                                normalize=normalize)
        torch.cuda.synchronize()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        adv_f = fgsm(model, images_u8, labels)
        adv_p = pgd(model, images_u8, labels, torch.Generator(self.dev).manual_seed(1))
        torch.cuda.synchronize()
        launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        for k, least in min_launches.items():
            check(launches[k] >= least, f"{name}: {k} launches {launches} (want >= {least})")
        clean = common.to_unit_floats(images_u8)
        for what, adv in (("fgsm", adv_f), ("pgd", adv_p)):
            check(adv.shape == clean.shape and adv.dtype == torch.float32,
                  f"{name} {what} shape/dtype")
            check(bool(torch.isfinite(adv).all()), f"{name} {what} non-finite")
            check(float(adv.min()) >= 0.0 and float(adv.max()) <= 1.0,
                  f"{name} {what} outside [0,1]")
            check(float((adv - clean).abs().max()) <= EPS + 1e-6,
                  f"{name} {what} outside the eps-ball")
            q8 = common.uint8_quantize(adv)
            check(q8.shape == tuple(images_u8.shape) and q8.dtype == np.uint8,
                  f"{name} {what} uint8")
        with torch.no_grad():
            ce_clean = float(common.sum_cross_entropy(
                entry.apply(cfg, model, normalize(clean)), labels))
            ce_pgd = float(common.sum_cross_entropy(
                entry.apply(cfg, model, normalize(adv_p)), labels))
        check(ce_pgd > ce_clean, f"{name}: PGD did not raise the loss ({ce_clean} -> {ce_pgd})")
        print(f"phase 5 attack: {name} FGSM + PGD-{PGD_STEPS} B={BATCH} bf16, summed CE clean "
              f"{ce_clean:.4f} -> PGD {ce_pgd:.4f}, kernel launches {launches}", flush=True)
        return launches, pgd, images_u8, labels, adv_f, adv_p

    def compose(self, entry, cfg, base_tree, images_u8, labels, adv_f, adv_p):
        """eval-compose from memory for ``swin``; returns the matrix's wall seconds."""
        import numpy as np
        import torch

        lora, trees, peft_io, kw = self.lora, self.trees, self.peft_io, self.kw
        g_cpu = torch.Generator().manual_seed(3)
        lcfg = lora.LoRAConfig(rank=8, alpha=16.0, targets=entry.lora_targets(cfg))
        last = base_tree["head"]["w"].shape[0]
        adapters = {}
        for attack in ("fgsm", "pgd"):
            ad = lora.init(g_cpu, base_tree, lcfg)
            for fac in ad.values():
                fac["b"] = torch.randn(fac["b"].shape, generator=g_cpu) * 0.02
            head = {"w": torch.randn(last, CLASSES, generator=g_cpu) * last ** -0.5,
                    "b": torch.randn(CLASSES, generator=g_cpu) * 0.1}
            out_dir = os.path.join(self.build_mod.build_dir(), f"chip_smoke_{attack}_adapter")
            peft_io.save_peft_adapter(ad, lcfg, out_dir, head=head)
            got, got_cfg, got_head = peft_io.load_peft_adapter(out_dir)
            check(set(got) == set(ad) and got_cfg.rank == 8 and got_cfg.alpha == 16.0,
                  f"{attack} adapter paths or config changed")
            check(all(torch.equal(got[p][k], ad[p][k]) for p in ad for k in ("a", "b"))
                  and all(torch.equal(got_head[k], head[k]) for k in head),
                  f"{attack} adapter round trip is not byte-equal")
            adapters[attack] = (got, got_cfg, got_head)
        Batch = self.loader.Batch

        def batches(images):
            return [Batch(images, labels.cpu().numpy().astype(np.int32),
                          np.ones(BATCH, np.float32), [])]

        loaders = {"clean": batches(images_u8.cpu().numpy()),
                   "fgsm": batches(self.common.uint8_quantize(adv_f)),
                   "pgd": batches(self.common.uint8_quantize(adv_p))}
        normalize = self.common.Normalizer(*self.registry.get_normalization("swin"))
        torch.cuda.synchronize()
        kw.FWD_LAUNCHES = kw.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        results = self.compose_mod.run_composability_eval(
            entry, base_tree, adapters, loaders, CLASSES, cfg=cfg, normalize=normalize,
            device=self.dev, log=lambda s: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fwd": kw.FWD_LAUNCHES, "bwd": kw.BWD_LAUNCHES}
        want_variants = ["base", "lora_fgsm", "lora_pgd", "fgsm+pgd"]
        check(list(results) == want_variants
              and all(list(r) == ["clean", "fgsm", "pgd"] for r in results.values()),
              f"compose matrix {[(v, list(r)) for v, r in results.items()]}")
        check(launches["fwd"] >= sum(cfg.depths) * len(want_variants) * len(loaders)
              and launches["bwd"] == 0,
              f"compose window launches {launches}")
        base_d = trees.map_leaves(lambda t: t.to(self.dev), base_tree)
        base_model = entry.from_tree(base_d, cfg)
        with torch.no_grad():
            logits = entry.apply(cfg, base_model, normalize(self.common.to_unit_floats(images_u8)))
        direct = float((logits.argmax(-1) == labels).float().mean())
        check(results["base"]["clean"]["accuracy"] == direct,
              f"base/clean accuracy {results['base']['clean']['accuracy']} != {direct}")
        ads_d = {k: ({p: {f: t.to(self.dev) for f, t in fac.items()} for p, fac in a.items()},
                     c, {f: t.to(self.dev) for f, t in h.items()})
                 for k, (a, c, h) in adapters.items()}
        merged = self.compose_mod.build_variant_params(base_d, ("fgsm", "pgd"), ads_d)
        for path in lcfg.targets:
            want = trees.get_path(base_d, path)["w"] + sum(
                lcfg.scale * torch.matmul(ads_d[a][0][path]["a"], ads_d[a][0][path]["b"])
                for a in ("fgsm", "pgd"))
            close(trees.get_path(merged, path)["w"], want, 1e-6, 1e-5, f"merged {path}")
        check(merged["head"] is ads_d["pgd"][2], "the last merged head did not win")
        for line in self.compose_mod.format_summary_table(results).splitlines():
            print(f"phase 5 compose: {line}")
        print(f"phase 5 compose: swin 4 variants x 3 datasets (B={BATCH} each), f32 params "
              f"bf16 compute, base/clean accuracy {direct:.4f} = direct argmax count, merged "
              f"fgsm+pgd weights = base + sum s*A*B on {len(lcfg.targets)} targets, "
              f"window kernel launches {launches}, wall {wall:.3f} s", flush=True)
        return wall


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    s = Smoke(torch.device("cuda", 0))
    s.device()
    s.build()
    err_p = s.packed_vs_plain()
    err_w = s.window_vs_plain()

    ka, kw = s.ka, s.kw
    vit_entry, vit_cfg, vit_model, _, vit_norm = s.model(
        "google_vit", s.vit, "attention_packed", ka.attention_packed_reference)
    vit_l, vit_pgd, vit_x, vit_y, _, _ = s.attack(
        "google_vit", vit_entry, vit_cfg, vit_model, vit_norm,
        {"fwd": (ka, "FWD_LAUNCHES"), "bwd": (ka, "BWD_LAUNCHES")},
        {"fwd": vit_cfg.depth * (PGD_STEPS + 1), "bwd": vit_cfg.depth * PGD_STEPS})

    swin_entry, swin_cfg, swin_model, swin_tree, swin_norm = s.model(
        "swin", s.swin, "window_attention", kw.window_attention_reference)
    blocks = sum(swin_cfg.depths)
    swin_l, swin_pgd, swin_x, swin_y, adv_f, adv_p = s.attack(
        "swin", swin_entry, swin_cfg, swin_model, swin_norm,
        {"fwd": (kw, "FWD_LAUNCHES"), "bwd": (kw, "BWD_LAUNCHES"),
         "dbias": (kw, "DBIAS_CALLS")},
        {"fwd": blocks * (PGD_STEPS + 1), "bwd": blocks * PGD_STEPS})
    check(swin_l["dbias"] == 0, f"the attack path computed a bias gradient {swin_l}")
    compose_s = s.compose(swin_entry, swin_cfg, swin_tree, swin_x, swin_y, adv_f, adv_p)

    # 6. timing on the card
    for name, pgd, model, x, y in (("google_vit", vit_pgd, vit_model, vit_x, vit_y),
                                   ("swin", swin_pgd, swin_model, swin_x, swin_y)):
        pgd_ms = cuda_ms(lambda: pgd(model, x, y, torch.Generator(s.dev).manual_seed(2)), 5)
        print(f"phase 6 PGD-{PGD_STEPS} {name}+LoRA bf16 B={BATCH}: {pgd_ms:.2f} ms/batch, "
              f"{BATCH * 1000 / pgd_ms:.2f} images/s {s.card}", flush=True)
    b, n, h, hd = MAIN
    q, k, v, do = (torch.randn(b, n, h * hd, device=s.dev, generator=s.gen).to(torch.bfloat16)
                   for _ in range(4))
    kf, pf = turns(lambda: ka.fused_attention_packed_fwd(q, k, v, h),
                   lambda: ka.attention_packed_reference(q, k, v, h))
    kb, pb = turns(lambda: ka.fused_attention_packed_bwd(q, k, v, do, h),
                   lambda: ka.attention_packed_bwd_reference(q, k, v, do, h))
    print(f"phase 6 attention_packed {MAIN} bf16: kernel fwd {kf:.4f} ms bwd {kb:.4f} ms "
          f"fwd+bwd {kf + kb:.4f} ms; plain fwd {pf:.4f} ms bwd {pb:.4f} ms "
          f"fwd+bwd {pf + pb:.4f} ms {s.card}", flush=True)
    win_ms = {}
    for label, shape in WIN_TIMED.items():
        for mask_kind in WIN_MASKS:
            qkv, bias, mask, wdo, wh = s.window_operands(shape, mask_kind, torch.bfloat16)
            wkf, wpf = turns(lambda: kw.fused_window_attention_fwd(qkv, bias, mask, wh),
                             lambda: kw.window_attention_reference(qkv, bias, mask, wh))
            wkb, wpb = turns(lambda: kw.fused_window_attention_bwd(qkv, bias, mask, wdo, wh),
                             lambda: kw.window_attention_bwd_reference(qkv, bias, mask, wdo, wh))
            win_ms[label, mask_kind] = (wkf, wpf, wkb, wpb)
            print(f"phase 6 window_attention {label} {tuple(qkv.shape)} h{wh} {mask_kind} mask "
                  f"bf16: kernel fwd {wkf:.4f} ms bwd {wkb:.4f} ms; plain fwd {wpf:.4f} ms "
                  f"bwd {wpb:.4f} ms {s.card}", flush=True)
    print(f"phase 6 eval-compose swin 4x3 matrix (B={BATCH} per dataset): wall "
          f"{compose_s:.3f} s {s.card}", flush=True)

    src = f"{PKG}/csrc/attention_packed.cu"
    wsrc = f"{PKG}/csrc/window_attention.cu"
    wkf, wpf, wkb, wpb = win_ms["stage 3", "shift"]
    print(json.dumps({"kernels": [
        {"name": "attention_packed_fwd", "route": "cuda", "source": src,
         "replaces": f"{JAX_SRC}/attention.py:230", "launches": vit_l["fwd"],
         "max_abs_err": err_p["fwd"], "ms": kf, "plain_ms": pf},
        {"name": "attention_packed_bwd", "route": "cuda", "source": src,
         "replaces": f"{JAX_SRC}/attention.py:238", "launches": vit_l["bwd"],
         "max_abs_err": err_p["bwd"], "ms": kb, "plain_ms": pb},
        {"name": "window_attention_fwd", "route": "cuda", "source": wsrc,
         "replaces": f"{JAX_SRC}/window_attention.py:140", "launches": swin_l["fwd"],
         "max_abs_err": err_w["fwd"], "ms": wkf, "plain_ms": wpf},
        {"name": "window_attention_bwd", "route": "cuda", "source": wsrc,
         "replaces": f"{JAX_SRC}/window_attention.py:159", "launches": swin_l["bwd"],
         "max_abs_err": err_w["bwd"], "ms": wkb, "plain_ms": wpb},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
