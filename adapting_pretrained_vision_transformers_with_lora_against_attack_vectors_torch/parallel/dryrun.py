"""Entry points: a single-card forward check and the multi-rank dry run.

Counterpart of the repository's ``__graft_entry__.py`` for the JAX package:

* :func:`entry` returns ``(forward, (model, images))``: the flagship
  ViT-B/16 (21 classes) with a rank-8 LoRA adapter attached, on the card by
  default;
* :func:`dryrun_multichip` runs ``n`` ranks (:mod:`.launch`) over a mesh
  ``(n/2, 2)`` (``(n, 1)`` for odd ``n``) and takes one sharded step of each
  stage on a tiny ViT (image 32, patch 8, hidden 64, depth 2, 2 heads, MLP
  128, 10 classes, f32): a train step, PGD-2, APGD-CE-3, the EOT patch (2
  iterations), FAB-T, Square (4 queries), an eval step whose confusion
  matrix sums to the global batch, the four-variant eval-compose sweep
  (base, ad1, ad2, ad1+ad2) and a train-state checkpoint round trip whose
  logits are equal bit for bit. Any failure in any rank raises.

The JAX dry run re-executes itself on a virtual CPU mesh when devices are
short; here ``device`` is explicit instead: ``"cuda"`` with fewer cards than
``n`` shares the cards under gloo (the launcher's rule), and ``"cuda"``
without CUDA raises. ``python -m <package>.parallel.dryrun --n 4 --device
cpu|cuda`` runs it from the shell.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..attacks import patch as patch_mod
from ..attacks import whitebox
from ..attacks.autoattack import apgd, fab, square
from ..attacks.common import Normalizer
from ..models import vit
from ..ops import lora
from ..train import optim, steps
from ..utils import checkpoint, trees
from . import launch
from . import mesh as pmesh

DRYRUN_CFG = vit.ViTConfig(image_size=32, patch_size=8, hidden_dim=64, depth=2, num_heads=2,
                           mlp_dim=128, num_classes=10, compute_dtype="float32")


def _require(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for but CUDA is not available")
    return device


def _lora_tree(cfg, rank: int, alpha: float, seed: int = 0):
    params = vit.init(cfg, torch.Generator().manual_seed(seed))
    lcfg = lora.LoRAConfig(rank=rank, alpha=alpha, targets=vit.LORA_TARGETS_DEFAULT)
    adapter = lora.init(torch.Generator().manual_seed(seed + 1), params, lcfg)
    return lora.attach(params, adapter, lcfg), lcfg


def entry(device="cuda"):
    """``(forward, (model, images))``: the LoRA-adapted ViT-B/16 forward step."""
    device = _require(device)
    cfg = vit.VIT_B16.with_classes(21)
    params, _ = _lora_tree(cfg, 8, 16.0)
    model = vit.params_from_jax(trees.map_leaves(lambda t: t.to(device), params), cfg)

    def forward(model, images):
        return vit.apply(cfg, model, images)

    images = torch.zeros((8, cfg.image_size, cfg.image_size, 3), device=device)
    return forward, (model, images)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"dryrun rank {dist.get_rank()}: {what}")


def _rank(rank: int, dev: torch.device, n: int, workdir: str) -> None:
    model_par = 2 if n % 2 == 0 else 1
    m = pmesh.make_mesh(pmesh.MeshSpec(data=n // model_par, model=model_par), device=dev)
    cfg = DRYRUN_CFG
    params, lcfg = _lora_tree(cfg, 4, 8.0)
    model = vit.params_from_jax(trees.map_leaves(lambda t: t.to(dev), params), cfg, mesh=m)
    state = steps.TrainState.create(model, None, lambda ps: optim.adamw_steplr(
        ps, 1e-4, weight_decay=1e-4, step_size_epochs=20, gamma=0.1, steps_per_epoch=1))
    forward = lambda mdl, x: vit.apply(cfg, mdl, x)
    train_step = steps.make_train_step(forward, model)

    batch = 2 * n
    host = (np.random.default_rng(0).random((batch, 32, 32, 3), np.float32),
            np.arange(batch, dtype=np.int64) % cfg.num_classes, np.ones((batch,), np.float32))
    images, labels, valid = (torch.from_numpy(a).to(dev) for a in pmesh.shard_batch(m, *host))
    gen = lambda seed: torch.Generator(dev).manual_seed(seed)

    model.train()
    state, metrics = train_step(state, images, labels, valid)
    model.eval()
    _check(bool(torch.isfinite(metrics["loss_sum"])), "train step loss not finite")
    _check(float(metrics["count"]) == batch, "train step count is not the global batch")

    eps, ident = 8 / 255, Normalizer((0.0,) * 3, (1.0,) * 3)
    adv = whitebox.make_pgd(vit.apply, cfg, eps=eps, alpha=3 / 255, steps=2)(
        model, images, labels, gen(7))
    _check(bool(torch.isfinite(adv).all()), "PGD output not finite")
    _check(float((adv - images).abs().max()) <= eps + 1e-6, "PGD left the eps-ball")

    adv2, _ = apgd.make_apgd(vit.apply, cfg, apgd.APGDConfig(eps=eps, n_iter=3),
                             normalize=ident)(model, images, labels, gen(8))
    _check(bool(torch.isfinite(adv2).all()), "APGD-CE output not finite")
    pcfg = patch_mod.PatchConfig(patch_size=8, iters=2, batch_size=4, learning_rate=0.1,
                                 scale_min=0.4, scale_max=0.7)
    trained_patch, _ = patch_mod.make_train_patch(vit.apply, cfg, pcfg, normalize=ident)(
        model, images, labels, gen(9))
    _check(bool(torch.isfinite(trained_patch).all()), "patch not finite")
    adv3 = fab.make_fab_targeted(vit.apply, cfg, fab.FABConfig(eps=eps, n_iter=2,
                                                               n_target_classes=2),
                                 normalize=ident)(model, images, labels, gen(10))
    _check(bool(torch.isfinite(adv3).all()), "FAB-T output not finite")
    adv4 = square.make_square(vit.apply, cfg, square.SquareConfig(eps=eps, n_queries=4),
                              normalize=ident)(model, images, labels, gen(11))
    _check(bool(torch.isfinite(adv4).all()) and float((adv4 - images).abs().max()) <= eps + 1e-6,
           "Square output not finite or outside the eps-ball")

    eval_step = steps.make_eval_step(forward, cfg.num_classes)
    loss_sum, conf = eval_step(model, adv, labels, valid)
    _check(bool(torch.isfinite(loss_sum)), "eval loss not finite")
    _check(float(conf.sum()) == batch, f"confusion sums to {float(conf.sum())}, not {batch}")

    # the eval-compose sweep: base, two adapters and their merge, each merged
    # whole and built on the mesh
    base = lora.detach(trees.unflatten_from_paths(vit.params_to_jax(model)))
    ad1 = lora.init(torch.Generator().manual_seed(11), base, lcfg)
    ad2 = lora.init(torch.Generator().manual_seed(12), base, lcfg)
    ad1, ad2 = ({p: {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(s)) * 0.05
                     if k == "b" else v for k, v in fac.items()} for p, fac in ad.items()}
                for ad, s in ((ad1, 13), (ad2, 14)))
    variants = {"base": base, "ad1": lora.merge(base, ad1, lcfg),
                "ad2": lora.merge(base, ad2, lcfg),
                "ad1+ad2": lora.merge_many(base, [ad1, ad2], [lcfg, lcfg])}
    for name, tree in variants.items():
        vmodel = vit.params_from_jax(trees.map_leaves(lambda t: t.to(dev), tree), cfg, mesh=m)
        vloss, vconf = eval_step(vmodel, images, labels, valid)
        _check(bool(torch.isfinite(vloss)) and float(vconf.sum()) == batch, f"variant {name}")

    # the train state through a file and back into another model: logits bit for bit
    with torch.no_grad():
        live = vit.apply(cfg, model, images)
    prefix = os.path.join(workdir, "dryrun_state")
    checkpoint.save_train_state(state, prefix)
    dist.barrier()
    other, _ = _lora_tree(cfg, 4, 8.0, seed=5)
    fresh = vit.params_from_jax(trees.map_leaves(lambda t: t.to(dev), other), cfg, mesh=m)
    restored = steps.TrainState.create(fresh, None, lambda ps: optim.adamw_steplr(
        ps, 1e-4, weight_decay=1e-4, step_size_epochs=20, gamma=0.1, steps_per_epoch=1))
    checkpoint.load_train_state(prefix, restored)
    with torch.no_grad():
        _check(torch.equal(vit.apply(cfg, fresh, images), live),
               "restored logits differ from the live state's")
    dist.barrier()


def dryrun_multichip(n_devices: int, *, device="cuda") -> None:
    """One sharded step of every stage on ``n_devices`` ranks (module docstring)."""
    with tempfile.TemporaryDirectory() as workdir:
        launch.spawn(_rank, n_devices, device=device, args=(n_devices, workdir))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the port's multi-rank dry run")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)
    print(f"dryrun_multichip({args.n}, device={args.device!r}): passed")


if __name__ == "__main__":
    main()
