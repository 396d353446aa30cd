"""The port's stages on one process and on a mesh, for holding a sharded run
against the single-process run at the same seed.

A *job* is a dict (written with ``torch.save``, read by every rank):
``model`` (a registry name), ``fields`` (config overrides, e.g. a cut depth
or ``use_fused_mlp``), ``num_classes``, ``tree`` (the full JAX-layout tree,
flat, CPU tensors), ``images`` / ``labels`` (the global batch, uint8 and
int64), ``stages`` (names of :data:`STAGES`) and, for the stages that write
files, ``workdir`` and ``data_root``. ``runs`` lists the meshes: each a dict
with ``spec`` (``(data, model)``) and any job keys it overrides.

:func:`run_stages` runs the stages on one process (``mesh=None``) or on a
mesh, every output whole: rows gathered over the data axis, trees over the
model axis. :func:`run_rank` is the rank function for
``launch.spawn(run_rank, n, device=..., args=(job_path, out_path))``: each
rank runs every run of ``runs`` in turn and rank 0 saves a list of
``{"outputs": ..., "counts": [every rank's launch counts per stage]}``.
The tests on the CPU and ``chip_smoke.py`` (phase 10, on the card) compare
the two.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch
import torch.distributed as dist

from ..attacks import patch as patch_mod
from ..attacks import whitebox
from ..attacks.autoattack import apgd, square
from ..attacks.common import IMAGENET, Normalizer
from ..data.augment import train_augment
from ..data.loader import Batch
from ..kernels import attention as kattention
from ..kernels import mlp as kmlp
from ..models.registry import get_model
from ..ops import lora
from ..train import loop, optim, steps
from ..utils import checkpoint, trees
from . import mesh as pmesh

EPS, ALPHA = 8 / 255, 3 / 255
IDENT = Normalizer((0.0,) * 3, (1.0,) * 3)
_JAX_PKG = "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu"
# the kernel launch counters a rank reports per stage: (module, attribute)
COUNTERS = {"attention_fwd": (kattention, "FWD_LAUNCHES"),
            "attention_bwd": (kattention, "BWD_LAUNCHES"),
            "fused_mlp_fwd": (kmlp, "MLP_FWD_LAUNCHES"),
            "fused_mlp_bwd": (kmlp, "MLP_BWD_LAUNCHES"),
            "ln_mlp_fwd": (kmlp, "FWD_LAUNCHES"), "ln_mlp_bwd": (kmlp, "BWD_LAUNCHES")}


def jitter_affine(flat, seed: int, scale: float = 0.1) -> dict:
    """``flat`` (a flat tree of tensors) with seeded normal noise of std
    ``scale`` added to every bias and LayerNorm leaf (``b``, ``bias``,
    ``scale``). A tree from ``init`` has zero biases and unit LayerNorm
    scales, under which a row-split bias added on every rank of a model
    group, or a column slice taken from the wrong rank, changes no number."""
    g = torch.Generator().manual_seed(seed)
    return {p: v + (scale * torch.randn(v.shape, generator=g)).to(v.dtype)
            if p.rsplit("/", 1)[-1] in ("b", "bias", "scale") else v
            for p, v in trees.flatten_with_paths(flat).items()}


class _Ctx:
    """One job on one device and mesh: the entry, its config and the batch."""

    def __init__(self, job: dict, device, mesh):
        self.job, self.device, self.mesh = job, torch.device(device), mesh
        self.entry = get_model(job["model"])
        self.cfg = dataclasses.replace(self.entry.config(job["num_classes"]),
                                       **job.get("fields", {}))
        self.x, self.y = (t.to(self.device) for t in pmesh.shard_batch(
            mesh, job["images"], job["labels"]))
        self.tag = "single" if mesh is None else "x".join(map(str, mesh.shape))

    def model(self, tree=None):
        tree = self.job["tree"] if tree is None else tree
        return self.entry.from_tree(
            trees.map_leaves(lambda t: t.to(self.device, copy=True), tree), self.cfg,
            mesh=self.mesh)

    def gen(self, seed: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(seed)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        return pmesh.gather_rows(self.mesh, t.contiguous()).cpu()

    def apply(self, model, x):
        return self.entry.apply(self.cfg, model, x)


def _forward(c: _Ctx) -> dict:
    with torch.no_grad():
        return {"logits": c.rows(c.apply(c.model(), IMAGENET(c.x.float() / 255.0)))}


def _train_step(c: _Ctx) -> dict:
    """One Adam step of the whole model; the gradients whole, and how far a
    whole leaf's gradient differs between the ranks of a model group."""
    model = c.model()
    state = steps.TrainState.create(model, None, lambda ps: optim.lora_adam(ps, 1e-3))
    # no normalization: the JAX package's sharded-step test feeds [0,1] floats
    step = steps.make_train_step(lambda m, x: c.apply(m, x), model, normalize=None)
    valid = torch.ones(c.x.shape[0], device=c.device)
    _, metrics = step(state, c.x, c.y, valid)
    grads = {n: p.grad.detach() for n, p in state.trainable.items()}
    spread = torch.zeros((), device=c.device)
    if pmesh.axis_size(c.mesh, pmesh.MODEL_AXIS) > 1:
        whole = torch.cat([g.reshape(-1) for n, g in grads.items() if n not in state.shard_dims])
        lead = whole.clone()
        dist.broadcast(lead, dist.get_global_rank(
            pmesh.axis_group(c.mesh, pmesh.MODEL_AXIS), 0),
            group=pmesh.axis_group(c.mesh, pmesh.MODEL_AXIS))
        spread = (whole - lead).abs().max()
        pmesh.all_reduce(spread, c.mesh, pmesh.MODEL_AXIS)
    grads = pmesh.gather_dims(c.mesh, grads, state.shard_dims)
    return {"loss": (metrics["loss_sum"] / metrics["count"]).cpu(),
            "grads": {n: g.cpu() for n, g in grads.items()},
            "params": c.entry.to_tree(model), "whole_grad_spread": spread.cpu()}


def _lora_step(c: _Ctx, dropout_mode: str = "input") -> dict:
    """One LoRA step through ``train.loop.fit`` (rank 8, dropout 0.1 on the
    adapter input, or with ``dropout_mode="post_a"`` on ``x @ lora_a``, head
    trainable, Adam) with the augmentation on; the trained adapter and the
    step's gradients, whole. (Adam's first step moves each leaf by about
    ``lr * sign(gradient)``, so the gradients show what the update hides.)"""
    base = lora.detach(trees.unflatten_from_paths(dict(c.job["tree"])))
    lcfg = lora.LoRAConfig(rank=8, alpha=16.0, targets=c.entry.lora_targets(c.cfg), dropout=0.1,
                           dropout_mode=dropout_mode)
    model, state, snapshot = loop.lora_trainer(c.entry, c.cfg, base, lcfg, lr=1e-3,
                                               train_head=True, seed=3, device=c.device,
                                               mesh=c.mesh)
    n = c.job["images"].shape[0]
    batch = Batch(c.job["images"].numpy(), c.job["labels"].numpy(),
                  torch.ones(n).numpy(), [f"{i}.png" for i in range(n)])
    res = loop.fit(lambda m, x: c.apply(m, x), model, state, [batch], None, epochs=1,
                   num_classes=c.cfg.num_classes, normalize=IMAGENET, snapshot=snapshot,
                   device=c.device, mesh=c.mesh, generator=c.gen(17), augment=train_augment,
                   log=lambda s: None)
    grads = pmesh.gather_dims(c.mesh, {n: p.grad.detach() for n, p in state.trainable.items()},
                              state.shard_dims)
    return {"loss": torch.tensor(res.history[0]["train_loss"]), "trained": res.best_params,
            "grads": {n: g.cpu() for n, g in grads.items()}}


def _pgd(c: _Ctx, steps_: int = 3, random_start: bool = True) -> dict:
    run = whitebox.make_pgd(c.entry.apply, c.cfg, eps=EPS, alpha=ALPHA, steps=steps_,
                            random_start=random_start)
    return {"adv": c.rows(run(c.model(), c.x, c.y, c.gen(9)))}


def _collectives(c: _Ctx) -> dict:
    """One small all-reduce and one all-gather over the world, on the
    device's tensors (gloo stages CUDA tensors through the host)."""
    n, r = dist.get_world_size(), dist.get_rank()
    t = torch.full((4,), float(r + 1), device=c.device)
    dist.all_reduce(t)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t)
    want = float(n * (n + 1) // 2)
    if not (bool((t == want).all()) and all(bool((p == want).all()) for p in parts)):
        raise RuntimeError(f"all_reduce/all_gather over {dist.get_backend()} gave {t.tolist()}")
    return {"all_reduce": t.cpu(), "backend": dist.get_backend()}


def _apgd(c: _Ctx) -> dict:
    run = apgd.make_apgd(c.entry.apply, c.cfg, apgd.APGDConfig(eps=EPS, n_iter=6),
                         normalize=IDENT)
    adv, f = run(c.model(), c.x, c.y, c.gen(9))
    return {"adv": c.rows(adv), "f": c.rows(f)}


def _square(c: _Ctx) -> dict:
    run = square.make_square(c.entry.apply, c.cfg,
                             square.SquareConfig(eps=EPS, n_queries=24, exit_check_every=8),
                             normalize=IDENT)
    return {"adv": c.rows(run(c.model(), c.x, c.y, c.gen(9)))}


def _patch(c: _Ctx) -> dict:
    pcfg = patch_mod.PatchConfig(patch_size=8, iters=5, batch_size=4, learning_rate=0.1,
                                 scale_min=0.4, scale_max=0.7)
    run = patch_mod.make_train_patch(c.entry.apply, c.cfg, pcfg, normalize=IDENT)
    p, losses = run(c.model(), c.x, c.y, c.gen(9))
    return {"patch": p.cpu(), "losses": losses.cpu()}


def _rp2(c: _Ctx) -> dict:
    """RP2 on two classes of the batch (each class pool whole on every rank)."""
    from ..attacks import rp2

    cfg = rp2.rp2_config(patch_size=8, image_size=c.cfg.image_size, iters=3, batch_size=4)
    labels = c.job["labels"].numpy() % 2
    patches = rp2.train_rp2_patches(c.entry.apply, c.cfg, c.model(),
                                    c.job["images"].numpy().astype("float32") / 255.0, labels,
                                    device=c.device, cfg=cfg, normalize=IDENT, seed=5,
                                    log=lambda s: None)
    return {str(k): torch.from_numpy(v) for k, v in patches.items()}


def _eval(c: _Ctx) -> dict:
    step = steps.make_eval_step(lambda m, x: c.apply(m, x), c.cfg.num_classes)
    loss_sum, conf = step(c.model(), c.x, c.y, torch.ones(c.x.shape[0], device=c.device))
    return {"loss_sum": loss_sum.cpu(), "confusion": conf.cpu()}


def _adapters(c: _Ctx) -> dict:
    """Two adapters with non-zero B factors, drawn from fixed seeds."""
    base = lora.detach(trees.unflatten_from_paths(dict(c.job["tree"])))
    lcfg = lora.LoRAConfig(rank=4, alpha=8.0, targets=c.entry.lora_targets(c.cfg))
    out = {}
    for name, seed in (("ad1", 11), ("ad2", 12)):
        ad = lora.init(torch.Generator().manual_seed(seed), base, lcfg)
        g = torch.Generator().manual_seed(seed + 100)
        out[name] = ({p: {"a": f["a"], "b": torch.randn(f["b"].shape, generator=g) * 0.05}
                      for p, f in ad.items()}, lcfg, None)
    return base, out


def _compose(c: _Ctx) -> dict:
    """The four-variant matrix over the clean batch and its PGD batch, in two
    batches each (a loader of ``Batch``es on the host, global rows)."""
    base, adapters = _adapters(c)
    adv = _pgd(c)["adv"]
    u8 = c.job["images"].numpy()
    labels = c.job["labels"].numpy()

    def batches(images):
        half = images.shape[0] // 2
        return [Batch(images[i:i + half], labels[i:i + half],
                      torch.ones(half).numpy(), [f"{j}.png" for j in range(i, i + half)])
                for i in (0, half)]

    from ..eval.compose import run_composability_eval

    res = run_composability_eval(
        c.entry, base, adapters, {"clean": batches(u8), "pgd": batches(
            (adv.numpy() * 255.0).astype("uint8"))}, c.cfg.num_classes, device=c.device,
        cfg=c.cfg, mesh=c.mesh, log=lambda s: None,
        out_path=os.path.join(c.job["workdir"], c.tag, "compose.json"))
    return {"results": res}


def _checkpoint(c: _Ctx) -> dict:
    """A train step, the state through a file and into another model (logits
    bit for bit); the file and a ``save_pytree`` of the trained tree stay in
    the workdir."""
    model = c.model()
    state = steps.TrainState.create(model, None, lambda ps: optim.lora_adam(ps, 1e-3))
    steps.make_train_step(lambda m, x: c.apply(m, x), model)(
        state, c.x, c.y, torch.ones(c.x.shape[0], device=c.device))
    out = os.path.join(c.job["workdir"], c.tag)
    if pmesh.is_main(c.mesh):
        os.makedirs(out, exist_ok=True)
    tree = c.entry.to_tree(model)
    checkpoint.save_train_state(state, os.path.join(out, "state"))
    if pmesh.is_main(c.mesh):
        checkpoint.save_pytree(tree, os.path.join(out, "params.safetensors"))
    if c.mesh is not None:
        dist.barrier()
    fresh = c.model(trees.map_leaves(lambda t: t + 1.0 if t.is_floating_point() else t,
                                     dict(c.job["tree"])))
    restored = steps.TrainState.create(fresh, None, lambda ps: optim.lora_adam(ps, 1e-3))
    checkpoint.load_train_state(os.path.join(out, "state"), restored)
    x = IMAGENET(c.x.float() / 255.0)
    with torch.no_grad():
        same = torch.equal(c.apply(fresh, x), c.apply(model, x))
    return {"bit_equal": torch.tensor(same), "params": tree}


def _files(c: _Ctx) -> dict:
    """The loops over a dataset on disk: ``train_base_model`` (fit, evaluate,
    checkpoints), ``train_lora_adapter`` (adapter directories) and
    ``generate_adversarial_split`` (PNGs and metadata), all under
    ``workdir/<mesh>/``."""
    from ..attacks.generate import generate_adversarial_split
    from ..data import io as data_io
    from ..data.loader import Loader, MetadataIndex
    from ..utils.vocab import LabelVocabulary

    root, out = c.job["data_root"], os.path.join(c.job["workdir"], c.tag)
    frames = {s: data_io.read_metadata(os.path.join(root, s, "metadata.csv"))
              for s in ("train", "val", "test")}
    vocab = LabelVocabulary.from_metadata_frames(list(frames.values()))
    size = c.cfg.image_size

    def loader(split):
        index = MetadataIndex(os.path.join(root, split, "metadata.csv"), vocab)
        return Loader(index, batch_size=8, image_size=size, resize=size)

    tree = dict(c.job["tree"])
    summary = loop.train_base_model(
        c.entry, tree, loader("train"), loader("val"), loader("test"), vocab,
        out_dir=os.path.join(out, "base"), device=c.device, epochs=1, augment=True, seed=1,
        mesh=c.mesh, cfg=c.cfg, log=lambda s: None)
    lcfg = lora.LoRAConfig(rank=4, alpha=8.0, targets=c.entry.lora_targets(c.cfg), dropout=0.1)
    base = lora.detach(trees.unflatten_from_paths(tree))
    lsum = loop.train_lora_adapter(
        c.entry, base, lcfg, loader("train"), loader("val"), vocab,
        out_dir=os.path.join(out, "lora"), device=c.device, epochs=1, seed=2, mesh=c.mesh,
        cfg=c.cfg, log=lambda s: None)
    run = whitebox.make_pgd(c.entry.apply, c.cfg, eps=EPS, alpha=ALPHA, steps=2)
    generate_adversarial_split(run, c.model(), loader("test"), out_dir=os.path.join(out, "adv"),
                               clean_metadata=frames["test"], device=c.device, seed=4,
                               mesh=c.mesh)
    return {"test_accuracy": torch.tensor(summary["test_accuracy"]),
            "lora_val_accuracy": torch.tensor(lsum["best_val_accuracy"])}


STAGES = {"forward": _forward, "train_step": _train_step, "lora_step": _lora_step,
          "lora_step_post_a": lambda c: _lora_step(c, "post_a"),
          "pgd": _pgd, "pgd_fixed": lambda c: _pgd(c, random_start=False),
          "pgd2": lambda c: _pgd(c, steps_=2), "pgd10": lambda c: _pgd(c, steps_=10),
          "collectives": _collectives, "apgd": _apgd, "square": _square,
          "patch": _patch, "rp2": _rp2, "eval": _eval, "compose": _compose, "checkpoint": _checkpoint,
          "files": _files}


def run_stages(job: dict, device, mesh=None, counts: dict = None) -> dict:
    """``{stage: outputs}`` of ``job``'s stages on ``device`` and ``mesh``;
    ``counts``, if given, gets each stage's kernel launches on this rank and
    its wall seconds (the device synchronized at the end)."""
    c = _Ctx(job, device, mesh)
    out = {}
    for name in job["stages"]:
        for mod, attr in COUNTERS.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        out[name] = STAGES[name](c)
        if c.device.type == "cuda":
            torch.cuda.synchronize(c.device)
        if counts is not None:
            counts[name] = {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}
            counts[name]["seconds"] = time.perf_counter() - t0
    return out


def run_rank(rank: int, dev, job_path: str, out_path: str) -> None:
    """Rank function: every run of ``job["runs"]`` on its mesh; rank 0 saves."""
    job = torch.load(job_path, weights_only=False)
    results = []
    for run in job["runs"]:
        mesh = pmesh.make_mesh(pmesh.MeshSpec(*run["spec"]), device=dev)
        counts = {}
        outputs = run_stages({**job, **run}, dev, mesh, counts)
        # what of jax, the JAX package or a test module this rank imported: nothing
        counts["foreign_modules"] = sorted(
            m for m in sys.modules if m == "jax" or m.startswith(("jax.", "test", _JAX_PKG)))
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, counts)
        results.append({"outputs": outputs, "counts": per_rank})
    if rank == 0:
        torch.save(results, out_path)
