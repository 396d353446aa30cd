"""Plain reference of the two training steps the benchmark times, float32.

* ``full``: every parameter trained; the augmentation (``augment.py``) on the
  [0, 1] images; AdamW (Loshchilov and Hutter) with decoupled weight decay.
* ``lora``: an unmerged rank-r adapter on the family's targets, trained
  with the classifier head; inverted dropout (rate p) on each adapter
  branch's input, a fresh mask a step; Adam (Kingma and Ba).

The loss is the mean cross-entropy of the ImageNet-normalized batch. What
the program derives from the seeds the benchmark hands it (the adapter's A
factors, the dropout masks, the augmentation draws) the reference draws
again by the rules frozen below, on the same device.

:func:`follow` runs steps from the seed's start, or from a state the
program reached (its trained tensors and Adam's moments after ``t0``
steps: the generators are then advanced by the draws of those ``t0``
steps), and returns what the benchmark compares: each step's loss, each
leaf's gradient at the first step and each leaf's change after the last,
a leaf being one layer of a stacked tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import augment as A
from . import common as C

BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
# the frozen seed rules of the program's training forms: the adapter's A
# factors come from one stream seeded with the seed; the dropout stream of
# target t (in target order) and stacked layer i is seeded seed * STRIDE +
# t * layers + i; the augmentation's stream is seeded seed * 1000 + 17
DROPOUT_SEED_STRIDE = 1_000_003


def augment_seed(seed: int) -> int:
    return seed * 1000 + 17


def steplr(base_lr: float, *, step_size_epochs: int, gamma: float, steps_per_epoch: int):
    """torch ``StepLR`` by epoch, as a function of the updates made before
    the one it gives the lr of."""
    return lambda count: base_lr * gamma ** ((count // steps_per_epoch) // step_size_epochs)


def lora_init(params: dict, paths, rank: int, seed: int) -> dict:
    """{path: A} of a fresh adapter: A ~ U(±1/sqrt(in)) (PEFT's bound), B = 0."""
    g = torch.Generator(params[paths[0] + "/w"].device).manual_seed(seed)
    out = {}
    for path in paths:
        w = params[path + "/w"]
        *lead, d_in, _ = w.shape
        a = torch.empty(*lead, d_in, rank, dtype=torch.float32, device=w.device)
        out[path] = a.uniform_(-(1.0 / d_in) ** 0.5, (1.0 / d_in) ** 0.5, generator=g)
    return out


class Dropout:
    """The adapters' dropout streams: one generator per (target, layer)."""

    def __init__(self, paths, layers: int, rate: float, seed: int, shape, device):
        self.rate, self.shape, self.device = rate, shape, device
        self.gens = {(path, i): torch.Generator(device).manual_seed(
            seed * DROPOUT_SEED_STRIDE + t * layers + i)
            for t, path in enumerate(paths) for i in range(layers)}

    def __call__(self, path: str, i: int) -> torch.Tensor:
        keep = 1.0 - self.rate
        mask = torch.rand(self.shape(path), generator=self.gens[(path, i)],
                          device=self.device) < keep
        return mask.float() / keep

    def skip(self, steps: int) -> None:
        """Advance every stream by the masks of ``steps`` steps."""
        for (path, _), g in self.gens.items():
            buf = torch.empty(self.shape(path), device=self.device)
            for _ in range(steps):
                torch.rand(self.shape(path), generator=g, out=buf)


def _leaf_norms(tensors: dict, stacked) -> dict:
    """{(path, layer): norm}: every layer of a leaf stacked on ``stacked(path)``
    leading axes (a layer an int for one axis, a tuple for more)."""
    out = {}
    for path, t in tensors.items():
        lead = t.shape[:stacked(path)]
        if not lead:
            out[(path, None)] = float(t.norm())
            continue
        for idx in torch.cartesian_prod(*(torch.arange(n) for n in lead)).reshape(-1, len(lead)):
            key = tuple(int(i) for i in idx)
            out[(path, key if len(key) > 1 else key[0])] = float(t[key].norm())
    return out


def follow(family, cfg, params: dict, batches, *, mode: str, lr, weight_decay: float,
           seed: int, rank: int = 8, alpha: float = 16.0, dropout: float = 0.0,
           lowp=None, start=None) -> dict:
    """``len(batches)`` steps over ``batches`` [(uint8 images, labels)] from
    ``params`` (float32, not changed): ``{"losses": [...], "grads":
    [{(path, layer): norm} a step], "grad1": the first of them, "change":
    {(path, layer): norm}}``. ``lr``: a number, or a function of the updates
    made before the one it gives the lr of. ``start``: None for the seed's
    start (a fresh adapter, Adam's moments nought), or the state the program
    reached, ``{"train": {path: tensor}, "m": ..., "v": ..., "t0": updates
    made}``, the trained tensors and Adam's moments in the reference's
    layout; the frozen tensors are still ``params``."""
    lr_at = lr if callable(lr) else (lambda count: lr)
    with C.exact_matmuls():
        params = {p: v.detach().float().clone() for p, v in params.items()}
        device = next(iter(params.values())).device
        n = batches[0][0].shape[0]
        t0 = 0 if start is None else start["t0"]
        if mode == "full":
            train = dict(params)
            gen = torch.Generator(device).manual_seed(augment_seed(seed))
            A.skip(gen, n, device, t0)
        elif mode == "lora":
            paths = family.lora_paths(cfg)
            train = {}
            if start is None:
                a0 = lora_init(params, paths, rank, seed)
                for path in paths:
                    w = params[path + "/w"]
                    train[path + "/lora_a"] = a0[path]
                    train[path + "/lora_b"] = torch.zeros(*w.shape[:-2], rank, w.shape[-1],
                                                          device=device)
                train.update({p: v for p, v in params.items() if p.startswith("head/")})
            layers = params[paths[0] + "/w"].shape[0]
            drop = Dropout(paths, layers, dropout, seed,
                           lambda path: family.mask_shape(cfg, path, n), device)
            if dropout > 0:
                drop.skip(t0)
        else:
            raise ValueError(f"mode {mode!r}: full or lora")
        if start is not None:
            train = {p: v.detach().float().clone() for p, v in start["train"].items()}
        m = {p: (torch.zeros_like(v) if start is None else start["m"][p].float().clone())
             for p, v in train.items()}
        v2 = {p: (torch.zeros_like(v) if start is None else start["v"][p].float().clone())
              for p, v in train.items()}
        begin = {p: v.clone() for p, v in train.items()}
        losses, grads_by_step = [], []
        for t, (u8, labels) in enumerate(batches, start=t0 + 1):
            x = C.unit_images(u8)
            if mode == "full":
                x = A.train_augment(x, gen)
            leaves = {p: v.requires_grad_(True) for p, v in train.items()}
            if mode == "full":
                logits = family.forward(leaves, cfg, C.normalize(x), lowp=lowp)
            else:
                lora = {path: (leaves[path + "/lora_a"], leaves[path + "/lora_b"], alpha / rank)
                        for path in paths}
                net = {**params, **{p: v for p, v in leaves.items() if p.startswith("head/")}}
                logits = family.forward(net, cfg, C.normalize(x), lowp=lowp, lora=lora,
                                        masks=drop if dropout > 0 else None)
            loss = F.cross_entropy(logits, labels.long())
            grads = torch.autograd.grad(loss, list(leaves.values()))
            losses.append(float(loss.detach()))
            step_lr = lr_at(t - 1)
            with torch.no_grad():
                grads_by_step.append(_leaf_norms(dict(zip(leaves, grads)), family.stacked))
                b1, b2 = BETAS
                for (p, w), g in zip(leaves.items(), grads):
                    w = w.detach()
                    if mode == "full" and weight_decay:
                        w.mul_(1.0 - step_lr * weight_decay)
                    m[p].mul_(b1).add_(g, alpha=1 - b1)
                    v2[p].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v2[p] / (1 - b2 ** t)).sqrt().add_(ADAM_EPS)
                    w.addcdiv_(m[p], denom, value=-step_lr / (1 - b1 ** t))
                    train[p] = w
        change = _leaf_norms({p: train[p] - begin[p] for p in train}, family.stacked)
    return {"losses": losses, "grad1": grads_by_step[0], "grads": grads_by_step, "change": change}


def median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2])


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: the gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's}.
    ``keep``: the leaves compared (all by default). Leaves that differ
    between the two sides read 1, as a state left unchanged does."""
    keys = [k for k in ref if keep is None or k in keep]
    if set(prog) != set(ref):
        return {k: 1.0 for k in keys}
    floor = median([ref[k] for k in keys]) if keys else 0.0
    out = {}
    for k in keys:
        den = max(ref[k], floor)
        out[k] = abs(prog[k] - ref[k]) / den if den > 0 else (0.0 if prog[k] == 0 else 1.0)
    return out


def leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, object]:
    """The worst leaf's gap (:func:`leaf_gaps`): ``(gap, leaf)``."""
    gaps = leaf_gaps(prog, ref, keep)
    at = max(gaps, key=gaps.get) if gaps else None
    return (gaps[at] if gaps else 0.0), at
