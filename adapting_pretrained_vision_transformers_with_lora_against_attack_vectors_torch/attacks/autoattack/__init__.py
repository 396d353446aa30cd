"""AutoAttack 'standard' suite: APGD-CE -> APGD-T -> FAB-T -> Square.

Counterpart of the JAX package's ``attacks/autoattack/__init__.py``: the
reference's ``AutoAttack(..., norm='Linf', eps=0.031, version='standard')``
as four stages (:mod:`.apgd`, :mod:`.fab`, :mod:`.square`) run in turn, each
on the examples still classified correctly after the stages before it
(first-success merge: an example keeps the first adversarial found for it).

Between stages the survivors are compacted to their exact count. The JAX
runner pads them to a power-of-two bucket because each shape is a new XLA
program; eager PyTorch and the port's kernels take any batch. Each row's
attack is independent of the other rows (losses are summed per example; the
backbones have no batch statistics), so compaction changes no result.
``run.stats`` keeps the JAX package's shape, keyed by (stage, bucket), where
the bucket is the survivor count. The host reads the misclassification mask
once per stage.

On a model built under a mesh (``parallel.mesh``) each rank runs the suite
on its rows, and the compaction stays per rank: it holds no collective. No
rank waits on a collective another skipped: the stages' only collectives
are the tensor-parallel all-reduces of the model group, whose ranks hold
the same rows, compute the same logits and so keep the same survivors and
call the same stages with the same batch; different model groups share no
collective inside the suite. Each stage draws over its own survivors.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from ..common import IMAGENET, Normalizer, frozen, to_unit_floats
from .apgd import APGDConfig, make_apgd, make_apgd_targeted
from .fab import FABConfig, make_fab_targeted
from .square import SquareConfig, make_square

__all__ = [
    "APGDConfig", "FABConfig", "SquareConfig", "AutoAttackConfig",
    "make_apgd", "make_apgd_targeted", "make_fab_targeted", "make_square",
    "make_autoattack", "robust_accuracy",
]


@dataclasses.dataclass(frozen=True)
class AutoAttackConfig:
    """Standard-version hyperparameters (upstream defaults; reference eps=0.031)."""

    eps: float = 0.031
    n_iter: int = 100
    n_target_classes: int = 9
    square_queries: int = 5000
    attacks: tuple[str, ...] = ("apgd-ce", "apgd-t", "fab-t", "square")


def make_autoattack(
    entry_apply: Callable,
    model_cfg,
    cfg: AutoAttackConfig = AutoAttackConfig(),
    *,
    normalize: Normalizer = IMAGENET,
) -> Callable:
    """``run(params, images, labels, generator=None) -> x_adv``.

    Each stage replaces the pixels of the examples it breaks among those
    still correctly classified after the stages before it. The stages draw
    from ``generator`` in turn (default: seed 0 on the images' device).
    ``run.stats[(stage, survivors)]`` lists each call's wall seconds, ended
    by the host's read of the stage's result."""
    apply_fn = partial(entry_apply, model_cfg)

    stages: list[tuple[str, Callable]] = []
    for name in cfg.attacks:
        if name == "apgd-ce":
            a = make_apgd(entry_apply, model_cfg,
                          APGDConfig(eps=cfg.eps, n_iter=cfg.n_iter, loss="ce"),
                          normalize=normalize)
            stages.append((name, lambda p, x, y, g, _a=a: _a(p, x, y, g)[0]))
        elif name == "apgd-t":
            stages.append((name, make_apgd_targeted(
                entry_apply, model_cfg,
                APGDConfig(eps=cfg.eps, n_iter=cfg.n_iter,
                           n_target_classes=cfg.n_target_classes),
                normalize=normalize)))
        elif name == "fab-t":
            stages.append((name, make_fab_targeted(
                entry_apply, model_cfg,
                FABConfig(eps=cfg.eps, n_iter=cfg.n_iter,
                          n_target_classes=cfg.n_target_classes),
                normalize=normalize)))
        elif name == "square":
            stages.append((name, make_square(
                entry_apply, model_cfg,
                SquareConfig(eps=cfg.eps, n_queries=cfg.square_queries),
                normalize=normalize)))
        else:
            raise ValueError(f"unknown attack {name!r}")

    def misclassified(params, x, labels):
        return apply_fn(params, normalize(x)).argmax(-1) != labels

    def run(params, images, labels, generator: Optional[torch.Generator] = None):
        images = to_unit_floats(images)
        if generator is None:
            generator = torch.Generator(images.device).manual_seed(0)
        x_adv = images.clone()
        with frozen(params), torch.no_grad():
            broken = misclassified(params, images, labels).cpu().numpy()
            for name, attack in stages:
                remaining = np.nonzero(~broken)[0]
                if remaining.size == 0:
                    break
                idx = torch.from_numpy(remaining).to(images.device)
                y_sub = labels[idx]
                t0 = time.perf_counter()
                x_k = attack(params, images[idx], y_sub, generator)
                newly = misclassified(params, x_k, y_sub)
                newly_h = newly.cpu().numpy()  # the host read ends the stage's work
                run.stats.setdefault((name, int(remaining.size)), []).append(
                    time.perf_counter() - t0)
                x_adv[idx[newly]] = x_k[newly]
                broken[remaining[newly_h]] = True
        return x_adv

    # per (stage, survivors): wall seconds, one entry per call (the CLI
    # `autoattack` prints the first call and the mean of the others)
    run.stats = {}
    return run


def robust_accuracy(entry_apply, model_cfg, params, x_adv, labels, *,
                    normalize: Normalizer = IMAGENET) -> float:
    """The fraction of ``x_adv`` still classified as ``labels``."""
    with torch.no_grad():
        logits = entry_apply(model_cfg, params, normalize(to_unit_floats(x_adv)))
    return float((logits.argmax(-1) == labels).float().mean())
