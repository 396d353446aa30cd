"""Auto-PGD (APGD) — budget-aware PGD with momentum and adaptive step size.

Counterpart of the JAX package's ``attacks/autoattack/apgd.py``: the APGD
algorithm (Croce & Hein, "Reliable evaluation of adversarial robustness with
an ensemble of diverse parameter-free attacks", ICML 2020), the first two
attacks of the AutoAttack 'standard' suite:

* APGD-CE: untargeted, cross-entropy loss;
* APGD-T: targeted, targeted-DLR loss, one run per target class.

The checkpoint indices are static Python data precomputed from the iteration
budget, and every branch of the algorithm (halving the step, restarting from
the best point) is a batched ``torch.where`` over the examples: no host sync
inside an iteration. Losses are computed from f32 logits. The model's
parameters are frozen while an attack runs.

Algorithm recap (paper Alg. 1 + §3.1): gradient-ascent steps
``z = P(x_k + η·sign(∇f))`` with momentum
``x_{k+1} = P(x_k + α(z - x_k) + (1-α)(x_k - x_{k-1}))``, α=0.75; at
checkpoints ``w_j`` (fractions p_0=0, p_1=0.22,
p_{j+1} = p_j + max(p_j - p_{j-1} - 0.03, 0.06)) halve η and restart from
the best point if (1) fewer than ρ=0.75 of the steps since the last
checkpoint improved the loss or (2) η and the best loss both stalled.

Deliberate divergences from the upstream ``autoattack`` library (each is a
documented choice, tested in tests/test_autoattack.py):

========================  =================================  ==================
aspect                    upstream (autopgd_base.py)         here
========================  =================================  ==================
random start (Linf)       ``x + eps·t/max|t|`` — scaled so   ``x + eps·U(-1,1)``
                          the largest coord touches ±eps,    clipped to
                          then [0,1]-clipped                 ball ∩ [0,1]:
                                                             uniform IN the
                                                             ball (one fewer
                                                             reduction; both
                                                             are valid "random
                                                             start" per paper)
checkpoint stall test     ``cp_f_best == f_best``            ``cp_f_best >=
(condition 2)                                                f_best`` (equal up
                                                             to float noise;
                                                             >= is monotone-
                                                             safe since f_best
                                                             never decreases)
batch shrinking           re-batches to still-robust         full static-shape
                          examples between restarts          batch, vectorized
                          (dynamic shapes)                   first-success
                                                             merge (XLA-
                                                             friendly; same
                                                             robust accuracy)
========================  =================================  ==================
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ...parallel import mesh as pmesh
from ..common import IMAGENET, Normalizer, frozen, linf_project, to_unit_floats


@dataclasses.dataclass(frozen=True)
class APGDConfig:
    eps: float = 8 / 255
    n_iter: int = 100
    n_restarts: int = 1
    alpha_momentum: float = 0.75
    rho: float = 0.75
    loss: str = "ce"  # 'ce' | 'dlr' | 'dlr-targeted'
    n_target_classes: int = 9  # for the targeted version


def checkpoint_iters(n_iter: int) -> list[int]:
    """Static checkpoint schedule w_j (paper §3.1), accumulated in integer
    space as upstream autopgd_base.py does: w_0=0, w_1=int(0.22n),
    w_{j+1} = w_j + max(w_j - w_{j-1} - int(0.03n), int(0.06n))."""
    size_decr = max(int(0.03 * n_iter), 1)
    min_gap = max(int(0.06 * n_iter), 1)
    ws = [0, max(int(0.22 * n_iter), 1)]
    while ws[-1] < n_iter:
        ws.append(ws[-1] + max(ws[-1] - ws[-2] - size_decr, min_gap))
    # unique, strictly increasing, within budget
    out = []
    for w in ws:
        if w > (out[-1] if out else -1) and w < n_iter:
            out.append(w)
    return out


def _schedule(n_iter: int) -> list[tuple[bool, int]]:
    """Per iteration: (is a checkpoint, steps since the previous checkpoint)."""
    checkpoints = set(checkpoint_iters(n_iter))
    out, last = [], 0
    for k in range(n_iter):
        if k in checkpoints and k > 0:
            out.append((True, k - last))
            last = k
        else:
            out.append((False, 1))
    return out


def random_start(generator: torch.Generator, images: torch.Tensor, eps: float,
                 mesh=None) -> torch.Tensor:
    """Uniform-in-ball random start (the divergence table above); under
    ``mesh``, this rank's rows of the draw over the global batch."""
    total, rows = pmesh.data_rows(mesh, images.shape[0])
    noise = torch.empty((total, *images.shape[1:]), device=images.device).uniform_(
        -1.0, 1.0, generator=generator)[rows]
    return linf_project(images + eps * noise, images, eps)


def take_class(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``logits[i, idx[i]]`` per row."""
    return logits.gather(-1, idx.long()[:, None])[:, 0]


def ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example CE of the true class (maximized by the attack)."""
    return -take_class(F.log_softmax(logits, dim=-1), labels)


def _sorted_desc(logits: torch.Tensor, ranks: int) -> list[torch.Tensor]:
    """The ``ranks`` largest logits per row, largest first; with fewer classes
    the last rank repeats (JAX clamps an index past the end to the last)."""
    z_sorted = torch.sort(logits, dim=-1, descending=True).values
    last = logits.shape[-1] - 1
    return [z_sorted[:, min(i, last)] for i in range(ranks)]


def dlr_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Untargeted DLR: -(z_y - max_{i!=y} z_i) / (z_p1 - z_p3)."""
    z1, z2, z3 = _sorted_desc(logits, 3)
    z_y = take_class(logits, labels)
    max_other = torch.where(z1 == z_y, z2, z1)
    denom = z1 - z3 + 1e-12
    return -(z_y - max_other) / denom


def dlr_targeted_loss(logits: torch.Tensor, labels: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Targeted DLR: -(z_y - z_t) / (z_p1 - (z_p3 + z_p4)/2)."""
    z1, _, z3, z4 = _sorted_desc(logits, 4)
    z_y = take_class(logits, labels)
    z_t = take_class(logits, targets)
    denom = z1 - (z3 + z4) / 2.0 + 1e-12
    return -(z_y - z_t) / denom


def target_order(logits: torch.Tensor) -> torch.Tensor:
    """Classes from most to least likely, ties in the JAX package's order: a
    stable ascending sort, flipped (the later index of a tie comes first)."""
    return torch.argsort(logits, dim=-1, stable=True).flip(-1)


def target_class(order: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """The (k+1)-th most likely class after the first, skipping the true class."""
    tgt = order[:, 1 + k]
    return torch.where(tgt == labels, order[:, 0], tgt)


def _expand(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape(-1, *([1] * (ndim - 1)))


def make_apgd(
    entry_apply: Callable,
    model_cfg,
    cfg: APGDConfig,
    *,
    normalize: Normalizer = IMAGENET,
) -> Callable:
    """``run(params, images, labels, generator=None, targets=None) -> (x_best, f_best)``.

    ``x_best`` is each example's best-loss point; callers check
    misclassification themselves (the AutoAttack runner keeps the first
    successful attack per example). The random start draws from
    ``generator`` (default: seed 0 on the images' device).
    ``run.from_start(params, images, labels, x_start, targets=None)`` starts
    from a given point instead."""
    apply_fn = partial(entry_apply, model_cfg)
    schedule = _schedule(cfg.n_iter)

    def loss_and_grad(x, params, labels, targets):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            logits = apply_fn(params, normalize(x)).float()
            if cfg.loss == "ce":
                per_ex = ce_loss(logits, labels)
            elif cfg.loss == "dlr":
                per_ex = dlr_loss(logits, labels)
            else:
                per_ex = dlr_targeted_loss(logits, labels, targets)
            (g,) = torch.autograd.grad(per_ex.sum(), x)
        return per_ex.detach(), g

    def run_from(params, images, labels, x, targets=None):
        images = to_unit_floats(images)
        tgt = targets if targets is not None else labels
        b, nd, eps = images.shape[0], images.ndim, cfg.eps
        with frozen(params), torch.no_grad():
            f0, g0 = loss_and_grad(x, params, labels, tgt)
            eta = torch.full((b,), 2.0 * eps, device=images.device)
            x1 = linf_project(x + _expand(eta, nd) * torch.sign(g0), images, eps)
            f1, g1 = loss_and_grad(x1, params, labels, tgt)

            better = f1 > f0
            f_best = torch.maximum(f0, f1)
            x_best = torch.where(_expand(better, nd), x1, x)
            g_best = torch.where(_expand(better, nd), g1, g0)
            improved = better.float()  # since the last checkpoint
            cp_eta, cp_f_best = eta, f_best  # values at the previous checkpoint
            x_cur, x_prev, grad, f = x1, x, g1, f1

            for is_cp, dist in schedule:
                if is_cp:  # maybe halve the step size and restart from the best point
                    cond1 = improved < cfg.rho * dist
                    cond2 = (cp_eta == eta) & (cp_f_best >= f_best)
                    halve = cond1 | cond2
                    eta = torch.where(halve, eta / 2.0, eta)
                    # restart from the best point with its gradient (as upstream)
                    x_cur = torch.where(_expand(halve, nd), x_best, x_cur)
                    grad = torch.where(_expand(halve, nd), g_best, grad)
                    improved = torch.zeros_like(improved)
                    cp_eta, cp_f_best = eta, f_best

                # momentum ascent step
                z = linf_project(x_cur + _expand(eta, nd) * torch.sign(grad), images, eps)
                a = cfg.alpha_momentum
                x_new = linf_project(x_cur + a * (z - x_cur) + (1 - a) * (x_cur - x_prev),
                                     images, eps)
                f_new, g_new = loss_and_grad(x_new, params, labels, tgt)

                gained = f_new > f
                new_best = _expand(f_new >= f_best, nd)
                f_best = torch.maximum(f_best, f_new)
                x_best = torch.where(new_best, x_new, x_best)
                g_best = torch.where(new_best, g_new, g_best)
                improved = improved + gained.float()
                x_prev, x_cur, grad, f = x_cur, x_new, g_new, f_new
        return x_best, f_best

    def run(params, images, labels, generator: Optional[torch.Generator] = None,
            targets=None):
        images = to_unit_floats(images)
        if generator is None:
            generator = torch.Generator(images.device).manual_seed(0)
        return run_from(params, images, labels,
                        random_start(generator, images, cfg.eps, pmesh.mesh_of(params)), targets)

    run.from_start = run_from
    return run


def make_apgd_targeted(
    entry_apply: Callable,
    model_cfg,
    cfg: APGDConfig,
    *,
    normalize: Normalizer = IMAGENET,
) -> Callable:
    """APGD-T: one APGD run per target class (2nd..k+1-th most likely),
    keeping the first target that flips each example.

    ``run(params, images, labels, generator=None) -> x_adv``: examples no
    target could flip keep their original pixels; each target's run starts
    from its own random start drawn from ``generator``.
    ``run.with_starts(params, images, labels, starts)`` takes
    ``starts(k) -> x_start`` for target ``k`` instead."""
    tcfg = dataclasses.replace(cfg, loss="dlr-targeted")
    single = make_apgd(entry_apply, model_cfg, tcfg, normalize=normalize)
    apply_fn = partial(entry_apply, model_cfg)

    def with_starts(params, images, labels, starts: Callable[[int], torch.Tensor]):
        images = to_unit_floats(images)
        nd = images.ndim
        with frozen(params), torch.no_grad():
            logits = apply_fn(params, normalize(images))
            order = target_order(logits)
            x_adv = images
            success = torch.zeros(images.shape[0], dtype=torch.bool, device=images.device)
            for k in range(min(tcfg.n_target_classes, logits.shape[-1] - 1)):
                tgt = target_class(order, labels, k)
                x_k, _ = single.from_start(params, images, labels, starts(k), targets=tgt)
                preds = apply_fn(params, normalize(x_k)).argmax(-1)
                flipped = (preds != labels) & ~success
                x_adv = torch.where(_expand(flipped, nd), x_k, x_adv)
                success = success | flipped
        return x_adv

    def run(params, images, labels, generator: Optional[torch.Generator] = None):
        images = to_unit_floats(images)
        if generator is None:
            generator = torch.Generator(images.device).manual_seed(0)
        return with_starts(params, images, labels, lambda k: random_start(
            generator, images, tcfg.eps, pmesh.mesh_of(params)))

    run.with_starts = with_starts
    return run
