"""White-box gradient attacks: FGSM and PGD.

Counterpart of the JAX package's ``attacks/whitebox.py``, same semantics:

* FGSM: one signed-gradient step of size eps from the clean image, clamped
  to [0,1].
* PGD: optional uniform random start in the eps-ball, then ``steps``
  iterations of ``x += alpha * sign(grad)``, each projected onto the Linf
  ball around the clean image intersected with [0,1].

The gradient is taken with respect to the images only
(``torch.autograd.grad(loss, x)``) with every model parameter frozen for the
length of the attack, so no weight gradient is ever computed; the caller's
``requires_grad`` flags are restored when the attack returns or raises (the
JAX attacks are pure functions of ``params``). Frozen, not merely left out
of ``autograd.grad``: a kernel's ``autograd.Function`` decides at forward
time from ``requires_grad`` whether its backward recomputes the parameter
gradients. ``sign(0) = 0``. The random start draws
from a ``torch.Generator`` on the images' device; on a model built under a
mesh (``parallel.mesh``) it is the draw over the global batch, of which this
rank keeps its rows, so a sharded run is the single-process run. A caller
that holds the draw itself (another framework's, in a parity test) passes it
as ``noise`` instead.

While a profiler records, each stage opens its span
(``utils.observability.span``): PGD's random start (``attack.start``), each
iteration (``attack.step``), within it the model's forward and loss
(``attack.forward``, FGSM's too), the input gradient (``attack.backward``)
and the signed step with its projection (``attack.update``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from ..parallel import mesh as pmesh
from ..utils.observability import span
from .common import IMAGENET, Normalizer, frozen, linf_project, sum_cross_entropy, to_unit_floats


def _loss_grad(apply_fn: Callable, normalize: Normalizer):
    def grad(x: torch.Tensor, params, labels: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            with span("attack.forward"):
                loss = sum_cross_entropy(apply_fn(params, normalize(x)), labels)
            with span("attack.backward"):
                (g,) = torch.autograd.grad(loss, x)
        return g

    return grad


@torch.no_grad()
def fgsm(apply_fn: Callable, params, images: torch.Tensor, labels: torch.Tensor, *,
         eps: float, normalize: Normalizer = IMAGENET) -> torch.Tensor:
    """One signed-gradient ascent step; output in [0,1]."""
    g = _loss_grad(apply_fn, normalize)(images, params, labels)
    return torch.clamp(images + eps * torch.sign(g), 0.0, 1.0)


@torch.no_grad()
def pgd(apply_fn: Callable, params, images: torch.Tensor, labels: torch.Tensor, *,
        eps: float, alpha: float, steps: int, random_start: bool = True,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        normalize: Normalizer = IMAGENET) -> torch.Tensor:
    """Projected gradient descent over the whole step budget. ``noise``:
    the random start's U(-eps, eps) draw for these rows (the images' shape),
    in place of a draw from ``generator``."""
    grad_fn = _loss_grad(apply_fn, normalize)
    x = images
    if random_start:
        with span("attack.start"):
            if noise is None:
                if generator is None:
                    generator = torch.Generator(images.device).manual_seed(0)
                total, rows = pmesh.data_rows(pmesh.mesh_of(params), images.shape[0])
                noise = torch.empty((total, *images.shape[1:]), device=images.device).uniform_(
                    -eps, eps, generator=generator)[rows]
            x = linf_project(images + noise, images, eps)
    for _ in range(steps):
        with span("attack.step"):
            g = grad_fn(x, params, labels)
            with span("attack.update"):
                x = linf_project(x + alpha * torch.sign(g), images, eps)
    return x


def make_fgsm(entry_apply: Callable, cfg, *, eps: float,
              normalize: Normalizer = IMAGENET) -> Callable:
    """``(params, images, labels) -> adv`` FGSM; images uint8 or [0,1]."""
    apply_fn = partial(entry_apply, cfg)

    def run(params, images, labels):
        with frozen(params):
            return fgsm(apply_fn, params, to_unit_floats(images), labels, eps=eps,
                        normalize=normalize)

    return run


def make_pgd(entry_apply: Callable, cfg, *, eps: float, alpha: float, steps: int,
             random_start: bool = True, normalize: Normalizer = IMAGENET) -> Callable:
    """``(params, images, labels, generator, noise=None) -> adv`` PGD; images
    uint8 or [0,1]; ``noise``: the random start's draw (see :func:`pgd`)."""
    apply_fn = partial(entry_apply, cfg)

    def run(params, images, labels, generator=None, noise=None):
        with frozen(params):
            return pgd(apply_fn, params, to_unit_floats(images), labels, eps=eps,
                       alpha=alpha, steps=steps, random_start=random_start,
                       generator=generator, noise=noise, normalize=normalize)

    return run
