"""EOT adversarial patch attack.

Counterpart of the JAX package's ``attacks/patch.py``, same semantics: a
circle or square patch trained with Adam (lr 5.0, 500 iterations, minibatch
16 drawn with replacement) under expectation over transformation (scale
U(0.05, 1.0), rotation up to 22.5 degrees, in-bounds translation,
brightness), untargeted by default, then applied at a runtime scale.

* The patch composite is the JAX one: a bilinear resample with
  ``mode='constant', cval=0`` semantics written as two batched products with
  soft one-hot weights ``relu(1 - |v - p|)`` (:func:`composite_batch`), in
  f32. Its backward into the patch is a plain matrix product: deterministic,
  no atomics (``F.grid_sample``'s CUDA backward accumulates with atomics).
  Pixels outside the warped footprint keep the image's values bit for bit.
* The patch is (P, P, 3), shared by the batch, or (B, P, P, 3), one per
  example (RP2 applies each example's class patch).
* Gradients flow into the patch only: the model's parameters are frozen
  while the attack runs and their ``requires_grad`` flags restored after.
* The shape mask is a runtime argument, so circle and square share one
  trainer.
* Random draws (minibatch indices, EOT parameters) come from a
  ``torch.Generator`` on the images' device; ``run.with_draws`` takes every
  iteration's draws explicitly instead, so that a test can feed it the JAX
  package's own. The loss history stays on the device until the caller
  reads it: no host sync inside the loop.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Iterable, Optional

import torch
import torch.nn.functional as F

from ..parallel import mesh as pmesh
from .common import IMAGENET, Normalizer, frozen, to_unit_floats

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


@dataclasses.dataclass(frozen=True)
class PatchConfig:
    """Static patch-attack hyperparameters (the JAX package's, same defaults)."""

    patch_size: int = 24
    shape: str = "circle"  # 'circle' | 'square'
    rotation_max_deg: float = 22.5
    scale_min: float = 0.05
    scale_max: float = 1.0
    brightness_range: tuple[float, float] = (1.0, 1.0)  # RP2: (0.8, 1.2)
    learning_rate: float = 5.0
    iters: int = 500
    batch_size: int = 16
    targeted: bool = False
    target_class: int = 0


def patch_mask(cfg: PatchConfig) -> torch.Tensor:
    """(P, P) float32 mask on the CPU: inscribed disk for 'circle', ones for 'square'."""
    p = cfg.patch_size
    if cfg.shape == "square":
        return torch.ones((p, p), dtype=torch.float32)
    ar = torch.arange(p, dtype=torch.float32)
    yy, xx = ar[:, None], ar[None, :]
    c = (p - 1) / 2.0
    r = p / 2.0
    return ((xx - c) ** 2 + (yy - c) ** 2 < r ** 2).to(torch.float32)


def init_patch(cfg: PatchConfig, device=None) -> torch.Tensor:
    """Mid-gray start (ART's default initialisation is the clip midpoint)."""
    return torch.full((cfg.patch_size, cfg.patch_size, 3), 0.5, dtype=torch.float32,
                      device=device)


def composite_batch(images: torch.Tensor, patch: torch.Tensor, mask: torch.Tensor,
                    eot: tuple) -> torch.Tensor:
    """Overlay ``patch`` on each image under its EOT sample.

    ``images`` (B, S, S, 3) in [0,1]; ``patch`` (P, P, 3) or (B, P, P, 3);
    ``mask`` (P, P); ``eot`` = (scale, theta, tx, ty, brightness), each (B,):
    ``scale`` is the footprint as a fraction of the image side, the patch
    center lands at image center + (tx, ty) pixels, ``theta`` rotates it and
    ``brightness`` multiplies its pixels. Out-of-footprint pixels keep the
    image."""
    scale, theta, tx, ty, bright = (t.reshape(-1, 1, 1) for t in eot)
    n, s = images.shape[0], images.shape[1]
    p = patch.shape[-2]
    dev = images.device
    ar = torch.arange(s, dtype=torch.float32, device=dev)
    yy, xx = ar[:, None], ar[None, :]
    c = (s - 1) / 2.0
    # image-plane offsets from the (translated) patch center, inverse-rotated
    # and un-scaled into patch coordinates
    dx = xx - c - tx
    dy = yy - c - ty
    cos, sin = torch.cos(-theta), torch.sin(-theta)
    k = scale * s / p  # image pixels per patch pixel
    u = (cos * dx - sin * dy) / k + (p - 1) / 2.0
    v = (sin * dx + cos * dy) / k + (p - 1) / 2.0

    # sample[y, x] = sum_pq A[yx, p] B[yx, q] planes[p, q]: rows whose
    # coordinate falls outside the patch decay to zero weight
    idx = torch.arange(p, dtype=torch.float32, device=dev)
    wv = torch.relu(1.0 - (v.reshape(n, s * s, 1) - idx).abs())  # (B, S*S, P)
    wu = torch.relu(1.0 - (u.reshape(n, s * s, 1) - idx).abs())  # (B, S*S, Q)
    planes = torch.cat([patch, mask.to(patch.dtype).expand(patch.shape[:-1])[..., None]], -1)
    # (Q, P*4), or (B, Q, P*4) for a patch per example
    planes_q = planes.transpose(-3, -2).reshape(*planes.shape[:-3], p, p * 4)
    t = torch.matmul(wu, planes_q).reshape(n, s * s, p, 4)  # sum over q
    samp = torch.matmul(wv.unsqueeze(-2), t).squeeze(-2)  # sum over p: (B, S*S, 4)
    patch_rgb = samp[..., :3].reshape(n, s, s, 3)
    m = samp[..., 3:].reshape(n, s, s, 1)
    # the clip as min(max(., 0), 1), as JAX writes it: a value exactly at a
    # bound (a saturated patch at brightness 1 gives many) passes half its
    # gradient, where ``torch.clamp`` would pass all of it
    zero = torch.zeros((), device=dev)
    patched = torch.minimum(torch.maximum(patch_rgb * bright[..., None], zero), zero + 1.0)
    return images * (1.0 - m) + patched * m


def _uniform(generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        lo, hi, generator=generator)


def _translation(generator, scale: torch.Tensor, image_size: int, device):
    """Per-sample (tx, ty) keeping the rotation-safe (sqrt(2)-inflated)
    footprint inside the image."""
    half_extent = scale * image_size * math.sqrt(2.0) / 2.0
    max_shift = torch.clamp(image_size / 2.0 - half_extent, min=0.0)
    txy = _uniform(generator, (2, scale.shape[0]), -1.0, 1.0, device) * max_shift
    return txy[0], txy[1]


def sample_eot(generator: torch.Generator, n: int, cfg: PatchConfig, image_size: int,
               device) -> tuple:
    """Training EOT parameters per sample: scale, rotation, in-bounds
    translation, brightness (drawn in that order)."""
    scale = _uniform(generator, (n,), cfg.scale_min, cfg.scale_max, device)
    rot = math.radians(cfg.rotation_max_deg)
    theta = _uniform(generator, (n,), -rot, rot, device)
    tx, ty = _translation(generator, scale, image_size, device)
    bright = _uniform(generator, (n,), *cfg.brightness_range, device)
    return scale, theta, tx, ty, bright


def apply_eot(generator: torch.Generator, n: int, cfg: PatchConfig, image_size: int,
              scale, device, *, fixed_location: Optional[tuple[float, float]] = None) -> tuple:
    """Application EOT parameters: ``scale`` (a float or 0-d tensor) for
    every image, random rotation, translation (or ``fixed_location``) and
    brightness per image."""
    scale_b = torch.as_tensor(scale, dtype=torch.float32, device=device).expand(n)
    rot = math.radians(cfg.rotation_max_deg)
    theta = _uniform(generator, (n,), -rot, rot, device)
    tx, ty = _translation(generator, scale_b, image_size, device)
    if fixed_location is not None:
        tx, ty = _pinned(fixed_location, tx, ty, image_size)
    bright = _uniform(generator, (n,), *cfg.brightness_range, device)
    return scale_b, theta, tx, ty, bright


def _pinned(fixed_location, tx, ty, image_size: int):
    """(tx, ty) of a patch centered at ``fixed_location`` ((x, y) in [0,1])."""
    fx, fy = fixed_location
    return (torch.full_like(tx, (fx - 0.5) * image_size),
            torch.full_like(ty, (fy - 0.5) * image_size))


def _adam_step(patch, grad, m, v, t: int, lr: float):
    """One ``optax.adam(lr)`` update, then the [0,1] clip on the patch (the
    moments are not clipped)."""
    m = (1 - ADAM_B1) * grad + ADAM_B1 * m
    v = (1 - ADAM_B2) * grad * grad + ADAM_B2 * v
    m_hat = m / (1 - ADAM_B1 ** t)
    v_hat = v / (1 - ADAM_B2 ** t)
    update = -lr * (m_hat / (torch.sqrt(v_hat) + ADAM_EPS))
    return torch.clamp(patch + update, 0.0, 1.0), m, v


def make_train_patch(
    entry_apply: Callable,
    model_cfg,
    cfg: PatchConfig,
    *,
    normalize: Normalizer = IMAGENET,
    fixed_location: Optional[tuple[float, float]] = None,
) -> Callable:
    """``run(params, images, labels, generator=None, mask=None) -> (patch, losses)``.

    ``images``: the training subset on the model's device ([0,1] floats or
    uint8), ``labels`` its int labels. Each of ``cfg.iters`` iterations draws
    a minibatch (with replacement) and fresh EOT samples from ``generator``
    (default: seed 0 on the images' device) and takes one Adam step on the
    patch; ``losses`` (iters,) is each step's loss (-CE untargeted, CE
    targeted). ``fixed_location``: the patch center pinned at (x, y) in
    [0,1] image coordinates (RP2 pins it at the sign center). ``mask``: the
    (P, P) shape mask (default ``patch_mask(cfg)``).

    ``run.with_draws(params, images, labels, draws, mask=None)`` takes the
    iterations' draws instead: an iterable of (minibatch indices, EOT
    tuple) pairs, one per iteration. ``run.from_pool(params, images, labels,
    generator=None, mask=None)`` is ``run`` on a pool that every rank
    already holds whole (RP2's class pools).

    On a model built under a mesh (``parallel.mesh``), ``images`` and
    ``labels`` are this rank's rows: the pool is gathered over the data
    axis, every rank draws the same global minibatch and EOT samples and
    takes its share of the minibatch's rows, and the patch gradient, a mean
    over the global minibatch, is summed over ``"data"`` before the Adam
    step, so every rank takes the single-process step. A minibatch the data
    axis does not divide raises."""
    apply_fn = partial(entry_apply, model_cfg)
    default_mask = patch_mask(cfg)

    def train(params, images, labels, draws: Iterable, mask):
        mesh = pmesh.mesh_of(params)
        d, r = pmesh.axis_size(mesh, pmesh.DATA_AXIS), pmesh.axis_rank(mesh, pmesh.DATA_AXIS)
        dev = images.device
        size = images.shape[1]
        mask = (default_mask if mask is None else mask).to(dev, torch.float32)
        patch = init_patch(cfg, dev)
        m, v = torch.zeros_like(patch), torch.zeros_like(patch)
        losses = []
        with frozen(params), torch.no_grad():
            for t, (idx, eot) in enumerate(draws, start=1):
                k = idx.shape[0]
                if k % d:
                    raise ValueError(f"a patch minibatch of {k} does not divide over the data "
                                     f"axis of size {d}")
                mine = slice(r * k // d, (r + 1) * k // d)
                idx, eot = idx[mine], tuple(e[mine] for e in eot)
                mb_images, mb_labels = images[idx], labels[idx].long()
                if cfg.targeted:
                    mb_labels = torch.full_like(mb_labels, cfg.target_class)
                if fixed_location is not None:
                    tx, ty = _pinned(fixed_location, eot[2], eot[3], size)
                    eot = (eot[0], eot[1], tx, ty, eot[4])
                with torch.enable_grad():
                    x = patch.requires_grad_(True)
                    logits = apply_fn(params, normalize(composite_batch(mb_images, x, mask, eot)))
                    ce = (F.cross_entropy(logits.float(), mb_labels) if d == 1 else
                          F.cross_entropy(logits.float(), mb_labels, reduction="sum") / k)
                    loss = ce if cfg.targeted else -ce
                    (g,) = torch.autograd.grad(loss, x)
                loss = loss.detach()
                if d > 1:  # one all-reduce carries the gradient and the loss
                    both = pmesh.all_reduce(torch.cat([g.reshape(-1), loss.reshape(1)]), mesh,
                                            pmesh.DATA_AXIS)
                    g, loss = both[:-1].view_as(g), both[-1]
                patch, m, v = _adam_step(patch.detach(), g, m, v, t, cfg.learning_rate)
                losses.append(loss)
        return patch, torch.stack(losses)

    def pool(params, images, labels):
        return pmesh.gather_rows(pmesh.mesh_of(params), to_unit_floats(images), labels)

    def run_with_draws(params, images, labels, draws: Iterable, mask=None):
        return train(params, *pool(params, images, labels), draws, mask)

    def from_pool(params, images, labels, generator: Optional[torch.Generator] = None,
                  mask=None):
        images = to_unit_floats(images)
        dev, n, size = images.device, images.shape[0], images.shape[1]
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)

        def draws():
            for _ in range(cfg.iters):
                idx = torch.randint(0, n, (cfg.batch_size,), generator=generator, device=dev)
                yield idx, sample_eot(generator, cfg.batch_size, cfg, size, dev)

        return train(params, images, labels, draws(), mask)

    def run(params, images, labels, generator: Optional[torch.Generator] = None, mask=None):
        return from_pool(params, *pool(params, images, labels), generator, mask)

    run.with_draws = run_with_draws
    run.from_pool = from_pool
    return run


def make_apply_patch(cfg: PatchConfig, *,
                     fixed_location: Optional[tuple[float, float]] = None) -> Callable:
    """``run(images, patch, generator, scale, mask=None) -> patched``.

    ``scale`` (a float or 0-d tensor) is a runtime value, so a per-batch
    ``U(scale_min_apply, scale_max_apply)`` draw needs no new callable;
    rotation, translation (or ``fixed_location``) and brightness are drawn
    per image from ``generator`` (:func:`apply_eot`). ``patch`` is (P, P, 3)
    or one per image (B, P, P, 3); ``mask`` defaults to ``patch_mask(cfg)``."""
    default_mask = patch_mask(cfg)

    @torch.no_grad()
    def run(images, patch, generator, scale, mask=None):
        images = to_unit_floats(images)
        eot = apply_eot(generator, images.shape[0], cfg, images.shape[1], scale, images.device,
                        fixed_location=fixed_location)
        mask = (default_mask if mask is None else mask).to(images.device, torch.float32)
        return composite_batch(images, patch.to(images.device, torch.float32), mask, eot)

    return run
