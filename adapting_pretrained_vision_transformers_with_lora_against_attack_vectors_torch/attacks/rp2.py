"""RP2 (Robust Physical Perturbations): per-class sign-constrained patches.

Counterpart of the JAX package's ``attacks/rp2.py``, same semantics: one
circular patch per class pinned at the sign center, physical-world EOT over
brightness U(0.8, 1.2) and scale U(0.4, 1.0) of the patch's own footprint,
no rotation, Adam lr 0.1, 500 iterations, untargeted, composited only inside
a centered disk that stands for the sign surface. It reuses
:mod:`.patch`'s trainer and composite; each class trains on its own samples,
repeated to the largest class's count (``np.resize``) as in JAX.
"""

from __future__ import annotations

import os
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..parallel import mesh as pmesh
from .common import IMAGENET, Normalizer, to_unit_floats
from .patch import PatchConfig, make_apply_patch, make_train_patch, patch_mask

_SEED_STRIDE = 100003  # classes per seed before two seeds' streams meet


def rp2_config(*, patch_size: int = 32, image_size: int = 224, iters: int = 500,
               learning_rate: float = 0.1, batch_size: int = 16) -> PatchConfig:
    """The reference's RP2 hyperparameters: ART's ``patch_scale=(P/224, P/224)``
    with ``scale_range=(0.4, 1.0)`` puts the footprint at U(0.4, 1.0)·P/S of
    the image side."""
    base = patch_size / image_size
    return PatchConfig(
        patch_size=patch_size,
        shape="circle",
        rotation_max_deg=0.0,
        scale_min=0.4 * base,
        scale_max=1.0 * base,
        brightness_range=(0.8, 1.2),
        learning_rate=learning_rate,
        iters=iters,
        batch_size=batch_size,
        targeted=False,
    )


def sign_mask(image_size: int, *, radius_frac: float = 0.45) -> torch.Tensor:
    """(H, W, 1) float32 disk on the CPU approximating the sign surface
    (the unified-dataset crops center the sign)."""
    ar = torch.arange(image_size, dtype=torch.float32)
    yy, xx = ar[:, None], ar[None, :]
    c = (image_size - 1) / 2.0
    r = radius_frac * image_size
    return (((xx - c) ** 2 + (yy - c) ** 2) < r ** 2).to(torch.float32)[..., None]


def make_sign_constrained_apply(cfg: PatchConfig, *, radius_frac: float = 0.45) -> Callable:
    """``run(images, patch, generator, scale) -> patched`` with the patch
    pinned at the center and the composite confined to the sign mask
    (``images·(1-mask) + patched·mask``). ``patch`` is (P, P, 3) or one per
    image (B, P, P, 3)."""
    apply_fn = make_apply_patch(cfg, fixed_location=(0.5, 0.5))

    @torch.no_grad()
    def run(images, patch, generator, scale):
        images = to_unit_floats(images)
        patched = apply_fn(images, patch, generator, scale)
        m = sign_mask(images.shape[1], radius_frac=radius_frac).to(images.device)
        return images * (1.0 - m) + patched * m

    return run


def train_rp2_patches(
    entry_apply: Callable,
    model_cfg,
    params,
    images: np.ndarray,
    labels: np.ndarray,
    *,
    device: torch.device | str,
    cfg: Optional[PatchConfig] = None,
    classes: Optional[list[int]] = None,
    min_samples: int = 2,
    normalize: Normalizer = IMAGENET,
    seed: int = 0,
    log: Callable[[str], None] = print,
) -> dict[int, np.ndarray]:
    """Train one patch per class on ``device`` (where ``params`` live; the
    caller must name it).

    ``images``/``labels``: the training subset ([0,1] NHWC floats / ints) on
    the host. Classes with fewer than ``min_samples`` samples get no patch;
    the others train on their samples repeated to the largest eligible
    class's count. Class ``c`` draws from a generator seeded with
    ``seed * 100003 + c``. Returns ``{class_index: (P, P, 3) patch}``. On a
    model built under a mesh every rank holds the whole class pool and trains
    on its share of each minibatch (``patch.make_train_patch``)."""
    device = torch.device(device)
    cfg = cfg or rp2_config(image_size=images.shape[1])
    train_fn = make_train_patch(entry_apply, model_cfg, cfg, normalize=normalize,
                                fixed_location=(0.5, 0.5))

    present = classes if classes is not None else sorted(set(int(l) for l in labels))
    counts = {c: int((labels == c).sum()) for c in present}
    eligible = [c for c in present if counts[c] >= min_samples]
    if not eligible:
        return {}
    pad_to = max(counts[c] for c in eligible)

    # every rank holds the whole class pool: under a mesh it is not gathered again
    train = train_fn if pmesh.mesh_of(params) is None else train_fn.from_pool
    patches: dict[int, np.ndarray] = {}
    for c in eligible:
        take = np.resize(np.nonzero(labels == c)[0], pad_to)  # repeat to one count
        cls_images = torch.from_numpy(np.ascontiguousarray(images[take])).to(device)
        cls_labels = torch.from_numpy(np.asarray(labels[take], np.int64)).to(device)
        gen = torch.Generator(device).manual_seed(seed * _SEED_STRIDE + c)
        patch, losses = train(params, cls_images, cls_labels, gen)
        patches[c] = patch.cpu().numpy()
        log(f"rp2 class {c}: {counts[c]} samples, final loss {float(losses[-1]):.4f}")
    return patches


def save_class_patches(patches: Mapping[int, np.ndarray], out_dir: str,
                       *, cfg: Optional[PatchConfig] = None,
                       class_names: Optional[Mapping[int, str]] = None) -> None:
    """Per-class patch PNGs ``rp2_patch_<class>.png`` (the native encoder),
    with the circular mask applied so the file is the physical sticker."""
    from ..utils import native

    os.makedirs(out_dir, exist_ok=True)
    for c, patch in patches.items():
        img = patch
        if cfg is not None:
            img = patch * patch_mask(cfg).numpy()[..., None]
        name = (class_names or {}).get(c, f"class_{c}")
        arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        with open(os.path.join(out_dir, f"rp2_patch_{name}.png"), "wb") as f:
            f.write(native.encode_png_rgb(arr))
