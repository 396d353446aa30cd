"""Host-side deterministic preprocessing (decode path).

The split of work is deliberate: the host does only decode + resize/crop to a
*static* shape and ships uint8; everything stochastic or fusible (normalize,
augmentations, patch composites) happens on device inside the jitted step
(see ``attacks.common.Normalizer`` and the jitted steps in ``train.steps``).
That keeps H2D traffic at 1 byte/pixel and lets XLA
fuse normalization into the first matmul.

``eval_transform_pil`` matches the reference's torchvision eval pipeline
``Resize(256) -> CenterCrop(224)`` (train.py:137-142, bilinear on PIL
images) so accuracy parity holds.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def resize_shorter(img: Image.Image, size: int) -> Image.Image:
    # Long-side TRUNCATION, not rounding: torchvision computes
    # ``new_long = int(size * long / short)``
    # (_compute_resized_output_size, torchvision/transforms/functional.py) —
    # a rounded long side diverges by one pixel on e.g. 100x101 inputs and
    # shifts the center crop, which is where fractional-percent accuracy
    # parity quietly leaks (SURVEY.md §7 hard-part 4).
    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, int(h * size / w))
    else:
        new_w, new_h = max(1, int(w * size / h)), size
    return img.resize((new_w, new_h), Image.BILINEAR)


def center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def eval_transform_pil(img: Image.Image, *, resize: int = 256, crop: int = 224) -> np.ndarray:
    """PIL RGB image -> uint8 HWC array, torchvision-eval-pipeline parity.

    Applied unconditionally — the reference resamples even already-crop-sized
    images (its adversarial PNGs are 224px and still go through
    Resize(256)+CenterCrop(224), train_loras.py:187-191 /
    eval_compose.py:134-138 — the resampling partially smooths perturbations,
    and robust-accuracy parity requires reproducing that)."""
    img = img.convert("RGB")
    img = center_crop(resize_shorter(img, resize), crop)
    return np.asarray(img, np.uint8)
