"""Parameters made on the device from the seed, in a few large calls.

A family's ``layout`` gives each leaf's shape and kind; one draw of standard
normals from a ``torch.Generator`` on the device, seeded with the seed,
covers every leaf in layout order, and each leaf is its slice scaled by its
kind: ``dense`` weights (in, out) by in^-1/2, ``small`` leaves (biases,
embeddings, bias tables) by 0.02, ``scale`` leaves (LayerNorm gains) 1 plus
0.02 times their slice.
"""

from __future__ import annotations

import math

import torch

SMALL = 0.02


def make(layout: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """{path: tensor} in ``dtype`` on ``device``."""
    g = torch.Generator(device).manual_seed(seed)
    sizes = [math.prod(shape) for shape, _ in layout.values()]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, off = {}, 0
    for (path, (shape, kind)), n in zip(layout.items(), sizes):
        t = flat[off:off + n].view(shape)
        off += n
        if kind == "dense":
            t = t * shape[-2] ** -0.5
        elif kind == "small":
            t = t * SMALL
        elif kind == "scale":
            t = 1.0 + SMALL * t
        else:
            raise ValueError(f"{path}: kind {kind!r}")
        out[path] = t.to(dtype)
    return out
