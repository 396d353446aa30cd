"""A frozen copy of the training augmentation's arithmetic, so that the
reference redraws the program's augmentation from the seed the benchmark
hands both sides.

The reference's torchvision pipeline (``RandomRotation(15) ->
RandomResizedCrop -> RandomHorizontalFlip -> ColorJitter(0.2, 0.2, 0.2)``)
as one inverse affine a image, applied by one bilinear resample with zero
fill, then brightness, contrast and saturation factors U(1-v, 1+v) in that
order. The draws, their order and shapes, and every operation are those of
the program's ``data/augment.train_augment`` when this benchmark was
written: a later change to the program's augmentation that changes its
result shows as a failed comparison here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ROTATION_DEG = 15.0
CROP_SCALE = (0.08, 1.0)
CROP_RATIO = (3 / 4, 4 / 3)
HFLIP_P = 0.5
JITTER = 0.2  # brightness, contrast and saturation


def _uniform(g, shape, lo: float, hi: float, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def _affine(g, n: int, size: int, device):
    theta = torch.deg2rad(_uniform(g, (n,), -ROTATION_DEG, ROTATION_DEG, device))
    area = _uniform(g, (n,), CROP_SCALE[0], CROP_SCALE[1], device)
    ratio = torch.exp(_uniform(g, (n,), math.log(CROP_RATIO[0]), math.log(CROP_RATIO[1]), device))
    crop_w = torch.sqrt(area * ratio).mul(size).clamp_max(size)
    crop_h = torch.sqrt(area / ratio).mul(size).clamp_max(size)
    uv = torch.rand((2, n), generator=g, device=device)
    x0, y0 = uv[0] * (size - crop_w), uv[1] * (size - crop_h)
    flip = torch.rand((n,), generator=g, device=device) < HFLIP_P
    sx, sy = crop_w / size, crop_h / size
    sign = torch.where(flip, -1.0, 1.0)
    cos, sin = torch.cos(theta), torch.sin(theta)
    c = (size - 1) / 2.0
    ox = x0 + torch.where(flip, crop_w - sx, torch.zeros_like(sx)) - c
    oy = y0 - c
    return (cos * sx * sign, -sin * sy, sin * sx * sign, cos * sy,
            cos * ox - sin * oy + c, sin * ox + cos * oy + c)


def _warp(images: torch.Tensor, affine) -> torch.Tensor:
    a00, a01, a10, a11, tx, ty = (a.reshape(-1, 1, 1).to(torch.float32) for a in affine)
    s = images.shape[1]
    idx = torch.arange(s, dtype=torch.float32, device=images.device)
    oy, ox = torch.meshgrid(idx, idx, indexing="ij")
    grid = torch.stack([a00 * ox + a01 * oy + tx, a10 * ox + a11 * oy + ty], dim=-1)
    out = F.grid_sample(images.permute(0, 3, 1, 2).float(), grid * (2.0 / (s - 1)) - 1.0,
                        mode="bilinear", padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)


def skip(g: torch.Generator, n: int, device, steps: int) -> None:
    """Advance ``g`` by the draws of ``steps`` calls on batches of ``n``."""
    for _ in range(steps):
        for shape in [(n,)] * 3 + [(2, n), (n,)] + [(n, 1, 1, 1)] * 3:
            torch.rand(shape, generator=g, device=device)


def train_augment(images: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """(B, S, S, 3) [0, 1] -> the augmented batch, drawing from ``g``."""
    n, size, dev = images.shape[0], images.shape[1], images.device
    x = _warp(images, _affine(g, n, size, dev))

    def factor() -> torch.Tensor:
        return _uniform(g, (n, 1, 1, 1), 1 - JITTER, 1 + JITTER, dev)

    def luma(t: torch.Tensor) -> torch.Tensor:
        return 0.299 * t[..., 0] + 0.587 * t[..., 1] + 0.114 * t[..., 2]

    x = x * factor()
    mean = luma(x).mean(dim=(1, 2)).reshape(n, 1, 1, 1)
    x = mean + (x - mean) * factor()
    gray = luma(x)[..., None]
    x = gray + (x - gray) * factor()
    return x.clamp(0.0, 1.0)
