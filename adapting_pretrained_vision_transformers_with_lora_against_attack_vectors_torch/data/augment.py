"""Train-time augmentation on the device, one resample per batch.

Counterpart of the JAX package's ``data/augment.py``: the reference's
torchvision pipeline (``RandomRotation(15) -> RandomResizedCrop ->
RandomHorizontalFlip -> ColorJitter(0.2, 0.2, 0.2)``) with the three
geometric ops composed into a **single inverse affine** per image and applied
with one bilinear resample, zero fill outside the source.

The resample is ``F.grid_sample(mode="bilinear", padding_mode="zeros",
align_corners=True)`` on the grid ``2 * src / (S - 1) - 1``: with
``align_corners=True`` the normalised coordinate -1 is the centre of pixel 0
and +1 the centre of pixel S-1, so ``src`` is a pixel index, as in the JAX
warp, whose soft one-hot weights ``relu(1 - |src - index|)`` are exactly
bilinear interpolation with zero fill (the edge decay included). The JAX
warp's shape (separable contractions, row bands) is for the TPU's matrix
unit; a gather costs nothing special on a GPU.

Color jitter multiplies brightness and interpolates contrast / saturation
around the per-image mean / luma in that fixed order; factors U(1-v, 1+v).
Draws come from an explicit ``torch.Generator`` on the images' device; its
streams are not those of ``jax.random``. Under a data axis (``rows``) each
draw is the draw over the global batch, of which this rank keeps its rows.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    rotation_deg: float = 15.0
    crop_scale: tuple[float, float] = (0.08, 1.0)   # RandomResizedCrop default
    crop_ratio: tuple[float, float] = (3 / 4, 4 / 3)
    hflip_p: float = 0.5
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2


DEFAULT = AugmentConfig()


def _uniform(generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)


def _sample_affine(generator: torch.Generator, n: int, size: int, cfg: AugmentConfig, device,
                   rows: slice = slice(None)):
    """Per-image inverse-affine params: 2x2 matrix + translation (pixels),
    drawn for ``n`` images, of which ``rows`` are kept."""
    theta = torch.deg2rad(_uniform(generator, (n,), -cfg.rotation_deg, cfg.rotation_deg, device))
    # RandomResizedCrop: area fraction + log-uniform aspect ratio
    area = _uniform(generator, (n,), cfg.crop_scale[0], cfg.crop_scale[1], device)
    ratio = torch.exp(_uniform(generator, (n,), math.log(cfg.crop_ratio[0]),
                               math.log(cfg.crop_ratio[1]), device))
    crop_w = torch.sqrt(area * ratio).mul(size).clamp_max(size)
    crop_h = torch.sqrt(area / ratio).mul(size).clamp_max(size)
    uv = torch.rand((2, n), generator=generator, device=device)  # top-left corner within bounds
    x0 = uv[0] * (size - crop_w)
    y0 = uv[1] * (size - crop_h)
    flip = torch.rand((n,), generator=generator, device=device) < cfg.hflip_p
    return _compose_affine(*(t[rows] for t in (theta, crop_w, crop_h, x0, y0, flip)), size)


def _compose_affine(theta, crop_w, crop_h, x0, y0, flip, size: int):
    """Inverse mapping out -> in: ``src = A @ [ox, oy] + t``. Output pixel
    (ox, oy) goes to crop coordinates (flip mirrors ox first), then is rotated
    about the image centre."""
    sx, sy = crop_w / size, crop_h / size
    sign = torch.where(flip, -1.0, 1.0)
    cos, sin = torch.cos(theta), torch.sin(theta)
    c = (size - 1) / 2.0
    a00, a01 = cos * sx * sign, -sin * sy
    a10, a11 = sin * sx * sign, cos * sy
    # crop offset relative to the centre, with the flip folded into the ox term
    ox_off = x0 + torch.where(flip, crop_w - sx, torch.zeros_like(sx)) - c
    oy_off = y0 - c
    t_x = cos * ox_off - sin * oy_off + c
    t_y = sin * ox_off + cos * oy_off + c
    return a00, a01, a10, a11, t_x, t_y


def warp(images: torch.Tensor, affine) -> torch.Tensor:
    """Inverse-affine bilinear warp of (B, S, S, 3) images, zero fill; each of
    the six ``affine`` entries is (B,)."""
    a00, a01, a10, a11, t_x, t_y = (a.reshape(-1, 1, 1).to(torch.float32) for a in affine)
    s = images.shape[1]
    idx = torch.arange(s, dtype=torch.float32, device=images.device)
    oy, ox = torch.meshgrid(idx, idx, indexing="ij")
    src_x = a00 * ox + a01 * oy + t_x  # (B, S, S)
    src_y = a10 * ox + a11 * oy + t_y
    grid = torch.stack([src_x, src_y], dim=-1) * (2.0 / (s - 1)) - 1.0
    out = F.grid_sample(images.permute(0, 3, 1, 2).float(), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)


def _color_jitter(images: torch.Tensor, generator: torch.Generator,
                  cfg: AugmentConfig, total: int = None, rows: slice = slice(None)) -> torch.Tensor:
    n = images.shape[0]
    total = total or n

    def factor(v: float) -> torch.Tensor:
        return _uniform(generator, (total, 1, 1, 1), max(0.0, 1 - v), 1 + v, images.device)[rows]

    def luma(x: torch.Tensor) -> torch.Tensor:
        return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]

    x = images
    if cfg.brightness > 0:
        x = x * factor(cfg.brightness)
    if cfg.contrast > 0:
        # torchvision: blend with the mean of the grayscale image
        mean = luma(x).mean(dim=(1, 2)).reshape(n, 1, 1, 1)
        x = mean + (x - mean) * factor(cfg.contrast)
    if cfg.saturation > 0:
        gray = luma(x)[..., None]
        x = gray + (x - gray) * factor(cfg.saturation)
    return x.clamp(0.0, 1.0)


def train_augment(images: torch.Tensor, generator: torch.Generator,
                  cfg: AugmentConfig = DEFAULT, *, rows: tuple = None) -> torch.Tensor:
    """(B, S, S, 3) [0,1] floats -> augmented batch, fresh draws per call.
    ``rows``: ``(global batch, this rank's slice)`` (``parallel.mesh.data_rows``)."""
    n, size = images.shape[0], images.shape[1]
    total, sl = rows if rows is not None else (n, slice(None))
    affine = _sample_affine(generator, total, size, cfg, images.device, sl)
    return _color_jitter(warp(images, affine), generator, cfg, total, sl)
