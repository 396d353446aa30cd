"""Common-corruption generators (non-adversarial robustness data).

Counterpart of the JAX package's ``attacks/corruptions.py``: pixel-space
corruptions of [0,1] NHWC images, drawn from a ``torch.Generator`` on the
images' device (in place of a JAX key). The reference's sequential-LoRA study
trains a second adapter on Gaussian-noise-corrupted data (sigma 0.3).
"""

from __future__ import annotations

import torch


def gaussian_noise(images: torch.Tensor, generator: torch.Generator, *,
                   sigma: float = 0.3) -> torch.Tensor:
    """x + N(0, sigma^2), clipped to [0,1]."""
    noise = sigma * torch.randn(images.shape, dtype=images.dtype, device=images.device,
                                generator=generator)
    return torch.clamp(images + noise, 0.0, 1.0)


def salt_and_pepper(images: torch.Tensor, generator: torch.Generator, *,
                    amount: float = 0.05) -> torch.Tensor:
    """A fraction ``amount`` of pixels (all channels) set to 0 or 1."""
    shape = images.shape[:-1] + (1,)
    u = torch.rand(shape, device=images.device, generator=generator)
    salt = torch.rand(shape, device=images.device, generator=generator) > 0.5
    out = torch.where(u < amount, salt.to(images.dtype), images)
    return out.to(images.dtype)


def brightness(images: torch.Tensor, generator: torch.Generator, *,
               max_delta: float = 0.3) -> torch.Tensor:
    """One additive shift U(-max_delta, max_delta) per image, clipped to [0,1]."""
    d = torch.empty((images.shape[0], 1, 1, 1), device=images.device).uniform_(
        -max_delta, max_delta, generator=generator)
    return torch.clamp(images + d, 0.0, 1.0)


CORRUPTIONS = {
    "gaussian_noise": gaussian_noise,
    "salt_and_pepper": salt_and_pepper,
    "brightness": brightness,
}
